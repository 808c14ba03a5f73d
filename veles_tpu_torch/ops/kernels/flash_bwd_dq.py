"""Flash-attention backward, dQ: the hand-written CUDA kernels and their
plain PyTorch version.

Two variants, chosen by dtype alone (``kernel_variant``): bfloat16 runs
on the tensor cores (``csrc/flash_bwd_dq_tc.cu``, wgmma), float32 on the
SIMT cores (``csrc/flash_bwd_dq.cu``); ``launches.by_variant()`` counts
each.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``_flash_bwd``'s dQ
pallas_call (:384, body ``_flash_bwd_dq_kernel`` :269-309).  The
``autograd.Function`` in :mod:`.flash_attention` calls
:func:`flash_bwd_dq` from its backward: a tensor on a Hopper card
launches the kernel, a CPU tensor takes :func:`flash_bwd_dq_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .. import check_attention_window, kernel_route
from . import build
from .flash_bwd_common import (_attention_cost, check_bwd_shapes,
                               check_kernel_args, kernel_variant,
                               key_blocks)

NAME = "flash_bwd_dq"
#: the source of each variant; SOURCE is the bf16 main path's
SOURCES = {"tc": "veles_tpu_torch/csrc/flash_bwd_dq_tc.cu",
           "simt": "veles_tpu_torch/csrc/flash_bwd_dq.cu"}
SOURCE = SOURCES["tc"]
REPLACES = "veles_tpu/ops/pallas_kernels.py:384"

#: launches of the CUDA kernels, by variant (never of the plain version)
launches = build.LaunchCounter()


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool, scale: float,
                 window=None, block_k: int = 512):
    """dQ of blockwise attention by recompute: q/dout (B, Tq, H, D), k/v
    (B, Tk, H_kv, D), lse (B, H, Tq) the forward's row logsumexp, delta
    (B, H, Tq) = rowsum(dout * out) in float32.  Returns dq like q.
    ``block_k`` is the key block of the plain version's loop."""
    window = check_attention_window(window, causal)
    check_bwd_shapes(NAME, q, k, v, dout, lse, delta)
    with build.reporting(NAME, lambda: cost(q, k, v, causal, window)):
        if kernel_route(q, NAME):
            check_kernel_args(NAME, q, k, v, dout, lse, delta)
            return _launch(q, k, v, dout, lse, delta, causal, float(scale),
                           window)
        return flash_bwd_dq_plain(q, k, v, dout, lse, delta, causal=causal,
                                  scale=scale, window=window,
                                  block_k=block_k)


def cost(q, k, v, causal: bool, window=None):
    """``{"flops", "bytes"}`` of one dQ launch: 6·B·H·D a scored pair
    (the QK^T and dO·V^T recomputes and dS·K); q, dout, k, v read and dq
    written once, lse and delta read once."""
    return _attention_cost(q, k, causal, window, 6, 3, 2, 2)


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, *, causal: bool,
                       scale: float, window=None, block_k: int = 512):
    """The plain version: dQ = sum over key blocks of dS (cast to k's
    dtype, :297) times K, accumulated in float32, written in q's dtype."""
    window = check_attention_window(window, causal)
    dq = torch.zeros(q.transpose(1, 2).shape, dtype=torch.float32,
                     device=q.device)
    for _, _, kb, _, _, ds in key_blocks(q, k, v, dout, lse, delta,
                                         causal=causal, scale=scale,
                                         window=window, block_k=block_k):
        dq += torch.matmul(ds.to(k.dtype).float(), kb.float())
    return dq.to(q.dtype).transpose(1, 2).contiguous()


def _fn(variant):
    lib = build.load("flash_bwd_dq_tc" if variant == "tc" else "flash_bwd_dq")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.vt_flash_bwd_dq_tc if variant == "tc" else lib.vt_flash_bwd_dq
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k, v, dout, lse, delta, causal, scale, window):
    """Launch the variant ``q``'s dtype picks."""
    variant = kernel_variant(NAME, (q, k, v, dout))
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    lib, fn = _fn(variant)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Tq, Tk, H,
            Hk, D, scale, int(causal), int(window or 0), stream)
    build.check(lib, rc, NAME)
    launches.inc(variant)
    return dq
