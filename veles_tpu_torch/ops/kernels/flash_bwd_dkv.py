"""Flash-attention backward, dK and dV: the hand-written CUDA kernels and
their plain PyTorch version.

Two variants, chosen by dtype alone (``kernel_variant``), both on the
tensor cores: bfloat16 in ``csrc/flash_bwd_dkv_tc.cu`` (wgmma, ``"tc"``),
float32 in ``csrc/flash_bwd_dkv_tf32x3.cu`` (mma.sync with a 3xTF32 split,
``"tf32x3"``); ``launches.by_variant()`` counts each.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``_flash_bwd``'s dK/dV
pallas_call (:411, body ``_flash_bwd_dkv_kernel`` :312-357).  The
``autograd.Function`` in :mod:`.flash_attention` calls
:func:`flash_bwd_dkv` from its backward: a tensor on a Hopper card
launches the kernel, a CPU tensor takes :func:`flash_bwd_dkv_plain`.
With grouped-query attention the G = H / H_kv query heads of a group fold
into one kv-head gradient, inside the kernel, in a fixed order.
"""

from __future__ import annotations

import ctypes

import torch

from .. import check_attention_window, check_gqa_heads, kernel_route
from . import build
from .flash_bwd_common import (_attention_cost, check_bwd_shapes,
                               check_kernel_args, kernel_variant,
                               key_blocks)

NAME = "flash_bwd_dkv"
#: the source of each variant; SOURCE is the bf16 main path's
SOURCES = {"tc": "veles_tpu_torch/csrc/flash_bwd_dkv_tc.cu",
           "tf32x3": "veles_tpu_torch/csrc/flash_bwd_dkv_tf32x3.cu"}
SOURCE = SOURCES["tc"]
REPLACES = "veles_tpu/ops/pallas_kernels.py:411"

#: launches of the CUDA kernels, by variant (never of the plain version)
launches = build.LaunchCounter()


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool, scale: float,
                  window=None, block_k: int = 512):
    """dK and dV of blockwise attention by recompute (shapes as
    :func:`.flash_bwd_dq.flash_bwd_dq`).  Returns ``(dk, dv)`` like k and
    v.  ``block_k`` is the key block of the plain version's loop."""
    window = check_attention_window(window, causal)
    check_bwd_shapes(NAME, q, k, v, dout, lse, delta)
    with build.reporting(NAME, lambda: cost(q, k, v, causal, window)):
        if kernel_route(q, NAME):
            check_kernel_args(NAME, q, k, v, dout, lse, delta)
            return _launch(q, k, v, dout, lse, delta, causal, float(scale),
                           window)
        return flash_bwd_dkv_plain(q, k, v, dout, lse, delta,
                                   causal=causal, scale=scale,
                                   window=window, block_k=block_k)


def cost(q, k, v, causal: bool, window=None):
    """``{"flops", "bytes"}`` of one dK/dV launch: 8·B·H·D a scored pair
    (the QK^T and dO·V^T recomputes, P^T·dO and dS^T·Q); q, dout, k, v
    read and dk, dv written once, lse and delta read once."""
    return _attention_cost(q, k, causal, window, 8, 2, 4, 2)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, *, causal: bool,
                        scale: float, window=None, block_k: int = 512):
    """The plain version: per key block, dV = P (cast to dout's dtype,
    :337) transposed times dO and dK = dS (cast to q's dtype, :344)
    transposed times Q, float32 products, the G query heads of each kv
    head summed, written in k's and v's dtypes."""
    window = check_attention_window(window, causal)
    B, Tk, Hk, D = k.shape
    G = check_gqa_heads(q.shape[2], Hk)
    dk = torch.empty((B, Hk, Tk, D), dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    for k0, qh, kb, doh, p, ds in key_blocks(q, k, v, dout, lse, delta,
                                             causal=causal, scale=scale,
                                             window=window, block_k=block_k):
        bk = kb.shape[2]
        dv_b = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), doh)
        dk_b = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), qh)
        dv[:, :, k0:k0 + bk] = dv_b.reshape(B, Hk, G, bk, D).sum(2)
        dk[:, :, k0:k0 + bk] = dk_b.reshape(B, Hk, G, bk, D).sum(2)
    return (dk.to(k.dtype).transpose(1, 2).contiguous(),
            dv.to(v.dtype).transpose(1, 2).contiguous())


def _fn(variant):
    name = f"flash_bwd_dkv_{variant}"  # library and entry point
    lib = build.load(name)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = getattr(lib, "vt_" + name)
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k, v, dout, lse, delta, causal, scale, window):
    """Launch the variant ``q``'s dtype picks."""
    variant = kernel_variant(NAME, (q, k, v, dout))
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib, fn = _fn(variant)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Tq, Tk, H, Hk, D, scale, int(causal), int(window or 0), stream)
    build.check(lib, rc, NAME)
    launches.inc(variant)
    return dk, dv
