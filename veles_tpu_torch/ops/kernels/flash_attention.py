"""Flash-attention forward: the hand-written CUDA kernels and their plain
PyTorch version, joined with the two backward kernels into one
``torch.autograd.Function``.

Two variants, chosen by dtype alone (``kernel_variant``): bfloat16 runs
on the tensor cores (``csrc/flash_fwd_tc.cu``, wgmma), float32 on the
SIMT cores (``csrc/flash_fwd.cu``); ``launches.by_variant()`` counts each.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``_flash_fwd`` (pallas_call
at :205) and the ``custom_vjp`` around it (:450-489).
:func:`flash_attention` is the wrapper every caller uses: a tensor on a
Hopper card launches the kernel, a CPU tensor takes
:func:`flash_attention_plain` (``ops.kernel_route``).  Its output carries
the gradient: the backward saves (q, k, v, out, lse) and calls
:func:`.flash_bwd_dq.flash_bwd_dq` and :func:`.flash_bwd_dkv.flash_bwd_dkv`
— the dQ and dK/dV kernels on the card, their plain versions on the CPU.

The forward is the custom op ``torch.ops.veles_tpu_torch.
flash_attention_fwd``: its CUDA implementation launches the kernel (the
launch counter moves there and nowhere else), its CPU implementation is
the plain version, and its fake implementation gives ``torch.export``
the output shapes, so a sealed forward program (``export/compiled.py``)
calls the kernel as the live forward does.  ``_FlashAttention`` calls
the op inside its forward; a call without gradient reaches it directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import check_attention_window, check_gqa_heads, kernel_route
from . import build
from .flash_bwd_common import (_attention_cost, check_kernel_inputs,
                               kernel_variant)
from .flash_bwd_dkv import flash_bwd_dkv
from .flash_bwd_dq import flash_bwd_dq

NAME = "flash_attention"
#: the source of each variant; SOURCE is the bf16 main path's
SOURCES = {"tc": "veles_tpu_torch/csrc/flash_fwd_tc.cu",
           "simt": "veles_tpu_torch/csrc/flash_fwd.cu"}
SOURCE = SOURCES["tc"]
REPLACES = "veles_tpu/ops/pallas_kernels.py:205"

#: launches of the CUDA kernels, by variant (never of the plain version)
launches = build.LaunchCounter()

_NEG = -1e30


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    window: Optional[int] = None, *,
                    block_k: int = 512):
    """Blockwise online-softmax attention, differentiable in q, k and v.

    q: (B, Tq, H, D); k/v: (B, Tk, H_kv, D) with H_kv dividing H
    (grouped-query attention, no repeat on the kernel path).  ``window=W``
    (causal only) keeps keys in (q - W, q].  Returns ``(out, lse)``: out
    like q, lse (B, H, Tq) float32 row logsumexp (not differentiable).
    ``block_k`` is the key block of the plain versions' scans (the
    kernels' tiles are fixed)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention wants (B, T, H, D) q/k/v")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"incompatible shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    check_gqa_heads(q.shape[2], k.shape[2])
    window = check_attention_window(window, causal)
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, window,
                                     block_k)
    return _forward(q, k, v, causal, scale, window, block_k)


def cost(q, k, v, causal: bool = False, window: Optional[int] = None):
    """``{"flops", "bytes"}`` of one forward launch: 4·B·H·D a scored
    (query, key) pair (the QK^T and PV products); q, k, v read and out
    written once, the float32 lse written once."""
    return _attention_cost(q, k, causal, window, 4, 2, 2, 1)


def _forward(q, k, v, causal, scale, window, block_k):
    with build.reporting(NAME, lambda: cost(q, k, v, causal, window)):
        return _op(q, k, v, causal, scale, window, block_k)


@torch.library.custom_op("veles_tpu_torch::flash_attention_fwd",
                         mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        scale: float, window: Optional[int],
        block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's CPU implementation: the plain version."""
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 window=window, block_k=block_k)


@_op.register_kernel("cuda")
def _op_cuda(q, k, v, causal, scale, window, block_k):
    """The op's CUDA implementation: the kernel of q's dtype, routed as
    every wrapper routes (``kernel_route`` raises on a card it is not
    built for)."""
    if kernel_route(q, NAME):
        return _launch(q, k, v, causal, scale, window)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                 window=window, block_k=block_k)


@_op.register_fake
def _op_fake(q, k, v, causal, scale, window, block_k):
    B, Tq, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Tq), dtype=torch.float32))


build.register_op(_op, NAME, lambda q, k, v, causal, scale, window, block_k:
                  cost(q, k, v, causal, window))


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of pallas_kernels.py:450-489: the forward keeps
    (q, k, v, out, lse); the backward is the two-pass recompute — delta =
    rowsum(dO * O) as a PyTorch expression (:375-378), then dQ and dK/dV.
    The attention matrix is never stored in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, block_k):
        out, lse = _forward(q, k, v, causal, scale, window, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, scale=scale, window=window,
                        block_k=block_k)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(
            1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, **ctx.args)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          scale: Optional[float] = None,
                          window: Optional[int] = None, block_k: int = 512):
    """The plain version: the JAX package's blockwise online-softmax scan
    (veles_tpu/parallel/ring_attention.py:88-135) with the TPU kernel's
    masking convention (-1e30, so a row with no live key gives 0, not
    NaN).  Scores, m/l and the accumulator are float32; probabilities are
    rounded to v's dtype before the P.V product, as the kernel does."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    G = check_gqa_heads(H, k.shape[2])
    window = check_attention_window(window, causal)
    scale = D ** -0.5 if scale is None else float(scale)
    dev = q.device
    qh = q.transpose(1, 2).float()                       # (B, H, Tq, D)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)   # (B, H, Tk, D)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    m = torch.full((B, H, Tq), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Tq, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Tq, device=dev)[:, None]
    for k0 in range(0, Tk, block_k):
        kb = kh[:, :, k0:k0 + block_k].float()
        vb = vh[:, :, k0:k0 + block_k]
        s = torch.matmul(qh, kb.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
        mask = torch.ones((Tq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask = k_pos <= q_pos
            if window is not None:
                mask = mask & (k_pos > q_pos - window)
        s = s.masked_fill(~mask, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.matmul(
            p.to(v.dtype).float(), vb.float())
        m = m_new
    denom = l.clamp_min(1e-30)
    out = (acc / denom[..., None]).to(q.dtype).transpose(1, 2).contiguous()
    return out, m + torch.log(denom)


def _fn(variant):
    lib = build.load("flash_fwd_tc" if variant == "tc" else "flash_fwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.vt_flash_fwd_tc if variant == "tc" else lib.vt_flash_fwd
    if fn.argtypes is None:
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, i, i, p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k, v, causal, scale, window):
    """Launch the variant ``q``'s dtype picks."""
    B, Tq, H, D = q.shape
    Tk, Hk = k.shape[1], k.shape[2]
    check_kernel_inputs(NAME, (q, k, v), D, B * H)
    variant = kernel_variant(NAME, (q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    lib, fn = _fn(variant)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Tq, Tk, H, Hk, D, scale, int(causal),
            int(window or 0), stream)
    build.check(lib, rc, NAME)
    launches.inc(variant)
    return out, lse
