"""What the flash-attention wrappers share: argument checks, the choice
of kernel variant, and the backward plain versions' recompute loop.

:mod:`.flash_attention`, :mod:`.flash_bwd_dq` and :mod:`.flash_bwd_dkv`
each pick their own route (``ops.kernel_route`` on their own input) and
then use these helpers, so any route can be switched without touching the
others.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import check_gqa_heads

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64)       # configs/induction_lm*.json, bench_lm.py width
#: base alignment the tensor-core kernels' 16-byte row copies need
TC_ALIGN = 16


def attention_pairs(Tq: int, Tk: int, causal: bool, window=None) -> int:
    """The (query, key) pairs the kernels score: every pair without a
    mask; with ``causal`` row i sees keys j <= i (the kernels align
    positions at 0) and with a ``window`` W only j > i - W."""
    if not causal:
        return Tq * Tk
    i = np.arange(Tq)
    hi = np.minimum(i, Tk - 1)
    lo = np.maximum(i - int(window) + 1, 0) if window else 0
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attention_cost(q, k, causal, window, flops_per_pair, q_like,
                    k_like, rows):
    """``{"flops", "bytes"}`` of one flash launch: ``flops_per_pair``
    times B·H·D per scored pair; ``q_like`` tensors of q's shape and
    ``k_like`` of k's read or written once, ``rows`` float32 (B, H, Tq)
    rows (lse, delta)."""
    B, Tq, H, D = q.shape
    pairs = attention_pairs(Tq, k.shape[1], causal, window)
    elt = q.element_size()
    return {"flops": float(flops_per_pair * B * H * D * pairs),
            "bytes": float((q_like * q.numel() + k_like * k.numel()) * elt
                           + rows * B * H * Tq * 4)}


def check_bwd_shapes(name, q, k, v, dout, lse, delta):
    """Raise unless q/dout are (B, Tq, H, D), k/v (B, Tk, H_kv, D) and
    lse/delta (B, H, Tq)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or dout.shape != q.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"{name}: want (B, T, H, D) q/dout and k/v, got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, dout {tuple(dout.shape)}")
    B, Tq, H, _ = q.shape
    check_gqa_heads(H, k.shape[2])
    if lse.shape != (B, H, Tq) or delta.shape != (B, H, Tq):
        raise ValueError(f"{name}: lse and delta must be (B, H, Tq) = "
                         f"{(B, H, Tq)}")


def check_kernel_inputs(name, tensors, head_dim, rows):
    """Raise on what the CUDA kernels do not take: ``tensors`` (q, k, v
    and, backward, dout) of one dtype, float32 or bfloat16, contiguous and
    on one device; head dim in :data:`HEAD_DIMS`; ``rows`` = B*H within
    the grid."""
    dtypes = [t.dtype for t in tensors]
    if dtypes[0] not in DTYPES or any(d != dtypes[0] for d in dtypes):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 inputs "
                        f"of one dtype, got {dtypes}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: kernel needs contiguous inputs")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{name}: inputs on different devices")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head dim in {HEAD_DIMS}, "
                         f"got {head_dim}")
    if rows > 65535:
        raise ValueError(f"{name}: B*H={rows} exceeds the grid limit")


def check_kernel_args(name, q, k, v, dout, lse, delta):
    """:func:`check_kernel_inputs` for a backward kernel, and lse and
    delta float32, contiguous and on q's device."""
    check_kernel_inputs(name, (q, k, v, dout), q.shape[3],
                        q.shape[0] * q.shape[2])
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: lse and delta must be float32")
    if not (lse.is_contiguous() and delta.is_contiguous()):
        raise ValueError(f"{name}: kernel needs contiguous inputs")
    if lse.device != q.device or delta.device != q.device:
        raise ValueError(f"{name}: inputs on different devices")


def kernel_variant(name, tensors):
    """The variant a CUDA call of a flash kernel (forward, dQ, dK/dV)
    launches, chosen by dtype and never by shape: ``"tc"`` (the tensor-core
    kernel) for bfloat16, ``"simt"`` for float32.  The tensor-core kernels
    copy each row in 16-byte pieces, so a bf16 tensor whose base is not
    16-byte aligned (a view at an odd element offset) raises, naming the
    kernel: it is never sent to the SIMT kernel or the plain version.
    Call after :func:`check_kernel_inputs`."""
    if tensors[0].dtype == torch.float32:
        return "simt"
    bad = [i for i, t in enumerate(tensors) if t.data_ptr() % TC_ALIGN]
    if bad:
        raise ValueError(f"{name}: the bf16 tensor-core kernel needs "
                         f"{TC_ALIGN}-byte aligned inputs; input(s) {bad} "
                         "start off that boundary (a view at an odd "
                         "offset?): pass a contiguous copy")
    return "tc"


def key_blocks(q, k, v, dout, lse, delta, *, causal, scale, window, block_k):
    """The JAX recompute math of ``_flash_bwd`` one key block at a time
    (never T x T for the whole batch at once).  Yields ``(k0, qh, kb, doh,
    p, ds)`` per block: qh/doh (B, H, Tq, D) float32, kb (B, H, bk, D) in
    k's dtype with the kv heads repeated per group, and the float32
    probabilities and score gradients (B, H, Tq, bk), P forced to 0 by the
    mask (``_flash_bwd_mask``).  Operands are rounded to their storage
    dtype before each product and the products are float32, as the TPU
    kernels' bf16 MXU operands with float32 accumulation are."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    G = check_gqa_heads(H, k.shape[2])
    dev = q.device
    qh = q.transpose(1, 2).float()
    doh = dout.transpose(1, 2).float()
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    q_pos = torch.arange(Tq, device=dev)[:, None]
    for k0 in range(0, Tk, block_k):
        kb = kh[:, :, k0:k0 + block_k]
        vb = vh[:, :, k0:k0 + block_k]
        k_pos = torch.arange(k0, k0 + kb.shape[2], device=dev)[None, :]
        mask = torch.ones((Tq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask = k_pos <= q_pos
            if window is not None:
                mask = mask & (k_pos > q_pos - window)
        s = torch.matmul(qh, kb.float().transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        dp = torch.matmul(doh, vb.float().transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        yield k0, qh, kb, doh, p, ds
