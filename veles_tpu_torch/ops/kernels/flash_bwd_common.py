"""What the two flash-attention backward wrappers share: argument checks
and the plain versions' recompute loop.

:mod:`.flash_bwd_dq` and :mod:`.flash_bwd_dkv` each pick their own route
(``ops.kernel_route`` on their own input) and then use these helpers, so
either route can be switched without touching the other.
"""

from __future__ import annotations

import torch

from .. import check_gqa_heads

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 64)       # configs/induction_lm*.json, bench_lm.py width


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


def check_kernel_args(name, q, k, v, dout, lse, delta):
    """Raise on what the CUDA kernels do not take (dtypes, layout, head
    dim, grid size)."""
    B, _, H, D = q.shape
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for t in (k, v, dout)):
        raise TypeError(f"{name}: kernel takes float32 or bfloat16 "
                        "q/k/v/dout of one dtype")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError(f"{name}: lse and delta must be float32")
    if not all(t.is_contiguous() for t in (q, k, v, dout, lse, delta)):
        raise ValueError(f"{name}: kernel needs contiguous inputs")
    if any(t.device != q.device for t in (k, v, dout, lse, delta)):
        raise ValueError(f"{name}: inputs on different devices")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: kernel takes head dim in {HEAD_DIMS}, "
                         f"got {D}")
    if B * H > 65535:
        raise ValueError(f"{name}: B*H={B * H} exceeds the grid limit")


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
