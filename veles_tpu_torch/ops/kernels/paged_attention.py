"""Paged-attention decode: the hand-written CUDA kernel
(``csrc/paged_attention.cu``, each row's live pages split across a
thread-block cluster and merged in one launch) and its plain PyTorch
version.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``paged_attention_decode``
(pallas_call at :612).  :func:`paged_attention_decode` is the wrapper the
engine's decode step calls when ``serve.paged_kernel`` is on: a tensor on
a Hopper card launches the kernel, a CPU tensor takes
:func:`paged_attention_decode_plain` — the gather path
``_attn_decode_step`` takes without the knob (veles_tpu/runtime/
generate.py:236-244 with the ``_attn_scores`` tail).

The wrapper validates and calls the custom op
``torch.ops.veles_tpu_torch.paged_attention_decode``: its CUDA
implementation is the kernel launch (the launch counter moves there and
nowhere else), its CPU implementation the plain version, and its fake
implementation gives ``torch.export`` the output's shape, so a sealed
decode program (``export/compiled.py``) calls the kernel as the live
engine does.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import check_attention_window, check_gqa_heads, kernel_route
from . import build

NAME = "paged_attention_decode"
SOURCE = "veles_tpu_torch/csrc/paged_attention.cu"
REPLACES = "veles_tpu/ops/pallas_kernels.py:612"

#: launches of the CUDA kernel (never of the plain version), by the
#: pool's type: ``"f32_pool"`` (``paged_decode_kernel``), ``"bf16_pool"``
#: (``paged_decode_bf16pool_kernel``) or ``"f16_pool"``
#: (``paged_decode_f16pool_kernel``)
launches = build.LaunchCounter()

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the pool dtypes the kernel reads, and the variant each launch counts
_POOL_DTYPES = {torch.float32: (0, "f32_pool"),
                torch.bfloat16: (1, "bf16_pool"),
                torch.float16: (2, "f16_pool")}
_HEAD_DIMS = (16, 64)      # configs/induction_lm*.json, bench_lm.py width
_MAX_GROUP = 8


def _validate(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads):
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError("paged decode wants q (B, H, Dh) and pools "
                         "(rows, page_size, Hk, Dh)")
    B, H, Dh = q.shape
    rows, psz, Hk, Dh_k = k_pool.shape
    if psz != page_size:
        raise ValueError(f"pool page size {psz} != page_size {page_size}")
    if n_kv_heads != Hk:
        raise ValueError(f"pool holds {Hk} kv heads, caller declared "
                         f"{n_kv_heads}")
    if Dh_k != Dh:
        raise ValueError(f"pool head dim {Dh_k} != query head dim {Dh}")
    if k_pool.dtype != v_pool.dtype:
        raise ValueError(f"K pool {k_pool.dtype} and V pool {v_pool.dtype} "
                         "differ")
    if ptab.dim() != 2 or ptab.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"ptab must be (B, n_ptab) and pos (B,) for "
                         f"B={B}, got {tuple(ptab.shape)} / "
                         f"{tuple(pos.shape)}")
    return check_gqa_heads(H, Hk)


def paged_attention_decode(q, k_pool, v_pool, ptab, pos, *, page_size: int,
                           n_kv_heads: int, scale: Optional[float] = None,
                           window: Optional[int] = None):
    """One-position decode: softmax(q.K^T).V over each row's positions
    t <= pos[b] (and t > pos[b] - window), with K/V in a flat page pool
    addressed through the row's page table.

    q: (B, H, Dh) at each row's own position (RoPE applied); pools:
    (rows, page_size, Hk, Dh) of one dtype (the engine's cache type: the
    kernel reads float32, bfloat16 and float16); ptab: (B, n_ptab) int32 physical page per
    logical page (entries past a slot's span point at the scratch row and
    are never read); pos: (B,) int32.  Returns the (B, H, Dh) float32
    context before the output projection.  A row whose live pages include
    an entry outside [0, rows) comes back NaN: a corrupt page table shows
    in the output."""
    _validate(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads)
    window = check_attention_window(window, True)
    scale = q.shape[2] ** -0.5 if scale is None else float(scale)
    with build.reporting(NAME, lambda: _op_cost(
            q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads, scale,
            window)):
        return _op(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads,
                   scale, window)


@torch.library.custom_op("veles_tpu_torch::paged_attention_decode",
                         mutates_args=(), device_types="cpu")
def _op(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        ptab: torch.Tensor, pos: torch.Tensor, page_size: int,
        n_kv_heads: int, scale: float,
        window: Optional[int]) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return paged_attention_decode_plain(
        q, k_pool, v_pool, ptab, pos, page_size=page_size,
        n_kv_heads=n_kv_heads, scale=scale, window=window)


@_op.register_kernel("cuda")
def _op_cuda(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads, scale,
             window):
    """The op's CUDA implementation: the kernel, routed as every wrapper
    routes (``kernel_route`` raises on a card it is not built for)."""
    G = _validate(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads)
    if kernel_route(q, NAME):
        return _launch(q, k_pool, v_pool, ptab, pos, G, page_size, scale,
                       window)
    return paged_attention_decode_plain(
        q, k_pool, v_pool, ptab, pos, page_size=page_size,
        n_kv_heads=n_kv_heads, scale=scale, window=window)


@_op.register_fake
def _op_fake(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads, scale,
             window):
    return q.new_empty(q.shape, dtype=torch.float32)


def _op_cost(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads, scale,
             window):
    """:func:`cost` from the op's arguments (``build.op_cost``)."""
    return cost(q, k_pool, pos.cpu().numpy(), page_size=page_size,
                window=window)


build.register_op(_op, NAME, _op_cost)


def cost(q, k_pool, pos, *, page_size: int, window: Optional[int] = None):
    """``{"flops", "bytes"}`` of one launch at the row positions ``pos``
    (host ints; the work depends on them): each row reads the K and V of
    its live positions (t <= pos, within the window) from the pool, its
    live page-table entries and its position, reads q and writes the
    float32 context once; 4·H·Dh flops a live position (q·K and p·V)."""
    pos = np.asarray(pos, np.int64).reshape(-1)
    H, Dh = q.shape[1], q.shape[2]
    Hk = k_pool.shape[2]
    lo = np.maximum(pos - int(window) + 1, 0) if window else 0
    live = int((pos - lo + 1).sum())
    live_pages = int((pos // page_size - lo // page_size + 1).sum())
    return {"flops": float(4 * H * Dh * live),
            "bytes": float(2 * live * Hk * Dh * k_pool.element_size()
                           + q.numel() * q.element_size()
                           + len(pos) * H * Dh * 4
                           + live_pages * 4 + len(pos) * 4)}


def paged_attention_decode_plain(q, k_pool, v_pool, ptab, pos, *,
                                 page_size: int, n_kv_heads: int,
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """The plain version — the gather path: flatten each row's pages to
    the (B, L, Hk, Dh) logical view (a pool of any dtype widened to
    float32), mask with -inf, one-shot softmax.  Rows with a live
    page-table entry outside the pool are NaN, as the kernel's."""
    G = _validate(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads)
    window = check_attention_window(window, True)
    B, H, Dh = q.shape
    Hk = n_kv_heads
    scale = Dh ** -0.5 if scale is None else float(scale)
    n_ptab = ptab.shape[1]
    L = n_ptab * page_size
    rows = k_pool.shape[0]
    idx = ptab.long()
    p64 = pos.long()
    j = torch.arange(n_ptab, device=q.device)
    live = j[None, :] <= p64[:, None] // page_size
    if window is not None:
        live = live & (j[None, :] >= (p64[:, None] - window + 1).clamp_min(0)
                       // page_size)
    bad = (live & ((idx < 0) | (idx >= rows))).any(dim=1)
    idx = idx.clamp(0, rows - 1)
    kf = k_pool[idx].reshape(B, L, Hk, Dh).float()
    vf = v_pool[idx].reshape(B, L, Hk, Dh).float()
    qg = q.reshape(B, Hk, G, Dh).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, kf) * scale
    t = torch.arange(L, device=q.device)
    mask = t[None, :] <= p64[:, None]
    if window is not None:
        mask = mask & (t[None, :] > p64[:, None] - window)
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vf).reshape(B, H, Dh)
    return out.masked_fill(bad[:, None, None], float("nan"))


def _fn():
    lib = build.load("paged_attention")
    fn = lib.vt_paged_attention_decode
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k_pool, v_pool, ptab, pos, G, page_size, scale, window):
    if q.dtype not in _Q_DTYPES or k_pool.dtype not in _POOL_DTYPES:
        raise TypeError(f"{NAME}: kernel takes float32/bfloat16 q and "
                        f"float32/bfloat16/float16 pools, got {q.dtype} / "
                        f"{k_pool.dtype}")
    if ptab.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"{NAME}: ptab and pos must be int32")
    tensors = (q, k_pool, v_pool, ptab, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{NAME}: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{NAME}: kernel needs contiguous inputs")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError(f"{NAME}: the kernel reads pool rows in 16-byte "
                         "pieces and needs 16-byte aligned pools")
    B, H, Dh = q.shape
    rows, psz, Hk, _ = k_pool.shape
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{NAME}: kernel takes head dim in {_HEAD_DIMS}, "
                         f"got {Dh}")
    if G > _MAX_GROUP:
        raise ValueError(f"{NAME}: kernel takes at most {_MAX_GROUP} query "
                         f"heads per kv head, got {G}")
    kv_code, variant = _POOL_DTYPES[k_pool.dtype]
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    lib, fn = _fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ptab.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, Hk, Dh,
            psz, ptab.shape[1], rows, _Q_DTYPES[q.dtype], kv_code, scale,
            int(window or 0), stream)
    build.check(lib, rc, NAME)
    launches.inc(variant)
    return out
