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
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import check_attention_window, check_gqa_heads, kernel_route
from . import build

NAME = "paged_attention_decode"
SOURCE = "veles_tpu_torch/csrc/paged_attention.cu"
REPLACES = "veles_tpu/ops/pallas_kernels.py:612"

#: launches of the CUDA kernel (never of the plain version)
launches = build.LaunchCounter()

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
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
    (rows, page_size, Hk, Dh); ptab: (B, n_ptab) int32 physical page per
    logical page (entries past a slot's span point at the scratch row and
    are never read); pos: (B,) int32.  Returns the (B, H, Dh) float32
    context before the output projection.  A row whose live pages include
    an entry outside [0, rows) comes back NaN: a corrupt page table shows
    in the output."""
    G = _validate(q, k_pool, v_pool, ptab, pos, page_size, n_kv_heads)
    window = check_attention_window(window, True)
    scale = q.shape[2] ** -0.5 if scale is None else float(scale)
    if kernel_route(q, NAME):
        return _launch(q, k_pool, v_pool, ptab, pos, G, page_size, scale,
                       window)
    return paged_attention_decode_plain(
        q, k_pool, v_pool, ptab, pos, page_size=page_size,
        n_kv_heads=n_kv_heads, scale=scale, window=window)


def paged_attention_decode_plain(q, k_pool, v_pool, ptab, pos, *,
                                 page_size: int, n_kv_heads: int,
                                 scale: Optional[float] = None,
                                 window: Optional[int] = None):
    """The plain version — the gather path: flatten each row's pages to
    the (B, L, Hk, Dh) logical view, mask with -inf, one-shot softmax.
    Rows with a live page-table entry outside the pool are NaN, as the
    kernel's."""
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
                       ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(q, k_pool, v_pool, ptab, pos, G, page_size, scale, window):
    if q.dtype not in _Q_DTYPES or k_pool.dtype != torch.float32 \
            or v_pool.dtype != torch.float32:
        raise TypeError(f"{NAME}: kernel takes float32/bfloat16 q and "
                        f"float32 pools (the engine's cache type), got "
                        f"{q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
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
    out = torch.empty((B, H, Dh), dtype=torch.float32, device=q.device)
    lib, fn = _fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            ptab.data_ptr(), pos.data_ptr(), out.data_ptr(), B, H, Hk, Dh,
            psz, ptab.shape[1], rows, _Q_DTYPES[q.dtype], scale,
            int(window or 0), stream)
    build.check(lib, rc, NAME)
    launches.inc()
    return out
