"""Ring attention: sequence parallelism over the mesh's ``seq`` axis
(counterpart of veles_tpu/parallel/ring_attention.py:32-237), and the
local attention of one device.

Each rank of the ``seq`` group holds one chunk of the sequence's
queries, keys and values.  The K/V chunks go round the ring: at step
``s`` rank ``r`` holds the chunk of rank ``r - s``, folds it into its
online-softmax accumulators (running max, denominator, float32 output)
and passes it on to rank ``r + 1``.  After ``n`` steps every query has
seen every key, and the output is exact attention over the whole
sequence.  The fold is plain torch, as the reference's is jnp: the
per-rank step (:func:`_ring_fold`) keeps the reference's numerics —
global positions ``rank * Tq + t``, the window on those positions, heads
expanded for grouped-query attention only inside the fold, float32
scores and accumulators, and a causal step whose visiting chunk lies
wholly after the query chunk (or wholly before its window) skipped, here
by a host ``if`` on the known chunk indices.

Two forms run that step:

* :func:`_ring_attention_local`, over the axis's process group: the
  shift is :class:`_RingShift`, a ``torch.autograd.Function`` whose
  forward sends the K/V chunk to rank + 1 and whose backward sends its
  gradient to rank - 1 (``ppermute`` and its transpose);
  :func:`ring_attention` wraps it for whole tensors (each rank slices
  its chunk, runs the ring and gathers the output over the group);
* :func:`ring_attention_ranks`, the in-process rank loop: every rank's
  chunk sits in one list, the ranks' steps run in lockstep and the lists
  rotate.  It exists to check the ring on one device; no code path picks
  it for itself.

``blockwise_attention`` is the one-device attention: the flash-forward
CUDA kernel on the card, its plain online-softmax scan on a CPU tensor.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..ops import check_attention_window, check_gqa_heads
from ..ops.kernels.flash_attention import flash_attention

#: the tag of the ring's point-to-point messages (on the axis's group)
RING_TAG = 17


def blockwise_attention(q, k, v, *, block_size: int = 512,
                        causal: bool = False, scale: Optional[float] = None,
                        window: Optional[int] = None):
    """Memory-efficient attention on one device. q: (B, T, H, D); k/v:
    (B, T, H_kv, D) -> (B, T, H, D).  ``block_size`` is the key block of
    the CPU scan; ``window=W`` (causal only) keeps keys in (q-W, q]."""
    out, _ = flash_attention(q, k, v, causal, scale, window,
                             block_k=block_size)
    return out


# -- the fold -----------------------------------------------------------------

def _attn_block(q, k, v, m, l, o, *, scale, mask=None):
    """Fold one K/V block into the online-softmax accumulators (:32-52).
    q: (B, Tq, H, D); k, v: (B, Tk, H, D); m, l: (B, H, Tq) float32; o:
    (B, Tq, H, D) float32.  Scores and products are float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, -math.inf)
    m_new = torch.maximum(m, s.amax(-1))
    # a row with no live key yet keeps m = -inf: exp against a safe 0
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    alpha = torch.exp(torch.where(torch.isneginf(m), -math.inf,
                                  m - m_safe))
    p = torch.exp(s - m_safe[..., None])
    l_new = alpha * l + p.sum(-1)
    o_new = o * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o_new


def _finalize(l, o):
    return o / l.clamp_min(1e-30).transpose(1, 2)[..., None]


def _init_acc(q):
    B, Tq, H, D = q.shape
    return (torch.full((B, H, Tq), -math.inf, dtype=torch.float32,
                       device=q.device),
            torch.zeros((B, H, Tq), dtype=torch.float32, device=q.device),
            torch.zeros((B, Tq, H, D), dtype=torch.float32,
                        device=q.device))


def _ring_fold(q, k_cur, v_cur, acc, *, rank: int, src: int, causal: bool,
               scale: float, window: Optional[int]):
    """One rank's step of the ring (:154-193): fold the chunk of rank
    ``src`` into ``acc`` = (m, l, o), or return ``acc`` as it is when a
    causal mask hides the whole chunk from this rank's queries."""
    Tq, Tk = q.shape[1], k_cur.shape[1]
    mask = None
    if causal:
        q_lo, k_lo = rank * Tq, src * Tk
        live = k_lo <= q_lo + Tq - 1
        if window is not None:
            live = live and k_lo + Tk - 1 > q_lo - window
        if not live:
            return acc
        q_pos = torch.arange(q_lo, q_lo + Tq, device=q.device)[:, None]
        k_pos = torch.arange(k_lo, k_lo + Tk, device=q.device)[None, :]
        mask = k_pos <= q_pos
        if window is not None:
            mask = mask & (k_pos > q_pos - window)
        mask = mask[None, None]
    g = q.shape[2] // k_cur.shape[2]
    if g > 1:
        k_cur = k_cur.repeat_interleave(g, dim=2)
        v_cur = v_cur.repeat_interleave(g, dim=2)
    return _attn_block(q, k_cur, v_cur, *acc, scale=scale, mask=mask)


def _check(q, k, v, causal, window):
    if q.dim() != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3]:
        raise ValueError(f"ring attention wants (B, T, H, D) q and "
                         f"(B, T, H_kv, D) k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    check_gqa_heads(q.shape[2], k.shape[2])
    return check_attention_window(window, causal)


# -- over the process group ---------------------------------------------------

def _p2p(group, to: int, frm: int, buf):
    """Send ``buf`` to global rank ``to`` and receive one like it from
    ``frm``, both posted at once (no order of blocking calls to
    deadlock)."""
    out = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, to, group=group, tag=RING_TAG),
        dist.P2POp(dist.irecv, out, frm, group=group, tag=RING_TAG)])
    for r in reqs:
        r.wait()
    return out


class _RingShift(torch.autograd.Function):
    """K and V one step round the ring as one message: forward to rank +
    1 (from rank - 1); the backward sends the gradient the other way, to
    rank - 1, and receives its own chunk's from rank + 1 — ``ppermute``
    and its transpose.  Every rank runs the same chain of shifts, so the
    backward posts its exchanges in the same order on every rank."""

    @staticmethod
    def forward(ctx, group, to, frm, k, v):
        ctx.peers = (group, to, frm)
        out = _p2p(group, to, frm, torch.stack([k, v]))
        return out[0], out[1]

    @staticmethod
    def backward(ctx, dk, dv):
        group, to, frm = ctx.peers
        g = _p2p(group, frm, to, torch.stack([dk, dv]).contiguous())
        return None, None, None, g[0], g[1]


class _Tie(torch.autograd.Function):
    """The output, with the ring's last K/V chunk as an input of zero
    gradient: every shift of the chain then lies on the backward's path
    on every rank (a causal rank that skips the late steps uses none of
    their chunks), so no rank leaves a neighbour waiting."""

    @staticmethod
    def forward(ctx, o, k, v):
        ctx.kv = (k.shape, k.dtype, k.device)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        shape, dtype, device = ctx.kv
        z = torch.zeros(shape, dtype=dtype, device=device)
        return do, z, z.clone()


def _axis(mesh, axis_name):
    group = mesh.group(axis_name)
    if group is None:
        raise RuntimeError(
            f"ring attention over the {axis_name!r} axis "
            f"({mesh.shape[axis_name]}) needs the axis's process group "
            "(parallel.mesh.make_mesh after initialize_distributed)")
    return (mesh.shape[axis_name], mesh.axis_index(axis_name),
            mesh.axis_ranks(axis_name), group)


def _ring_attention_local(q, k, v, *, mesh, axis_name: str = "seq",
                          causal: bool, scale: Optional[float] = None,
                          window: Optional[int] = None):
    """This rank's part of ring attention (:138-197): q (B, Tq, H, D) and
    k/v (B, Tk, H_kv, D) are its chunks of the sequence (chunk ``r`` of
    the ``axis_name`` group holds positions ``r*T .. r*T+T-1``); returns
    its chunk of the output.  The K/V traffic stays kv-head sized."""
    n, r, ranks, group = _axis(mesh, axis_name)
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    acc = _init_acc(q)
    to, frm = ranks[(r + 1) % n], ranks[(r - 1) % n]
    for step in range(n):
        acc = _ring_fold(q, k, v, acc, rank=r, src=(r - step) % n,
                         causal=causal, scale=scale, window=window)
        if step < n - 1:
            k, v = _RingShift.apply(group, to, frm, k, v)
    o = _finalize(acc[1], acc[2])
    if n > 1 and torch.is_grad_enabled() and k.requires_grad:
        o = _Tie.apply(o, k, v)
    return o.to(q.dtype)


class _SeqSlice(torch.autograd.Function):
    """Whole tensors -> this rank's chunks along dim 1; the backward
    all-gathers the chunks' gradients over the group, so the whole
    tensors' gradient is whole on every rank (the transpose of a slice
    of a replicated value)."""

    @staticmethod
    def forward(ctx, group, n, r, *ts):
        ctx.group, ctx.n = group, n
        return tuple(t.chunk(n, dim=1)[r].contiguous() for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None) + tuple(
            _all_gather(g.contiguous(), ctx.group, ctx.n) for g in gs)


class _SeqGather(torch.autograd.Function):
    """This rank's chunk -> the whole tensor along dim 1 (all-gather
    over the group); the backward keeps this rank's chunk of the whole
    tensor's gradient."""

    @staticmethod
    def forward(ctx, group, n, r, t):
        ctx.n, ctx.r = n, r
        return _all_gather(t.contiguous(), group, n)

    @staticmethod
    def backward(ctx, g):
        return None, None, None, g.chunk(ctx.n, dim=1)[ctx.r].contiguous()


def _all_gather(t, group, n):
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=1)


def ring_attention(q, k, v, mesh, *, axis_name: str = "seq",
                   causal: bool = False, scale: Optional[float] = None,
                   window: Optional[int] = None):
    """Sequence-parallel attention over whole tensors (:200-216): q (B,
    T, H, D), k/v (B, T, H_kv, D), the same on every rank of the
    ``axis_name`` group.  Each rank takes its T-chunk, runs the ring and
    the output chunks are gathered, so every rank returns the whole (B,
    T, H, D) output — what GSPMD does around the reference's
    ``shard_map``.  ``window`` (causal only) masks on global
    positions."""
    window = _check(q, k, v, causal, window)
    n, r, _, group = _axis(mesh, axis_name)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} does not divide "
                         f"over the {axis_name!r} axis ({n})")
    qr, kr, vr = _SeqSlice.apply(group, n, r, q, k, v)
    o = _ring_attention_local(qr, kr, vr, mesh=mesh, axis_name=axis_name,
                              causal=causal, scale=scale, window=window)
    return _SeqGather.apply(group, n, r, o)


# -- in one process -----------------------------------------------------------

def ring_attention_ranks(qs: Sequence[torch.Tensor],
                         ks: Sequence[torch.Tensor],
                         vs: Sequence[torch.Tensor], *, causal: bool = False,
                         scale: Optional[float] = None,
                         window: Optional[int] = None) -> List[torch.Tensor]:
    """The ring's ranks in one process: ``qs[r]``, ``ks[r]``, ``vs[r]``
    are rank ``r``'s chunks; every step runs each rank's fold
    (:func:`_ring_fold`, the group form's step) and then rotates the
    K/V list by one rank.  Returns every rank's output chunk;
    differentiable through plain autograd."""
    n = len(qs)
    window = _check(qs[0], ks[0], vs[0], causal, window)
    scale = qs[0].shape[3] ** -0.5 if scale is None else float(scale)
    accs = [_init_acc(q) for q in qs]
    kv = list(zip(ks, vs))
    for step in range(n):
        accs = [_ring_fold(qs[r], kv[r][0], kv[r][1], accs[r], rank=r,
                           src=(r - step) % n, causal=causal, scale=scale,
                           window=window) for r in range(n)]
        kv = [kv[(r - 1) % n] for r in range(n)]
    return [_finalize(a[1], a[2]).to(q.dtype) for a, q in zip(accs, qs)]


def full_attention(q, k, v, *, causal: bool = False,
                   scale: Optional[float] = None):
    """Plain O(T^2) attention (:219-233), the tests' reference: float32
    scores, softmax, float32 product, cast to q's dtype.  k/v take q's
    head count."""
    D = q.shape[-1]
    scale = D ** -0.5 if scale is None else float(scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        mask = torch.arange(Tk, device=q.device)[None, :] \
            <= torch.arange(Tq, device=q.device)[:, None]
        s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
