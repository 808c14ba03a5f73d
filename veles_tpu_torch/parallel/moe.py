"""Mixture-of-experts FFN, the local path (counterpart of
veles_tpu/parallel/moe.py:32-197).

Routing follows the JAX package exactly: top-k of the router's softmax
(ties to the lower expert index, as ``jax.lax.top_k``), GShard slot
priority (every token's slot-0 route queues before any slot-1 route),
capacity ``C = max(1, int(capacity_factor * T * K / E))``, routes past
capacity dropped.  Two dispatch formulations with the same answer:
``"sort"`` (a stable argsort of the routes by expert gives each its queue
position; tokens are copied into their (expert, slot) rows) and
``"dense"`` (one-hot einsums).

Every shape here is fixed by ``(T, D, E, K, C)`` and nothing reads a
value back to the host, so a CUDA graph captures the layer.  No step
adds floats through atomics where the order would show: the dispatch
copies each kept route into its own row (the dropped ones all land in
one spare row, which is thrown away), the combine gathers, and the
load-balance counts add whole numbers.  The expert bank is a batched
matrix product; the JAX package computes it outside any Pallas kernel,
so it stays a torch op here.

The expert-parallel form (``moe_apply_manual``, :200-262): every rank of
the ``expert`` group routes its own tokens and packs them into capacity
slots as the local "sort" mode does, an all-to-all sends each expert's
slots to the rank that owns it (``E / n`` experts a rank), that rank runs
its slice of the bank on the slots of every rank, and a second
all-to-all carries the results home.  Capacity counts per source rank;
the load-balance loss sums its token and probability counts over the
group, so it is the loss of the group's whole token set.  Each rank's
bank gradient is nonzero only in its own experts' slice, and the step's
sum over the group rebuilds the whole bank's.  Two forms run it: over
the axis's process group (the exchanges are :class:`_AllToAll`, whose
backward is the same exchange, and :class:`_AllReduce`), and
:func:`moe_apply_manual_ranks`, the in-process rank loop that checks it
on one device and that no code path picks for itself.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

DISPATCH_MODES = ("sort", "dense")


def init_moe_params(generator: torch.Generator, n_experts: int,
                    d_model: int, d_hidden: int, *, device=None,
                    dtype=torch.float32) -> dict:
    """Router ``(D, E)`` and expert banks ``w1 (E, D, H)``, ``w2 (E, H,
    D)``, uniform in +-1/sqrt(fan-in) as the JAX package draws them (the
    numbers differ: weights move between the packages by snapshot)."""
    s1 = 1.0 / float(d_model) ** 0.5
    s2 = 1.0 / float(d_hidden) ** 0.5

    def uniform(shape, s):
        t = torch.rand(shape, generator=generator, dtype=torch.float32)
        return (t * (2 * s) - s).to(device=device, dtype=dtype)

    w1 = uniform((n_experts, d_model, d_hidden), s1)
    w2 = uniform((n_experts, d_hidden, d_model), s2)
    router = uniform((d_model, n_experts), s1)
    return {"router": router, "w1": w1, "w2": w2}


def capacity(capacity_factor: float, T: int, K: int, E: int) -> int:
    """Slots per expert (veles_tpu/parallel/moe.py:161)."""
    return max(1, int(capacity_factor * T * K / E))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` on the last axis: largest first, equal values
    in index order (a stable descending sort; ``torch.topk`` promises no
    order among ties on the card)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_positions(topi: torch.Tensor, E: int) -> torch.Tensor:
    """Queue position of each (token, slot) route within its expert,
    slot-major (veles_tpu/parallel/moe.py:47-63)."""
    T, K = topi.shape
    flat_e = topi.t().reshape(-1)                   # slot-major (K*T,)
    perm = torch.argsort(flat_e, stable=True)
    seg = flat_e[perm]
    starts = torch.searchsorted(
        seg, torch.arange(E, device=topi.device, dtype=seg.dtype))
    pos_sorted = torch.arange(T * K, device=topi.device) - starts[seg]
    pos_flat = torch.empty_like(pos_sorted).scatter_(0, perm, pos_sorted)
    return pos_flat.reshape(K, T).t()               # (T, K)


def _route(params: dict, x: torch.Tensor, top_k: int):
    """Router logits -> (gates, topi, probs); top-1 keeps the raw
    probability (veles_tpu/parallel/moe.py:71-82)."""
    probs = torch.softmax(x @ params["router"], dim=-1)
    topv, topi = _top_k(probs, top_k)
    if top_k == 1:
        gates = topv
    else:
        gates = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return gates, topi, probs


def _pack_slots(x: torch.Tensor, topi: torch.Tensor, E: int, C: int):
    """Tokens into their (expert, slot) rows -> (slot_idx, keep, xe (E, C,
    D)).  A dropped route targets the spare row ``E*C``, which is cut off
    (the reference's ``.at[].add(mode="drop")``)."""
    T, D = x.shape
    K = topi.shape[1]
    pos = _route_positions(topi, E)
    keep = pos < C
    slot_idx = torch.where(keep, topi * C + pos,
                           torch.full_like(pos, E * C))
    xk = x[:, None, :].expand(T, K, D).reshape(T * K, D)
    xe = x.new_zeros((E * C + 1, D)).index_copy(0, slot_idx.reshape(-1), xk)
    return slot_idx, keep, xe[:E * C].reshape(E, C, D)


def _expert_ffn(xe, w1, w2, out_dtype):
    h = torch.relu(torch.einsum("ecd,edh->ech", xe, w1).float())
    return torch.einsum("ech,ehd->ecd", h.to(out_dtype), w2)


def _combine_slots(ye, slot_idx, keep, gates, x_dtype):
    E_C, D = ye.shape[0] * ye.shape[1], ye.shape[2]
    T, K = slot_idx.shape
    yk = ye.reshape(E_C, D)[slot_idx.clamp(0, E_C - 1).reshape(-1)
                            ].reshape(T, K, D)
    w = (gates * keep.to(gates.dtype)).to(x_dtype)
    return torch.einsum("tk,tkd->td", w, yk)


def _aux_counts(topi: torch.Tensor, probs: torch.Tensor):
    """The primary assignment's token counts and the summed router
    probabilities, per expert (float32)."""
    T, E = probs.shape
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device
                         ).scatter_add_(0, topi[:, 0],
                                        torch.ones(T, dtype=torch.float32,
                                                   device=probs.device))
    return counts, probs.float().sum(0)


def _aux_of(counts, prob_sums, n_tokens: float) -> torch.Tensor:
    E = counts.shape[0]
    return E * torch.sum((counts / n_tokens) * (prob_sums / n_tokens))


def _switch_aux(topi: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Switch load-balance loss on the primary assignment:
    ``E * sum_e f_e * p_e`` (veles_tpu/parallel/moe.py:118-139)."""
    counts, prob_sums = _aux_counts(topi, probs)
    return _aux_of(counts, prob_sums, float(probs.shape[0]))


def moe_apply(params: dict, x: torch.Tensor, *,
              capacity_factor: float = 1.25, top_k: int = 1,
              dispatch_mode: str = "sort"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE FFN over (tokens, d_model) -> ((tokens, d_model), aux)
    (veles_tpu/parallel/moe.py:142-197)."""
    T, D = x.shape
    E = params["router"].shape[1]
    K = int(top_k)
    C = capacity(capacity_factor, T, K, E)
    gates, topi, probs = _route(params, x, K)
    if dispatch_mode == "sort":
        slot_idx, keep, xe = _pack_slots(x, topi, E, C)
        ye = _expert_ffn(xe, params["w1"], params["w2"], x.dtype)
        y = _combine_slots(ye, slot_idx, keep, gates, x.dtype)
    elif dispatch_mode == "dense":
        onehots = torch.nn.functional.one_hot(topi, E).to(x.dtype)
        # slot-major queue positions; the cumsum runs in float32 (a bf16
        # cumsum loses integer exactness past 256)
        oh_flat = onehots.transpose(0, 1).reshape(K * T, E).float()
        pos_flat = torch.cumsum(oh_flat, 0) * oh_flat - 1.0
        pos = pos_flat.reshape(K, T, E).transpose(0, 1)        # (T, K, E)
        keep = (pos >= 0) & (pos < C)
        slot = torch.nn.functional.one_hot(
            pos.clamp(0, C - 1).long(), C).to(x.dtype) \
            * keep.to(x.dtype)[..., None]                      # (T,K,E,C)
        combine = torch.einsum("tk,tkec->tec", gates.to(x.dtype), slot)
        dispatch = (combine > 0).to(x.dtype)
        xe = torch.einsum("tec,td->ecd", dispatch, x)
        ye = _expert_ffn(xe, params["w1"], params["w2"], x.dtype)
        y = torch.einsum("tec,ecd->td", combine, ye)
    else:
        raise ValueError(f"unknown dispatch_mode {dispatch_mode!r}")
    return y, _switch_aux(topi, probs)


# -- expert parallelism -------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal chunks of dim 0:
    chunk ``j`` of rank ``i`` lands as chunk ``i`` of rank ``j``.  The
    exchange is its own transpose, so the backward is the same exchange
    of the gradient."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return _a2a(t.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return None, _a2a(g.contiguous(), ctx.group)


def _a2a(t, group):
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; every rank's copy of the sum is an output of
    its own, so the backward sums the gradients over the group too
    (``psum`` and its transpose)."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return None, g


def _dispatch_layout(xe: torch.Tensor, n: int) -> torch.Tensor:
    """(E, C, D) slots -> (n, El, C, D): chunk ``j`` holds the slots of
    rank ``j``'s experts."""
    E, C, D = xe.shape
    return xe.reshape(n, E // n, C, D)


def _received(xr: torch.Tensor) -> torch.Tensor:
    """(n, El, C, D) received (chunk ``i`` from source rank ``i``) ->
    (El, n*C, D), source-major on the slot axis (the reference's
    ``all_to_all(split_axis=0, concat_axis=1, tiled=True)``)."""
    n, El, C, D = xr.shape
    return xr.transpose(0, 1).reshape(El, n * C, D)


def _returned(yr: torch.Tensor, n: int) -> torch.Tensor:
    """(El, n*C, D) results -> (n, El, C, D): chunk ``i`` goes back to
    source rank ``i``."""
    El, nC, D = yr.shape
    return yr.reshape(El, n, nC // n, D).transpose(0, 1).contiguous()


def _expert_slice(params: dict, rank: int, El: int):
    return (params["w1"][rank * El:(rank + 1) * El],
            params["w2"][rank * El:(rank + 1) * El])


def _check_split(E: int, n: int, axis_name: str) -> int:
    if E % n:
        raise ValueError(f"n_experts={E} must divide over the "
                         f"{axis_name!r} axis ({n})")
    return E // n


def moe_apply_manual(params: dict, x: torch.Tensor, *, mesh,
                     axis_name: str = "expert",
                     capacity_factor: float = 1.25, top_k: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE FFN over the ``axis_name`` group
    (veles_tpu/parallel/moe.py:200-262): ``x`` (tokens, d_model) is this
    rank's token shard and ``params`` the whole (replicated) layer;
    returns this rank's ``(y, aux)``, ``aux`` the same on every rank of
    the group.  With ample capacity (nothing dropped) ``y`` equals
    ``moe_apply`` on the group's whole token set, and ``aux`` always
    equals its load-balance loss."""
    group = mesh.group(axis_name)
    if group is None:
        raise RuntimeError(
            f"expert parallelism over the {axis_name!r} axis "
            f"({mesh.shape[axis_name]}) needs the axis's process group "
            "(parallel.mesh.make_mesh after initialize_distributed)")
    n = mesh.shape[axis_name]
    rank = mesh.axis_index(axis_name)
    T = x.shape[0]
    E = params["router"].shape[1]
    El = _check_split(E, n, axis_name)
    K = int(top_k)
    C = capacity(capacity_factor, T, K, E)
    gates, topi, probs = _route(params, x, K)
    slot_idx, keep, xe = _pack_slots(x, topi, E, C)
    xr = _received(_AllToAll.apply(group, _dispatch_layout(xe, n)))
    yr = _expert_ffn(xr, *_expert_slice(params, rank, El), x.dtype)
    ye = _AllToAll.apply(group, _returned(yr, n)).reshape(E, C, -1)
    y = _combine_slots(ye, slot_idx, keep, gates, x.dtype)
    counts, prob_sums = _aux_counts(topi, probs)
    counts = _AllReduce.apply(group, counts)
    prob_sums = _AllReduce.apply(group, prob_sums)
    return y, _aux_of(counts, prob_sums, float(T * n))


def moe_apply_manual_ranks(params: dict, xs: Sequence[torch.Tensor], *,
                           capacity_factor: float = 1.25, top_k: int = 1
                           ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The expert group's ranks in one process: ``xs[r]`` is rank ``r``'s
    token shard.  Every rank routes and packs its tokens, the exchanges
    are list transposes of the same chunks :func:`moe_apply_manual`
    sends, and rank ``r`` runs experts ``r*El .. r*El+El-1`` of the
    bank.  Returns every rank's ``y`` and the group's ``aux``;
    differentiable through plain autograd."""
    n = len(xs)
    E = params["router"].shape[1]
    El = _check_split(E, n, "expert")
    K = int(top_k)
    T = xs[0].shape[0]
    C = capacity(capacity_factor, T, K, E)
    routed = [_route(params, x, K) for x in xs]
    packed = [_pack_slots(x, r[1], E, C) for x, r in zip(xs, routed)]
    sent = [_dispatch_layout(p[2], n) for p in packed]
    recv = [torch.stack([sent[i][j] for i in range(n)]) for j in range(n)]
    back = [_returned(_expert_ffn(_received(recv[j]),
                                  *_expert_slice(params, j, El),
                                  xs[0].dtype), n) for j in range(n)]
    ys = []
    for i, (x, (gates, _, _), (slot_idx, keep, _)) in enumerate(
            zip(xs, routed, packed)):
        ye = torch.stack([back[j][i] for j in range(n)]).reshape(E, C, -1)
        ys.append(_combine_slots(ye, slot_idx, keep, gates, x.dtype))
    stats = [_aux_counts(r[1], r[2]) for r in routed]
    counts = sum(s[0] for s in stats)
    prob_sums = sum(s[1] for s in stats)
    return ys, _aux_of(counts, prob_sums, float(T * n))


def moe_shardings(params: dict, axis: str = "expert") -> dict:
    """The placement of a MoE layer's params
    (veles_tpu/parallel/moe.py:265-271): the expert banks split their
    leading expert dim over ``axis``, the router replicated.  Every
    rank holds the whole layer; this describes the layout only."""
    return {"router": (), "w1": (axis,), "w2": (axis,)}
