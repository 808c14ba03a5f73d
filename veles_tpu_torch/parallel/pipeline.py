"""Pipeline parallelism over the ``pipe`` process group (counterpart of
veles_tpu/parallel/pipeline.py): the GPipe forward (``pipeline_apply``
:284), the fused 1F1B training step (``pipeline_train_step`` :566) and its
interleaved, virtual-stage form (``interleaved_train_step`` :922).

The JAX package runs one SPMD program under ``shard_map`` in which every
device executes every slot of a lockstep timetable and activations hop
by ``ppermute``.  Here each rank is a process that runs only its own
stages: activations go up and their gradients down the pipe group by
point-to-point ``isend``/``irecv``, one exchange per timetable step,
and a rank posts exactly the messages the timetable says its neighbours
send.  The timetable is the reference's:

* forward of logical stage ``l = j*S + d`` (device ``d``, lane ``j``) on
  microbatch ``m`` at step ``F(l, m) = vS*(m // S) + S*j + m % S + d``;
* its backward at ``B(l, m) = vS*(m // S) + S*(v-1-j) + m % S + (S-1-d)
  + (L-1)``,

which with ``v = 1`` is plain 1F1B (``F = m + d``, ``B = m + 2(S-1) -
d``); the last stage runs the loss gradient in the same step as its
forward.  A rank keeps each in-flight microbatch's autograd graph until
its backward (at most ``2(L-1)+1`` of them, the depth-bounded stash), so
the backward recomputes nothing and a dropout mask is the forward's.
Microbatch ``m`` draws from ``fold_in(step_key, m)`` (:444-448, :785),
the derivation of the JAX schedules.

A rank's gradients are nonzero for the stages it ran, and the caller
sums them (the pipe ranks assemble the stages, the data, fsdp and expert
ranks the batch, the seq ranks the sequence's chunks): here in one
all-reduce over the world, in the workflow's fused step over the ranks
that hold the same blocks (``parallel/fsdp.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import prng
from ..ops.optimizers import tree_leaves, tree_map
from .mesh import shard_rows


def stack_stage_params(per_stage_params) -> dict:
    """Stack identical-structure stage params along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle share of the forward schedule (:55-60): n_mb useful stage
    applications out of n_mb + 2(S-1) steps."""
    steps = n_microbatches + 2 * (n_stages - 1)
    return 1.0 - n_microbatches / steps


def pick_batch_axes(axis_sizes: dict, mb: int,
                    candidates: Sequence[str] = ("data", "fsdp")
                    ) -> Tuple[str, ...]:
    """The candidate-axis subset with the largest product dividing
    ``mb`` (:348-363)."""
    cands = [a for a in candidates if axis_sizes.get(a, 1) > 1]
    best, picked = 1, ()
    for pick in range(1 << len(cands)):
        sub = tuple(a for i, a in enumerate(cands) if pick >> i & 1)
        prod = math.prod(axis_sizes[a] for a in sub) if sub else 1
        if mb % prod == 0 and prod > best:
            best, picked = prod, sub
    return picked


def row_layout(axis_sizes: dict, rows: int, *, moe: bool = False
               ) -> Tuple[Tuple[str, ...], int, int]:
    """How a batch's (or a microbatch's) ``rows`` split over the mesh:
    ``(axes, n_split, replicas)``.  The rows split over ``data`` x
    ``fsdp`` (fsdp ranks are data-parallel: veles_tpu/parallel/mesh.py:
    213-231) where their product divides them, else over the subset
    whose product is the largest that does (a row count none divides
    runs whole on every such rank, as the reference replicates it), and
    on a model with a MoE unit over ``expert`` too, whose units exchange
    their tokens there: that axis must divide the rows (ValueError).
    ``replicas`` is the number of data, fsdp and expert ranks that hold
    each row slice."""
    n_e = axis_sizes.get("expert", 1)
    dp = ("data", "fsdp")
    if moe and n_e > 1:
        if rows % n_e:
            raise ValueError(
                f"a batch of {rows} rows does not divide over the expert "
                f"axis ({n_e}): the MoE units exchange their tokens over "
                "it")
        axes = pick_batch_axes(axis_sizes, rows // n_e,
                               candidates=dp) + ("expert",)
    else:
        axes = pick_batch_axes(axis_sizes, rows, candidates=dp)
    n_split = math.prod(axis_sizes[a] for a in axes)
    holders = math.prod(axis_sizes.get(a, 1) for a in dp) * n_e
    return axes, n_split, holders // n_split


def shard_microbatches(t, mesh, batch_axes: Sequence[str] = (),
                       width_axes: Sequence[str] = ()):
    """This rank's part of a microbatch stack ``(n_mb, mb, ...)``: its
    rows over ``batch_axes`` and, over ``width_axes`` (``("seq",)``,
    :612-621), its chunk of each sample's leading (sequence) dim."""
    bsz = math.prod(mesh.shape[a] for a in batch_axes)
    if t.shape[1] % bsz:
        raise ValueError(
            f"microbatch size {t.shape[1]} not divisible over batch axes "
            f"{tuple(batch_axes)} (total {bsz})")
    t = shard_rows(t, batch_axes, mesh, dim=1)
    wsz = math.prod(mesh.shape[a] for a in width_axes)
    if width_axes and (t.dim() < 3 or t.shape[2] % wsz):
        raise ValueError(
            f"sample shape {tuple(t.shape[2:])} has no leading dim "
            f"divisible over width axes {tuple(width_axes)} (total {wsz})")
    return shard_rows(t, width_axes, mesh, dim=2)


def pipeline_stage_shardings(stacked_params, axis_name: str = "pipe"):
    """The partition of stage-stacked params (:992-997): the leading
    stage axis over ``axis_name``."""
    return tree_map(lambda a: (axis_name,) + (None,) * (a.dim() - 1),
                    stacked_params)


def _check_mb(n_mb: int, S: int, axis_name: str) -> None:
    if n_mb % S:
        raise ValueError(
            f"n_microbatches={n_mb} must be a multiple of the pipeline "
            f"depth {S} (inputs/outputs are sharded over {axis_name!r})")


# -- point-to-point -----------------------------------------------------------

def _exchange(ops) -> None:
    """Post every ``(kind, tensor, peer, tag)`` at once and wait for all:
    no order of blocking calls can deadlock."""
    reqs = [(dist.isend if kind == "send" else dist.irecv)(t, peer, tag=tag)
            for kind, t, peer, tag in ops]
    for r in reqs:
        r.wait()


def pipeline_apply(stage_fns: Sequence[Callable], params_list, x,
                   mesh, *, axis_name: str = "pipe"):
    """The GPipe forward (:284-340), outside autograd: microbatches
    ``x`` (n_mb, mb, ...) stream through the S stages, stage ``d`` on pipe
    rank ``d``; ``stage_fns[i](params_list[i], h) -> (y, aux)``.  Returns
    ``(y (n_mb, mb, ...), aux)`` on every rank of the pipe group: the
    last stage broadcasts the outputs, and ``aux`` is the mean over
    microbatches of the summed stage aux losses."""
    S = mesh.shape[axis_name]
    if len(stage_fns) != S or len(params_list) != S:
        raise ValueError(
            f"need {S} stage fns + param sets for the {axis_name!r} "
            f"axis, got {len(stage_fns)}/{len(params_list)}")
    n_mb = x.shape[0]
    _check_mb(n_mb, S, axis_name)
    d = mesh.axis_index(axis_name)
    ranks = mesh.axis_ranks(axis_name)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    with torch.no_grad():
        for m in range(n_mb):
            if d == 0:
                h = x[m]
            else:
                h = torch.empty_like(x[m])
                dist.recv(h, ranks[d - 1], tag=0)
            y, a = stage_fns[d](params_list[d], h)
            aux = aux + a
            if d < S - 1:
                dist.send(y.to(x.dtype).contiguous(), ranks[d + 1], tag=0)
            else:
                ys.append(y.to(x.dtype))
        out = torch.stack(ys) if d == S - 1 else torch.empty_like(x)
        group = mesh.group(axis_name)
        dist.broadcast(out, src=ranks[-1], group=group)
        dist.all_reduce(aux, group=group)
    return out, aux / n_mb


# -- the fused schedule ---------------------------------------------------------

def fwd_slot(s: int, d: int, S: int, v: int, n_mb: int):
    """(logical stage, microbatch) of rank ``d``'s forward at step ``s``,
    or None (:831-836)."""
    u = s - d
    if u < 0:
        return None
    vS = v * S
    m = (u // vS) * S + u % S
    if m >= n_mb:
        return None
    return ((u % vS) // S) * S + d, m


def bwd_slot(s: int, d: int, S: int, v: int, n_mb: int):
    """(logical stage, microbatch) of rank ``d``'s backward at step
    ``s``, or None (:854-858)."""
    L, vS = v * S, v * S
    u = s - (S - 1 - d) - (L - 1)
    if u < 0:
        return None
    m = (u // vS) * S + u % S
    if m >= n_mb:
        return None
    return (v - 1 - (u % vS) // S) * S + d, m


def n_schedule_steps(S: int, v: int, n_mb: int) -> int:
    """Span of the timetable: ``v*n_mb + L + S - 2`` steps."""
    return v * n_mb + v * S + S - 2


def _backward(tensors, grads) -> None:
    pairs = [(t, g) for t, g in zip(tensors, grads) if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs],
                                [g for _, g in pairs])


def run_schedule(fwd: Callable, loss: Callable, *, n_mb: int, S: int,
                 v: int, d: int, ranks: Sequence[int], act_shape,
                 act_dtype, aux_scale: float, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``d``'s part of the fused timetable.

    ``fwd(l, m, h) -> (ring, out, aux)``: logical stage ``l`` on
    microbatch ``m``; ``h`` is the activation received from stage
    ``l-1`` (a leaf that requires grad; None for ``l = 0``, which reads
    its own input).  ``ring`` (``act_shape``/``act_dtype``) goes to stage
    ``l+1``; the last stage's ``out`` feeds ``loss(out, m)``, which
    returns the microbatch's weighted contribution.  Each stage's
    ``aux`` joins the objective with weight ``aux_scale``.  Gradients
    accumulate in the parameter leaves ``fwd`` closes over.  Returns this
    rank's (loss, aux) sums, detached."""
    L = v * S
    up, down = ranks[(d + 1) % S], ranks[(d - 1) % S]
    stash: Dict[Tuple[int, int], dict] = {}
    loss_acc = torch.zeros((), dtype=torch.float32, device=device)
    aux_acc = torch.zeros((), dtype=torch.float32, device=device)
    aux_g = torch.full((), float(aux_scale), dtype=torch.float32,
                       device=device)
    recv_act = recv_grad = None
    for s in range(n_schedule_steps(S, v, n_mb)):
        f = fwd_slot(s, d, S, v, n_mb)
        ops = []
        if f is not None:
            l, m = f
            h = recv_act.requires_grad_(True) if l > 0 else None
            with torch.enable_grad():
                ring, out, aux = fwd(l, m, h)
                ent = {"h": h, "ring": ring, "aux": aux.float()}
                if l == L - 1:
                    ent["loss"] = loss(out, m)
                    loss_acc = loss_acc + ent["loss"].detach()
            aux_acc = aux_acc + ent["aux"].detach() * aux_scale
            stash[(l, m)] = ent
            if l < L - 1:
                ops.append(("send", ring.detach().to(act_dtype)
                            .contiguous(), up, 0))
        b = bwd_slot(s, d, S, v, n_mb)
        if b is not None:
            l, m = b
            ent = stash.pop((l, m))
            if l == L - 1:
                _backward([ent["loss"] + aux_scale * ent["aux"]], [None])
            else:
                _backward([ent["ring"], ent["aux"]], [recv_grad, aux_g])
            if l > 0:
                g = ent["h"].grad
                ops.append(("send", (torch.zeros_like(ent["h"]) if g is None
                                     else g).contiguous(), down, 1))
        nf = fwd_slot(s + 1, d, S, v, n_mb)
        nb = bwd_slot(s + 1, d, S, v, n_mb)
        recv_act = recv_grad = None
        if nf is not None and nf[0] > 0:
            recv_act = torch.empty(act_shape, dtype=act_dtype,
                                   device=device)
            ops.append(("recv", recv_act, down, 0))
        if nb is not None and nb[0] < L - 1:
            recv_grad = torch.empty(act_shape, dtype=act_dtype,
                                    device=device)
            ops.append(("recv", recv_grad, up, 1))
        _exchange(ops)
    if stash:
        raise RuntimeError(f"pipeline schedule left {sorted(stash)} "
                           "without a backward")
    return loss_acc, aux_acc


def all_reduce_grads(grads: list, scalars: Sequence[torch.Tensor],
                     group) -> Tuple[list, List[torch.Tensor]]:
    """Sum a list of gradient tensors and some float32 scalars over
    ``group`` in one all-reduce of a flat float32 buffer."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [s.reshape(1).float() for s in scalars])
    dist.all_reduce(flat, group=group)
    out, off = [], 0
    for g in grads:
        n = g.numel()
        out.append(flat[off:off + n].reshape(g.shape).to(g.dtype))
        off += n
    return out, [flat[off + i] for i in range(len(scalars))]


def pipeline_train_step(stage_fn, loss_fn: Callable, params, x, labels,
                        mesh, *, axis_name: str = "pipe",
                        batch_axes: Sequence[str] = (),
                        width_axes: Sequence[str] = (),
                        rng=None, with_aux: bool = False,
                        interleave: int = 1):
    """The fused 1F1B training step (:566-708) on the uniform stage
    contract: returns ``(loss[, aux], grads)`` on every rank.

    ``stage_fn(p, x) -> y`` with the microbatch shape in and out; with
    ``rng`` (a raw key pair) ``stage_fn(p, x, key) -> (y, aux)``, ``key =
    fold_in(rng, m)``.  Homogeneous form: one callable and stage-stacked
    ``params`` (leading axis ``interleave * S``); heterogeneous: lists of
    S callables and param trees.  ``x``/``labels``: the global
    microbatch stacks (n_mb, mb, ...); ``batch_axes`` (``("data",)``)
    split each microbatch's rows over those axes.  ``width_axes``
    (``("seq",)``, :612-621) split each sample's leading (sequence) dim
    of ``x`` over those axes: the stages and the activation ring carry
    this rank's chunk, the labels stay whole, and ``loss_fn`` (which
    takes its own chunk of them) is reduced over the width axes like a
    batch axis.  ``loss_fn(y, lbl)`` must be a mean over its slice; the
    loss returned is the mean over microbatches (and data and width
    shards) and the grads are its gradient plus
    the aux losses' (cotangent 1 per stage and microbatch, rescaled the
    same way), as ``jax.value_and_grad`` over the GPipe forward gives.
    ``interleave=v > 1``: the virtual-stage timetable, stage ``l`` on
    rank ``l % S`` (homogeneous form only)."""
    S = mesh.shape[axis_name]
    v = int(interleave)
    L = S * v
    if callable(stage_fn):
        leading = {a.shape[0] for a in tree_leaves(params)}
        if leading != {L}:
            raise ValueError(
                f"stacked params leading axis {sorted(leading)} must equal "
                f"the {axis_name!r} mesh axis size {S}"
                + (f" x interleave {v}" if v > 1 else ""))
        fns = [stage_fn] * L
        plist = [tree_map(lambda a, _l=l: a[_l], params) for l in range(L)]
    else:
        if v > 1:
            raise ValueError("interleave > 1 needs uniform (stacked) "
                             "stages")
        fns, plist = list(stage_fn), list(params)
        if len(fns) != S or len(plist) != S:
            raise ValueError(
                f"need {S} stage fns + param sets for the {axis_name!r} "
                f"axis, got {len(fns)}/{len(plist)}")
    n_mb = x.shape[0]
    if labels.shape[0] != n_mb:
        raise ValueError("labels must have the same microbatch count as x")
    _check_mb(n_mb, S, axis_name)
    baxes = tuple(a for a in batch_axes if mesh.shape.get(a, 1) > 1)
    waxes = tuple(a for a in width_axes if mesh.shape.get(a, 1) > 1)
    x = shard_microbatches(x, mesh, baxes, waxes)
    labels = shard_microbatches(labels, mesh, baxes)
    d = mesh.axis_index(axis_name)
    own = {l for l in range(L) if l % S == d}
    live = [tree_map(lambda t: t.detach().requires_grad_(True), p)
            if l in own else p for l, p in enumerate(plist)]
    scale = 1.0 / (n_mb * math.prod(mesh.shape[a] for a in baxes + waxes))

    def fwd(l, m, h):
        cur = x[m] if l == 0 else h
        if rng is not None:
            y, aux = fns[l](live[l], cur, prng.fold_in(rng, m))
        else:
            y = fns[l](live[l], cur)
            aux = torch.zeros((), dtype=torch.float32, device=y.device)
        return y, y, aux

    loss_sum, aux_sum = run_schedule(
        fwd, lambda out, m: loss_fn(out, labels[m]) * scale, n_mb=n_mb,
        S=S, v=v, d=d, ranks=mesh.axis_ranks(axis_name),
        act_shape=tuple(x.shape[1:]), act_dtype=x.dtype, aux_scale=scale,
        device=x.device)
    glist = [tree_map(lambda t: torch.zeros_like(t) if t.grad is None
                      else t.grad, live[l]) if l in own
             else tree_map(torch.zeros_like, plist[l]) for l in range(L)]
    flat, (loss, aux) = all_reduce_grads(
        [g for gl in glist for g in tree_leaves(gl)], [loss_sum, aux_sum],
        mesh.world_group)
    it = iter(flat)
    glist = [tree_map(lambda _: next(it), gl) for gl in glist]
    grads = stack_stage_params(glist) if callable(stage_fn) else glist
    if with_aux:
        return loss, aux, grads
    return loss, grads


def interleaved_train_step(stage_fn: Callable, loss_fn: Callable, params,
                           x, labels, mesh, *, interleave: int,
                           axis_name: str = "pipe",
                           batch_axes: Sequence[str] = (),
                           width_axes: Sequence[str] = (), rng=None,
                           with_aux: bool = False):
    """The interleaved (virtual-stage) 1F1B step (:922-989): ``params``
    stage-stacked with leading axis ``interleave * S``, stage ``l`` on
    pipe rank ``l % S``; the (loss, grads) contract of
    :func:`pipeline_train_step`."""
    return pipeline_train_step(stage_fn, loss_fn, params, x, labels, mesh,
                               axis_name=axis_name, batch_axes=batch_axes,
                               width_axes=width_axes, rng=rng,
                               with_aux=with_aux, interleave=interleave)
