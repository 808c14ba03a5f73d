"""Parameter and optimizer state sharded at rest over the mesh: the
``fsdp`` axis (ZeRO-3) and the ``model`` axis, with the other axes a
rule may name (``pipe`` for stage arrays, ``expert`` for expert banks).

The JAX package places its state with ``state_shardings`` (veles_tpu/
parallel/mesh.py:176-211) and GSPMD inserts the collectives; here they
are written out.  A rank stores its block of every leaf the rule splits,
parameters and the optimizer slots of the parameter's shape alike
(Adam's moments, momentum; a per-leaf scalar such as Adam's ``t`` stays
whole).  A train step:

* gathers each split parameter on use (``use_params``: an all-gather
  over every axis of its partition, except the ``model`` split of a
  unit that computes its own part, ``parallel/tensor_parallel.py``);
* sums the gradients of what it used (``reduce``): first over the
  replica group (``mesh.REPLICA_AXES``: the data, seq, pipe and expert
  ranks, which hold the same blocks), each rank then keeping its
  block of every axis but ``fsdp``, then over the ``fsdp`` group by a
  reduce-scatter of the fsdp-split leaves packed into one buffer (an
  all-reduce and a slice where the backend has no reduce-scatter:
  gloo on the CPU) and an all-reduce of the rest.  ``model`` ranks
  compute the same rows, so they never sum;
* takes the global gradient norm over the shards (``grad_norm``), the
  same on every rank, for ``clip_norm`` and the anomaly skip.

A snapshot gathers every split leaf to the host (``gather_state``,
collective: every rank calls it), and a restore slices the whole state
under the rule again (``shard_state``), so the file is the one the JAX
package reads.

Each of those collective methods is a generator of one rank's local
code (packing, slicing, weighting) that yields its collectives as
requests, ``("sum", tensors, group)``, ``("scatter", buf, group)`` and
``("gather", t, dim, group)`` (``group`` an axis, ``"replica"`` or
``"world"``), and takes the result back.  ``run_steps`` answers them
over the mesh's process groups; ``lockstep`` answers every rank's at
once in one process, which is how ``zero_step_ranks`` runs every fsdp
rank's step of this code on one device (the card has one; NCCL refuses
two ranks on it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.optimizers import tree_leaves, tree_map
from .mesh import AXES, REPLICA_AXES, Mesh, Rule, state_shardings


def _entry_axes(ax) -> Tuple[str, ...]:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One parameter's layout: its whole ``shape``, its stored
    partition ``part`` (one entry a dim: an axis, a tuple of axes or
    None) and ``use``, the part of that split the forward keeps (the
    ``model`` split of a unit that computes its own part), else ()."""
    shape: Tuple[int, ...]
    part: tuple
    use: tuple = ()

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for ax in self.part for a in _entry_axes(ax))

    @property
    def gather(self) -> tuple:
        """Per dim, the axes gathered on use (the stored split less the
        kept one)."""
        use = tuple(self.use) + (None,) * len(self.part)
        return tuple(None if use[d] == ax else ax
                     for d, ax in enumerate(self.part))

    def local_shape(self, sizes: Dict[str, int]) -> Tuple[int, ...]:
        part = tuple(self.part) + (None,) * len(self.shape)
        return tuple(s // math.prod(sizes[a] for a in _entry_axes(part[d]))
                     for d, s in enumerate(self.shape))


def slice_block(t, part, mesh):
    """This rank's block of the whole ``t`` (a tensor or a numpy array)
    under ``part`` (a view; a dim split over a tuple of axes: the first
    outermost, as ``mesh.shard_rows``)."""
    for d, ax in enumerate(part):
        axes = _entry_axes(ax)
        if not axes:
            continue
        i = 0
        for a in axes:
            i = i * mesh.shape[a] + mesh.axis_index(a)
        n = t.shape[d] // math.prod(mesh.shape[a] for a in axes)
        t = t[(slice(None),) * d + (slice(i * n, (i + 1) * n),)]
    return t


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``t`` along ``dim``, in group order."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_rows(buf: torch.Tensor, group, index: int
                        ) -> torch.Tensor:
    """Row ``index`` of ``buf`` (n, m) summed over ``group`` (n ranks):
    a reduce-scatter, or where the backend has none (gloo) an
    all-reduce and a slice."""
    if dist.get_backend(group) == "gloo":
        dist.all_reduce(buf, group=group)
        return buf[index]
    out = torch.empty_like(buf[0])
    dist.reduce_scatter_tensor(out, buf.contiguous(), group=group)
    return out


def run_steps(steps, mesh):
    """Run one rank's step generator (``ShardedState``'s ``*_steps``)
    to its end, its collectives over ``mesh``'s process groups; returns
    the generator's value."""
    from .pipeline import all_reduce_grads
    reply = None
    while True:
        try:
            req = steps.send(reply)
        except StopIteration as stop:
            return stop.value
        op, name = req[0], req[-1]
        group = (mesh.world_group if name == "world" else
                 mesh.replica_group if name == "replica" else
                 mesh.group(name))
        if op == "sum":
            reply = all_reduce_grads(req[1], [], group)[0]
        elif op == "scatter":
            reply = reduce_scatter_rows(req[1], group,
                                        mesh.axis_index(name))
        else:
            reply = all_gather_dim(req[1], req[2], group)


def lockstep(steps: Sequence, meshes: Sequence) -> list:
    """Run every rank's step generator in one process, ``meshes[r]``
    rank ``r``'s coordinates: each round takes every rank's request and
    answers each from its group's (a sum in the group's rank order,
    the same on every member; a scatter's row; a gather's blocks in axis
    order).  Returns the generators' values."""
    n = len(steps)
    replies, done = [None] * n, [None] * n
    while True:
        reqs = []
        for r, s in enumerate(steps):
            try:
                reqs.append(s.send(replies[r]))
            except StopIteration as stop:
                reqs.append(None)
                done[r] = stop.value
        if all(q is None for q in reqs):
            return done
        if any(q is None or q[0] != reqs[0][0] for q in reqs):
            raise RuntimeError("the ranks' collectives diverged: "
                               f"{[q and q[0] for q in reqs]}")
        replies = [_loop_reply(r, reqs, meshes) for r in range(n)]


def _loop_reply(r, reqs, meshes):
    op, name = reqs[r][0], reqs[r][-1]
    # the axes the group spans: the world, the replica axes or one axis
    axes = (AXES if name == "world" else REPLICA_AXES if name == "replica"
            else (name,))

    def coords(k, inside):
        return tuple(meshes[k].axis_index(a) for a in AXES
                     if (a in axes) == inside)
    members = sorted((k for k in range(len(reqs))
                      if coords(k, False) == coords(r, False)),
                     key=lambda k: coords(k, True))
    parts = [reqs[k][1] for k in members]
    if op == "gather":
        return torch.cat(parts, dim=reqs[r][2])
    if op == "sum":
        return [sum(ts[1:], ts[0]) for ts in zip(*parts)]
    return sum(parts[1:], parts[0])[members.index(r)]


class _Slot:
    """A leaf waiting for its gather (``ShardedState._gathered``)."""

    def __init__(self, i: int):
        self.i = i


class ShardedState:
    """The layout of a workflow's state under ``rule`` on ``mesh``
    (``parallel.mesh.Mesh``: its ``shape``, ``axis_index``, groups and
    ``replica_size``).

    ``layouts``: ``{unit: {param: LeafLayout}}`` (nested as the params
    are); ``tp``: ``{unit: {param: partition}}``, the model splits each
    unit computes over the model group itself (``Unit.tp_local``), which
    the step passes to the units as ``Context.tp``; with
    ``tensor_parallel=False`` (the fused 1F1B step) every split is
    gathered on use.  ``sharded``: some leaf is split at rest."""

    def __init__(self, workflow, mesh, rule: Optional[Rule] = None, *,
                 tensor_parallel: bool = True):
        self.mesh = mesh
        self.sizes = dict(mesh.shape)
        shapes = workflow.param_shapes()
        parts = state_shardings({"params": shapes}, self.sizes,
                                rule)["params"]
        self.tp: Dict[str, dict] = {}
        n_model = self.sizes.get("model", 1)
        if tensor_parallel and n_model > 1:
            for u in workflow.topo_order():
                up = parts.get(u.name)
                if isinstance(up, dict):
                    local = u.tp_local(up, n_model)
                    if local:
                        self.tp[u.name] = {k: up[k] for k in sorted(local)}

        def walk(shape_tree, part_tree, keep):
            if isinstance(shape_tree, dict):
                return {k: walk(shape_tree[k], part_tree[k],
                                (keep or {}).get(k)) for k in shape_tree}
            return LeafLayout(tuple(shape_tree), tuple(part_tree),
                              tuple(keep) if keep is not None else ())
        self.layouts = {u: walk(shapes[u], parts[u], self.tp.get(u))
                        for u in shapes}
        self.sharded = any(lay.part for lay in tree_leaves(self.layouts))

    # -- the state at rest -----------------------------------------------------
    def _opt_map(self, fn, *trees):
        """``fn(leaves..., layout or None)`` over same-structure
        optimizer states: a slot leaf of its parameter's whole or block
        shape takes the parameter's layout, any other leaf (a scalar,
        the reserved keys) None."""
        def slot(ts, lay):
            t0 = ts[0]
            if isinstance(t0, dict):
                return {k: slot([t[k] for t in ts], (lay or {}).get(k)
                                if isinstance(lay, dict) else None)
                        for k in t0}
            if isinstance(t0, (list, tuple)):
                return type(t0)(slot([t[i] for t in ts], lay)
                                for i in range(len(t0)))
            ok = (isinstance(lay, LeafLayout)
                  and tuple(np.shape(t0)) in (
                      lay.shape, lay.local_shape(self.sizes)))
            return fn(*ts, lay if ok else None)
        return {k: slot([t[k] for t in trees], self.layouts.get(k))
                for k in trees[0]}

    def shard_state(self, wstate: dict) -> dict:
        """A state with every split leaf of ``params`` and ``opt_state``
        (whole tensors or numpy arrays) replaced by this rank's block,
        copied into its own memory; other entries as they are."""
        def cut(t, lay):
            if lay is None or not lay.part:
                return t
            blk = slice_block(t, lay.part, self.mesh)
            return (blk.contiguous().clone() if torch.is_tensor(blk)
                    else np.ascontiguousarray(blk))
        out = dict(wstate)
        out["params"] = tree_map(cut, wstate["params"], self.layouts)
        out["opt_state"] = self._opt_map(cut, wstate.get("opt_state")
                                         or {})
        return out

    def gather_state(self, wstate: dict) -> dict:
        """Host numpy copy of the whole state (``snapshotter.
        wstate_to_numpy``'s leaf types): every split leaf all-gathered.
        Collective: every rank calls it."""
        from ..runtime.snapshotter import wstate_to_numpy
        return wstate_to_numpy(run_steps(self.gather_steps(wstate),
                                         self.mesh))

    def gather_steps(self, wstate: dict):
        """Steps of :meth:`gather_state`: ``wstate`` with every split
        leaf of ``params`` and ``opt_state`` whole (tensors)."""
        todo: list = []

        def mark(t, lay):
            if lay is None or not lay.part or not torch.is_tensor(t):
                return t
            todo.append((t, lay.part))
            return _Slot(len(todo) - 1)
        full = dict(wstate)
        full["params"] = tree_map(mark, wstate["params"], self.layouts)
        full["opt_state"] = self._opt_map(mark, wstate.get("opt_state")
                                          or {})
        whole = yield from self._gathered(todo)
        for k in ("params", "opt_state"):
            full[k] = tree_map(lambda x: whole[x.i] if isinstance(x, _Slot)
                               else x, full[k])
        return full

    def _gathered(self, todo):
        """Each ``(block, partition)`` of ``todo`` whole: an all-gather
        over each axis of the partition (a dim split over a tuple of
        axes: the innermost first)."""
        out = []
        for t, part in todo:
            t = t.detach()
            for d, ax in enumerate(part):
                for a in reversed(_entry_axes(ax)):
                    if self.sizes[a] > 1:
                        t = yield ("gather", t, d, a)
            out.append(t)
        return out

    # -- a step --------------------------------------------------------------
    def use_params(self, params: dict) -> dict:
        """The parameters as the forward uses them: each split leaf
        gathered over its ``gather`` axes (detached)."""
        return run_steps(self.use_steps(params), self.mesh)

    def use_steps(self, params: dict):
        """Steps of :meth:`use_params`."""
        todo, keep = [], []
        for t, lay in zip(tree_leaves(params), tree_leaves(self.layouts)):
            g = lay.gather
            if any(a is not None for a in g):
                todo.append((t, g))
                keep.append(None)
            else:
                keep.append(t)
        whole = iter((yield from self._gathered(todo)))
        it = iter([t if t is not None else next(whole) for t in keep])
        return tree_map(lambda _: next(it), params)

    def reduce(self, grads: Sequence[torch.Tensor],
               scalars: Sequence[torch.Tensor], params: dict
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The gradients of the used parameters (in ``tree_leaves``
        order of ``params``) summed over the replica and fsdp groups and
        cut to this rank's blocks; float32 ``scalars`` (metrics) summed
        over the same ranks.  Returns (block gradients in the params'
        dtypes, scalars)."""
        return run_steps(self.reduce_steps(grads, scalars, params),
                         self.mesh)

    def reduce_steps(self, grads, scalars, params):
        """Steps of :meth:`reduce`."""
        lays = tree_leaves(self.layouts) if grads else []
        dtypes = [p.dtype for p in tree_leaves(params)]
        out = [g.float() for g in grads]
        scal = [s.reshape(()).float() for s in scalars]
        if self.mesh.replica_size > 1:
            summed = yield ("sum", out + scal, "replica")
            out, scal = summed[:len(out)], summed[len(out):]
        # every axis but fsdp: the replica group's ranks share the other
        # coordinates, so each keeps its block now
        out = [slice_block(g, tuple(
            ax if ax is not None and "fsdp" not in _entry_axes(ax)
            else None for ax in lay.gather), self.mesh)
            for g, lay in zip(out, lays)]
        if self.sizes.get("fsdp", 1) > 1:
            out, scal = yield from self._reduce_fsdp(out, scal, lays)
        return [g.to(dt) for g, dt in zip(out, dtypes)], scal

    def _reduce_fsdp(self, grads, scalars, lays):
        n = self.sizes["fsdp"]
        packed = {i: lay.gather.index("fsdp") for i, lay in enumerate(lays)
                  if "fsdp" in lay.gather}
        rest = [i for i in range(len(grads)) if i not in packed]
        if packed:
            rows = [grads[i].movedim(d, 0).reshape(n, -1)
                    for i, d in packed.items()]
            row = yield ("scatter", torch.cat(rows, dim=1), "fsdp")
            off = 0
            for (i, d), r in zip(packed.items(), rows):
                g = grads[i]
                m = r.shape[1]
                shp = (g.shape[d] // n,) + tuple(
                    s for k, s in enumerate(g.shape) if k != d)
                grads[i] = row[off:off + m].reshape(shp).movedim(0, d)
                off += m
        if rest or scalars:
            summed = yield ("sum", [grads[i] for i in rest] + scalars,
                            "fsdp")
            scalars = summed[len(rest):]
            for i, g in zip(rest, summed):
                # a dim split over fsdp together with other axes
                post = tuple(ax if ax is not None
                             and "fsdp" in _entry_axes(ax) else None
                             for ax in lays[i].gather)
                grads[i] = slice_block(g, post, self.mesh)
        return grads, scalars

    def grad_norm(self, grads, path: Sequence[str] = ()) -> torch.Tensor:
        """float32 global L2 norm of a gradient (sub)tree of blocks
        (``path``: where it sits in the params tree), the same on every
        rank: one all-reduce over the world of each rank's sum of
        squares of the blocks it counts (:meth:`counts`), so every block
        counts once and a replicated leaf once."""
        return run_steps(self.norm_steps(grads, path), self.mesh)

    def counts(self, lay: LeafLayout) -> bool:
        """This rank adds the leaf's block into the norm: it sits at 0 on
        every axis that does not split the leaf (the ranks elsewhere
        hold the same block)."""
        return all(self.mesh.axis_index(a) == 0 for a in self.sizes
                   if self.sizes[a] > 1 and a not in lay.axes)

    def norm_steps(self, grads, path: Sequence[str] = ()):
        """Steps of :meth:`grad_norm`."""
        lays = self.layouts
        for k in path:
            lays = lays[k]
        leaves = tree_leaves(grads)
        tot = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        for g, lay in zip(leaves, tree_leaves(lays)):
            if self.counts(lay):
                tot = tot + torch.sum(torch.square(g.float()))
        if math.prod(self.sizes.values()) > 1:
            (tot,) = yield ("sum", [tot], "world")
        return torch.sqrt(tot + 1e-12)


# -- every fsdp rank's step in one process (the card has one device) --------

def zero_step_ranks(workflow, optimizer, wstate: dict, batch: dict,
                    n: int, rule: Rule, *, lr=None,
                    clip_norm: float = 0.0,
                    sentinel: bool = True) -> dict:
    """One train step of ``n`` fsdp ranks in one process, through
    ``ShardedState``'s own steps under :func:`lockstep`: the state cut
    under ``rule`` into the ranks' blocks, the parameters gathered on
    use; each rank runs forward and backward on its rows (the sharded
    step's row layout) with its loss weighted by its share of the global
    mask count; the gradients reduced into the blocks (the packed
    reduce-scatter) and the norm taken over all of them; each rank runs
    ``guarded_update`` on its blocks; the blocks gathered again.
    ``wstate`` is whole and stays unchanged.  The norm is the global one
    only (``clip_norm`` here): an optimizer with its own or a per-unit
    ``clip_norm`` is refused.  Returns ``{"params", "opt_state"}``
    (whole), the global ``loss`` and ``grad_norm``."""
    from ..ops.optimizers import guarded_update
    from ..units.base import Context
    from ..units.workflow import _Layout, sample_count
    if optimizer.clip_norm is not None or any(
            hp.clip_norm is not None for hp in optimizer.per_unit.values()):
        raise ValueError("zero_step_ranks takes the global norm only: "
                         "pass clip_norm=, not the optimizer's")
    sizes = {a: 1 for a in AXES}
    sizes["fsdp"] = int(n)
    meshes = [Mesh(sizes, r) for r in range(n)]
    states = [ShardedState(workflow, m, rule, tensor_parallel=False)
              for m in meshes]
    blocks = [st.shard_state(wstate) for st in states]
    used = lockstep([st.use_steps(b["params"])
                     for st, b in zip(states, blocks)], meshes)
    ev = workflow.evaluator
    total = torch.clamp_min(
        sample_count(ev, [batch[k] for k in ev.inputs[1:]]), 1.0)
    grads, losses = [], []
    for m, p in zip(meshes, used):
        layout = _Layout(workflow, m, batch)
        local = layout.local(m, batch)
        live = tree_map(lambda t: t.detach().requires_grad_(True), p)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            out, _ = workflow.forward(live, wstate["state"], local,
                                      Context(train=True))
            w = sample_count(ev, [local[k] for k in ev.inputs[1:]]) \
                / total / layout.replicas
            part = out[ev.name] * w
            g = torch.autograd.grad(part, leaves, allow_unused=True)
        grads.append([torch.zeros_like(u) if x is None else x
                      for x, u in zip(g, leaves)])
        losses.append(part.detach())
    red = lockstep([st.reduce_steps(g, [l], b["params"]) for st, g, l, b
                    in zip(states, grads, losses, blocks)], meshes)
    block_grads = []
    for (g, _), b in zip(red, blocks):
        it = iter(g)
        block_grads.append(tree_map(lambda _: next(it), b["params"]))
    loss = red[0][1][0]
    norms = lockstep([st.norm_steps(g)
                      for st, g in zip(states, block_grads)], meshes)
    new = []
    for b, g, gn in zip(blocks, block_grads, norms):
        p, o, _, _ = guarded_update(
            optimizer, g, b["opt_state"], b["params"], int(wstate["step"]),
            loss, clip_norm=clip_norm, sentinel=sentinel, lr=lr,
            norm=lambda _g, _path, _n=gn: _n)
        new.append({"params": p, "opt_state": o})
    whole = lockstep([st.gather_steps(x) for st, x in zip(states, new)],
                     meshes)[0]
    return {"params": whole["params"], "opt_state": whole["opt_state"],
            "loss": loss, "grad_norm": norms[0]}
