"""Workflow: the unit container and its train, eval and predict steps
(counterpart of veles_tpu/units/workflow.py).

The JAX package traces the unit DAG into compiled programs; PyTorch runs
eagerly, so here the DAG is walked in topological order on every call
(and ``runtime/step_cache.py`` captures a step once as a CUDA graph on
the card).  The workflow state keeps the JAX package's layout
(``new_state``: params / state / opt_state / step / key), so a snapshot
moves between the two packages by key.  PyTorch has no buffer donation:
the train step writes every updated tensor into the state's tensor it
read (``copy_`` under ``torch.no_grad``) and returns the same state.
"""

from __future__ import annotations

import functools
import hashlib
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import prng
from ..logger import Logger
from ..ops import resolve_device
from ..ops.optimizers import (Optimizer, guarded_update, tree_assign,
                              tree_leaves, tree_map, tree_select)
from .base import Context, Spec, Unit


class WorkflowError(Exception):
    pass


def new_state(params, state, opt_state, step, key):
    """The workflow state dictionary (veles_tpu/units/workflow.py:43)."""
    return {"params": params, "state": state, "opt_state": opt_state,
            "step": step, "key": key}


def seed_key(seed: int) -> np.ndarray:
    """Raw data of the JAX package's ``jax.random.key(seed)`` (threefry:
    ``[0, seed]`` as uint32), stored in the state's ``key`` slot so a
    port snapshot restores in the JAX package with a valid key."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


class Workflow(Logger):
    """Container + runner for a unit DAG."""

    def __init__(self, name: str = "Workflow"):
        self.name = name
        self.units: List[Unit] = []
        self._by_name: Dict[str, Unit] = {}
        self._order: Optional[List[Unit]] = None
        self._specs: Dict[str, Spec] = {}
        self.evaluator: Optional[Unit] = None

    def add(self, unit: Unit) -> Unit:
        if unit.name in self._by_name:
            raise WorkflowError(f"duplicate unit name {unit.name!r}")
        self.units.append(unit)
        self._by_name[unit.name] = unit
        self._order = None
        if getattr(unit, "is_evaluator", False):
            self.evaluator = unit
        return unit

    def topo_order(self) -> List[Unit]:
        """Topological order over data edges, with the wiring checks."""
        if self._order is not None:
            return self._order
        order, seen, visiting = [], set(), set()

        def visit(u: Unit):
            if u.name in seen:
                return
            if u.name in visiting:
                raise WorkflowError(f"cycle through unit {u.name!r}")
            visiting.add(u.name)
            for src in u.inputs:
                if src.startswith("@"):
                    continue
                if src not in self._by_name:
                    raise WorkflowError(
                        f"unit {u.name!r} consumes unknown source {src!r}")
                visit(self._by_name[src])
            visiting.discard(u.name)
            seen.add(u.name)
            order.append(u)

        for u in self.units:
            visit(u)
        self._order = order
        return order

    def build(self, input_specs: Dict[str, Spec]) -> Dict[str, Spec]:
        """Infer output specs in topo order; validates all wiring."""
        specs = dict(input_specs)
        for u in self.topo_order():
            in_specs = []
            for src in u.inputs:
                if src not in specs:
                    raise WorkflowError(
                        f"unit {u.name!r} needs {src!r} which is neither a "
                        f"batch key nor an upstream unit output")
                in_specs.append(specs[src])
            specs[u.name] = u.output_spec(in_specs)
        self._specs = specs
        return specs

    @property
    def specs(self) -> Dict[str, Spec]:
        return self._specs

    def init_state(self, seed: int = 0, optimizer: Optional[Optimizer] = None,
                   device=None) -> dict:
        """Fresh weights from an explicit CPU ``torch.Generator`` seeded
        with ``seed`` (the same numbers on every device), placed on
        ``device`` (default: the CUDA card, see ``ops.resolve_device``);
        ``opt_state`` from ``optimizer.init`` (empty without one)."""
        if not self._specs:
            raise WorkflowError("call build() before init_state()")
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        params, state = {}, {}
        for u in self.topo_order():
            p, s = u.init(gen, [self._specs[i] for i in u.inputs], dev)
            if p:
                params[u.name] = p
            if s:
                state[u.name] = s
        opt_state = optimizer.init(params) if optimizer is not None else {}
        return new_state(params, state, opt_state, 0, seed_key(seed))

    def param_shapes(self) -> Dict[str, Dict[str, tuple]]:
        """unit -> param -> shape the built workflow expects (an init
        whose tensors land on the meta device)."""
        return self._init_shapes()[0]

    def state_shapes(self) -> Dict[str, Dict[str, tuple]]:
        """unit -> unit-state entry -> shape the built workflow expects
        (the normalizers' ``mean``/``rdisp``)."""
        return self._init_shapes()[1]

    def _init_shapes(self):
        if not self._specs:
            raise WorkflowError("call build() before param_shapes()")
        gen = torch.Generator().manual_seed(0)
        params, state = {}, {}

        def shapes(tree):
            return tree_map(lambda t: tuple(t.shape), tree)

        for u in self.topo_order():
            p, s = u.init(gen, [self._specs[i] for i in u.inputs], "meta")
            if p:
                params[u.name] = shapes(p)
            if s:
                state[u.name] = shapes(s)
        return params, state

    def forward(self, params, state, batch, ctx: Context, *,
                only: Optional[set] = None):
        """Forward over the DAG; returns (all outputs, new unit state)."""
        outputs = dict(batch)
        nstate = {}
        for u in self.topo_order():
            if only is not None and u.name not in only:
                continue
            xs = [outputs[s] for s in u.inputs]
            y, ns = u.apply(params.get(u.name, {}), state.get(u.name, {}),
                            xs, ctx)
            outputs[u.name] = y
            if ns:
                nstate[u.name] = ns
        return outputs, nstate

    def all_units(self) -> List[Unit]:
        """Every unit in topological order, a composite unit (a pipeline
        stack) followed by its sub-units."""
        out = []
        for u in self.topo_order():
            out.append(u)
            out.extend(getattr(u, "sub_units", lambda: [])())
        return out

    def ancestors(self, name: str) -> set:
        """Unit names needed to compute ``name`` (inclusive)."""
        need, stack = set(), [name]
        while stack:
            n = stack.pop()
            if n in need or n.startswith("@"):
                continue
            need.add(n)
            stack.extend(self._by_name[n].inputs)
        return need

    def _metrics(self, params, state, outputs, ctx) -> Dict[str, Any]:
        if self.evaluator is None:
            return {}
        ev = self.evaluator
        xs = [outputs[s] for s in ev.inputs]
        return ev.metrics(params.get(ev.name, {}), state.get(ev.name, {}),
                          xs, ctx)

    def make_train_step(self, optimizer: Optimizer) -> "TrainStep":
        """(wstate, batch) -> (wstate, metrics): forward, gradients,
        ``guarded_update`` (the anomaly skip and ``clip_norm`` from
        ``root.common.train``), the skip metrics, step + 1 and the key
        split — the contract of veles_tpu/units/workflow.py:214-310; see
        :class:`TrainStep`."""
        if self.evaluator is None and not any(
                getattr(u, "self_updating", False) for u in self.units):
            raise WorkflowError("a train step needs an evaluator unit "
                                "(or a self-updating unit)")
        return TrainStep(self, optimizer)

    def make_sharded_train_step(self, optimizer: Optimizer, mesh, *,
                                rule=None) -> "ShardedTrainStep":
        """The train step over the mesh, its state placed by ``rule``
        (``parallel.mesh``: a rule over ``(path, shape)``; None
        replicates) (veles_tpu/units/workflow.py:312-336): see
        :class:`ShardedTrainStep`; ``step.place(wstate)`` gives the state
        it takes."""
        return ShardedTrainStep(self, optimizer, mesh, rule=rule)

    def make_pipeline_train_step(self, optimizer: Optimizer, mesh, *,
                                 n_microbatches: int, interleave: int = 1,
                                 rule=None):
        """The fused 1F1B train step over the mesh's ``pipe`` axis (the
        rows over ``data`` x ``fsdp``), interleaved with ``interleave``
        > 1, its state placed by ``rule`` (veles_tpu/units/workflow.py:
        338-364; ``parallel/pipeline_compile.py``)."""
        from ..parallel.pipeline_compile import build_pipeline_step
        return build_pipeline_step(self, optimizer, mesh,
                                   n_microbatches=n_microbatches,
                                   interleave=interleave, rule=rule)

    def make_sharded_eval_step(self, mesh, *,
                               rule=None) -> "ShardedEvalStep":
        """The eval step over the mesh, on the state ``rule`` places
        (veles_tpu/units/workflow.py:366-380): see
        :class:`ShardedEvalStep`."""
        return ShardedEvalStep(self, mesh, rule=rule)

    def make_eval_step(self) -> "EvalStep":
        """(wstate, batch) -> the evaluator's metrics, under
        ``torch.inference_mode``."""
        return EvalStep(self)

    def n_params(self, wstate) -> int:
        return sum(int(t.numel()) for t in tree_leaves(wstate["params"]))

    def gather_results(self, metrics: Dict[str, Any]) -> Dict[str, Any]:
        """JSON-able result dict (veles_tpu/units/workflow.py:575-584)."""
        out = {"workflow": self.name, "checksum": self.checksum()}
        for k, v in metrics.items():
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                out[k] = repr(v)
        return out

    def default_output(self) -> str:
        """Name of the last forward (non-evaluator) unit."""
        cands = [u.name for u in self.topo_order()
                 if not getattr(u, "is_evaluator", False)]
        if not cands:
            raise WorkflowError("no forward units")
        return cands[-1]

    def make_predict_step(self, output_unit: Optional[str] = None):
        """(wstate, batch) -> output of the last forward (or named) unit,
        under ``torch.inference_mode``."""
        if output_unit is None:
            output_unit = self.default_output()
        needed = self.ancestors(output_unit)

        def step(wstate, batch):
            ctx = Context(train=False)
            with torch.inference_mode():
                outputs, _ = self.forward(wstate["params"],
                                          wstate["state"], batch, ctx,
                                          only=needed)
            return outputs[output_unit]

        return step

    def checksum(self) -> str:
        """Stable identity of the graph topology — the same digest the
        JAX package computes for the same layer list."""
        desc = [(u.name, type(u).__name__, list(u.inputs))
                for u in self.topo_order()]
        return hashlib.sha256(
            json.dumps(desc, sort_keys=True).encode()).hexdigest()


class TrainStep:
    """The train step in its two parts, so that ``runtime/step_cache.py``
    can capture the device part as a CUDA graph and replay it:

    * :meth:`begin` (host): the key is split (``split_state_key``) and the
      step advanced; the learning rate ``schedule(step)`` (numpy, as the
      JAX package's host schedule), the fault harness's NaN flag for this
      step and the seed of every unit that draws one (``Unit.draws_seed``:
      ``bits32(fold_in(sub, hash(name)))``, the JAX package's chain) go
      into one int32 staging tensor on the device (the two float32
      scalars as their bits), by one non-blocking copy from pinned memory
      on the card;
    * :meth:`run` (device): forward, gradients, the guarded update reading
      the learning rate and the flag from the staging tensor, each
      dropout reading its seed from its slot of it (``Context.seeds``),
      and every updated tensor written back into the tensor of ``wstate``
      it came from (``tree_assign``): parameters, optimizer slots and
      scalars, unit state.  Metrics stay on the device.

    Calling the step runs both, so the eager and the captured step run the
    same code, and a captured step draws a new mask every step.  The next
    step's host part writes the staging tensor after this step's device
    part on the same stream, so a backward reads the seeds of the forward
    it differentiates.  ``root.common.train`` (sentinel, clip_norm) and
    the fault plan's ``nan_grad_at_step`` are read once, here, as the JAX
    package reads them at trace time."""

    kind = "train"

    def __init__(self, workflow: "Workflow", optimizer: Optimizer):
        from ..config import root
        from ..runtime.faults import get_plan
        self.workflow = workflow
        self.optimizer = optimizer
        self.sentinel = bool(root.common.train.get("sentinel", True))
        self.clip = float(root.common.train.get("clip_norm", 0.0) or 0.0)
        self.inject = frozenset(get_plan().nan_grad_at_step)
        #: units that draw a seed, in slot order after (lr, NaN flag)
        self.seeded = [u.name for u in workflow.all_units()
                       if u.draws_seed]
        #: units whose ``aux_loss`` state joins the training loss
        #: (veles_tpu/units/workflow.py:227-258)
        self.aux_units = [u for u in workflow.units
                          if getattr(u, "has_aux_loss", False)]
        self.staging: Optional[torch.Tensor] = None   # int32 (2 + seeds)
        self.scalars: Optional[torch.Tensor] = None   # float32 view of 0:2
        self.seeds: Dict[str, torch.Tensor] = {}      # name -> slot view

    def __call__(self, wstate, batch):
        sub = self.begin(wstate)
        return wstate, self.run(wstate, batch, sub)

    def begin(self, wstate):
        """The host part; returns the step's ``sub`` key."""
        step = int(wstate["step"])
        key, sub = split_state_key(wstate.get("key"))
        if self.seeded and sub is None:
            raise ValueError(
                f"unit {self.seeded[0]!r} draws its seed from the step key "
                "and the state has no key (wstate['key'])")
        vals = np.empty(2 + len(self.seeded), np.int32)
        vals[:2] = np.asarray([self.optimizer.schedule(step),
                               step in self.inject],
                              np.float32).view(np.int32)
        keyed = Context(key=sub)            # the units' own key chain
        vals[2:] = np.asarray([prng.bits32(keyed.unit_key(name))
                               for name in self.seeded],
                              np.uint32).view(np.int32)
        host = torch.from_numpy(vals)
        if self.staging is None:
            dev = (tree_leaves(wstate["params"])
                   or tree_leaves(wstate["state"]))[0].device
            self.staging = torch.zeros(len(vals), dtype=torch.int32,
                                       device=dev)
            self.scalars = self.staging[:2].view(torch.float32)
            self.seeds = {name: self.staging[2 + i:3 + i]
                          for i, name in enumerate(self.seeded)}
        if self.staging.is_cuda:
            self.staging.copy_(host.pin_memory(), non_blocking=True)
        else:
            self.staging.copy_(host)
        wstate["step"] = step + 1
        wstate["key"] = key
        return sub

    def run(self, wstate, batch, sub):
        """The device part: updates ``wstate``'s tensors in place and
        returns the step's metrics (device tensors)."""
        wf, ev = self.workflow, self.workflow.evaluator
        params = wstate["params"]
        ctx = Context(train=True, key=sub, seeds=self.seeds,
                      make_generator=functools.partial(
                          _step_generator, sub, params))
        if ev is None:
            return self._self_organizing(wstate, batch, ctx)
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            outputs, nstate = wf.forward(live, wstate["state"], batch, ctx)
            loss = outputs[ev.name]
            objective, auxes = with_aux_losses(loss, nstate,
                                               self.aux_units)
            leaves = tree_leaves(live)
            flat = iter(torch.autograd.grad(objective, leaves,
                                            allow_unused=True))
        # same leaf order as tree_leaves; an unused param gets zeros
        grads = tree_map(lambda p: _grad_or_zeros(next(flat), p), params)
        with torch.no_grad():
            outs = {k: (v.detach() if torch.is_tensor(v) else v)
                    for k, v in outputs.items()}
            mets = wf._metrics(params, wstate["state"], outs, ctx)
            mets.update(auxes)
            mets, ok = self.update(wstate, grads, loss.detach(), mets)
            state = self._self_update(params, {**wstate["state"], **nstate},
                                      outs, ctx)
            if ok is not None:
                state = {k: (tree_select(ok, v, wstate["state"][k])
                             if k in wstate["state"] else v)
                         for k, v in state.items()}
            tree_assign(wstate["state"], state)
        return mets

    def update(self, wstate, grads, loss, mets, norm=None):
        """``guarded_update`` (the anomaly skip, ``clip_norm``; ``norm``:
        a sharded state's global norm) from this step's staged lr and
        NaN flag, written into ``wstate``'s params and optimizer state;
        returns the metrics (zeroed on a skipped step, with
        ``anomaly_steps`` and ``grad_norm``) and the ok flag (None
        without the sentinel)."""
        new_params, opt_state, ok, gnorm = guarded_update(
            self.optimizer, grads, wstate["opt_state"], wstate["params"],
            None, loss, clip_norm=self.clip, sentinel=self.sentinel,
            lr=self.scalars[0],
            inject_nan=(self.scalars[1] != 0) if self.inject else None,
            norm=norm)
        if ok is not None:
            # a skipped step adds nothing to the epoch sums
            mets = {k: torch.where(ok, v, torch.zeros_like(v))
                    for k, v in mets.items()}
            mets["anomaly_steps"] = (~ok).float()
        if gnorm is not None:
            mets["grad_norm"] = gnorm if ok is None else \
                torch.where(ok, gnorm, torch.zeros_like(gnorm))
        tree_assign(wstate["params"], new_params)
        tree_assign(wstate["opt_state"], opt_state)
        return mets, ok

    def _self_update(self, params, state, outputs, ctx):
        """Each self-updating unit's ``update_state`` on its inputs
        (veles_tpu/units/workflow.py:283-287)."""
        for u in self.workflow.units:
            if getattr(u, "self_updating", False):
                state[u.name] = u.update_state(
                    params.get(u.name, {}), state.get(u.name, {}),
                    [outputs[s] for s in u.inputs], ctx)
        return state

    def _self_organizing(self, wstate, batch, ctx):
        """A workflow with no evaluator (a SOM, an RBM): the forward and
        the self-updating units' state updates, no gradient."""
        with torch.no_grad():
            outputs, nstate = self.workflow.forward(
                wstate["params"], wstate["state"], batch, ctx)
            tree_assign(wstate["state"], self._self_update(
                wstate["params"], {**wstate["state"], **nstate}, outputs,
                ctx))
        return {}


class EvalStep:
    """The eval step: the evaluator's metrics of a forward under
    ``torch.inference_mode``; :meth:`begin` has no host part."""

    kind = "eval"

    def __init__(self, workflow: "Workflow"):
        self.workflow = workflow

    def __call__(self, wstate, batch):
        return self.run(wstate, batch, None)

    def begin(self, wstate):
        return None

    def run(self, wstate, batch, sub):
        wf = self.workflow
        ctx = Context(train=False)
        with torch.inference_mode():
            outputs, _ = wf.forward(wstate["params"], wstate["state"],
                                    batch, ctx)
            return wf._metrics(wstate["params"], wstate["state"], outputs,
                               ctx)


def sample_count(ev, side) -> torch.Tensor:
    """What the evaluator's masked mean divides by, before its clamp:
    the (broadcast) mask's sum, or the element count without a mask."""
    xs = [None] + list(side)
    m = ev._mask(xs) if hasattr(ev, "_mask") else None
    if m is not None:
        return m.float().sum()
    n = side[0].shape[0] if type(ev).__name__ == "EvaluatorMSE" \
        else side[0].numel()
    return torch.tensor(float(n), device=side[0].device)


class _Layout:
    """How a sharded step lays a batch out over the mesh: the axes the
    rows split over (``parallel.pipeline.row_layout``: ``data`` x
    ``fsdp`` where they divide them, and ``expert`` on a model with a MoE
    unit, which must divide them) and the copies of each row slice among
    the ranks that sum gradients (``replicas``: those of ``row_layout``
    times the ``seq`` and ``pipe`` ranks; the ``seq`` ranks each take one
    chunk of the sequence inside attention and see the whole output).
    ``model`` ranks compute the same rows and never sum: they are not
    counted.  A ``None`` layout means the plain step: no process group,
    or a whole state and only a data axis that does not divide the rows
    (the reference replicates such a batch and every rank computes it
    whole, with no exchange)."""

    def __init__(self, workflow, mesh, batch):
        from ..parallel.pipeline import row_layout
        from .parallel_nn import MoEFFN
        rows = {int(v.shape[0]) for v in batch.values()}
        moe = any(isinstance(u, MoEFFN) for u in workflow.all_units())
        self.axes, self.n_split, _ = row_layout(
            dict(mesh.shape), min(rows) if len(rows) == 1 else 1, moe=moe)
        #: the ranks a gradient sums over
        self.world = mesh.size // mesh.shape.get("model", 1)
        self.replicas = self.world // self.n_split

    @classmethod
    def of(cls, workflow, mesh, batch, sharded=False):
        if mesh.world_group is None:
            return None
        layout = cls(workflow, mesh, batch)
        busy = sharded or any(mesh.shape.get(a, 1) > 1 for a in (
            "seq", "expert", "fsdp", "model"))
        if not (layout.axes or busy) and mesh.shape.get("data", 1) > 1:
            return None
        return layout

    def local(self, mesh, batch):
        from ..parallel.distributed import place_batch
        return place_batch(batch, mesh, {k: (self.axes,) for k in batch})


def _reduce_metrics(mets, weight, state, params, grads=(), replicas=1,
                    world=1):
    """Sum a rank's metrics and gradients over the ranks that hold the
    same blocks (``state.reduce``: a ``parallel.fsdp.ShardedState``):
    ``loss`` weighted by ``weight`` (its share of the global masked
    mean), ``aux_*`` averaged over the ``world`` ranks that sum, the rest
    (counts, error sums) summed over the distinct row slices (divided by
    their ``replicas``); the gradients come back as this rank's blocks.
    Returns (metrics, gradients)."""
    keys = sorted(mets)
    vals = []
    for k in keys:
        v = mets[k].float()
        if k == "loss":
            v = v * weight
        elif k.startswith("aux_"):
            v = v / world
        elif replicas > 1:
            v = v / replicas
        vals.append(v)
    grads, vals = state.reduce(list(grads), vals, params)
    return dict(zip(keys, vals)), grads


class ShardedTrainStep(TrainStep):
    """The train step over the mesh (one process a rank; every rank's
    loader yields the same global batch), its state placed by ``rule``
    (``parallel/fsdp.py``: each rank stores its block of every leaf the
    rule splits, parameters and optimizer slots; :meth:`place` cuts a
    whole state to it).  The rows split over ``data`` x ``fsdp`` (and
    over ``expert`` on a model with a MoE unit: :class:`_Layout`); each
    rank gathers the parameters it uses, runs forward and backward on
    its rows with the mesh in its context, so attention on a ``seq``
    axis runs the ring over the seq group (each seq rank takes one chunk
    of the sequence and every rank sees the whole output), MoE on an
    ``expert`` axis exchanges its tokens over the expert group, and a
    unit whose weights the rule splits the megatron way over ``model``
    computes its part over the model group (``Context.tp``).  A rank's
    loss is weighted by its share of the global mask count over the
    copies of its rows, its aux losses by 1/the ranks that sum (the mean
    over the data shards, each MoE's aux being its expert group's); the
    gradients and metrics are summed over the ranks that hold the same
    blocks (the model ranks compute the same rows) and cut to this
    rank's blocks, and every rank applies the guarded update to its
    blocks with the norm over all of them.  A batch no axis divides runs
    whole on every rank, with no exchange, on a mesh with only a data
    axis and a whole state.  MoE routing and capacity are per rank (the
    reference's expert-parallel semantics).  Self-updating units do not
    train under a mesh."""

    capture_reason = "the sharded step all-reduces over the mesh"

    def __init__(self, workflow, optimizer, mesh, rule=None):
        from ..parallel.fsdp import ShardedState
        super().__init__(workflow, optimizer)
        self.mesh = mesh
        self.group = mesh.world_group
        self.state = ShardedState(workflow, mesh, rule)
        for u in workflow.units:
            if getattr(u, "self_updating", False):
                raise WorkflowError(
                    f"self-updating unit {u.name!r} does not train under a "
                    "mesh in the port (its state update would differ per "
                    "data rank)")

    def place(self, wstate):
        """This rank's blocks of a whole state (a new dict; tensors of
        the split leaves copied into their own memory)."""
        return self.state.shard_state(wstate)

    def run(self, wstate, batch, sub):
        wf, ev = self.workflow, self.workflow.evaluator
        if ev is None:
            raise WorkflowError("a sharded train step needs an evaluator")
        st = self.state
        layout = _Layout.of(wf, self.mesh, batch, st.sharded)
        if layout is None:
            return super().run(wstate, batch, sub)
        side = [batch[k] for k in ev.inputs[1:]]
        local = layout.local(self.mesh, batch)
        n = layout.world
        w = sample_count(ev, [local[k] for k in ev.inputs[1:]]) \
            / torch.clamp_min(sample_count(ev, side), 1.0) / layout.replicas
        params = wstate["params"]
        ctx = Context(train=True, key=sub, seeds=self.seeds, mesh=self.mesh,
                      tp=st.tp or None,
                      make_generator=functools.partial(
                          _step_generator, sub, params))
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                        st.use_params(params))
        with torch.enable_grad():
            outputs, nstate = wf.forward(live, wstate["state"], local, ctx)
            loss = outputs[ev.name]
            objective = loss * w
            for u in self.aux_units:
                objective = objective + (u.aux_weight / n) * \
                    nstate[u.name]["aux_loss"]
            leaves = tree_leaves(live)
            flat = iter(torch.autograd.grad(objective, leaves,
                                            allow_unused=True))
        grads = [_grad_or_zeros(next(flat), p) for p in leaves]
        with torch.no_grad():
            outs = {k: (v.detach() if torch.is_tensor(v) else v)
                    for k, v in outputs.items()}
            mets = wf._metrics(live, wstate["state"], outs, ctx)
            for u in self.aux_units:
                mets[f"aux_{u.name}"] = nstate[u.name]["aux_loss"].detach()
            mets, grads = _reduce_metrics(mets, w, st, params, grads,
                                          layout.replicas, n)
            it = iter(grads)
            grads = tree_map(lambda _: next(it), params)
            # a whole state's gradients are the same on every rank: its
            # norm is local; a split one's spans the ranks
            mets, ok = self.update(wstate, grads, mets["loss"], mets,
                                   norm=st.grad_norm if st.sharded
                                   else None)
            # the aux channel's state: the mean over the data shards
            state = {**wstate["state"], **{
                u.name: {"aux_loss": mets[f"aux_{u.name}"]}
                for u in self.aux_units}}
            if ok is not None:
                state = {k: (tree_select(ok, v, wstate["state"][k])
                             if k in wstate["state"] else v)
                         for k, v in state.items()}
            tree_assign(wstate["state"], state)
        return mets


class ShardedEvalStep(EvalStep):
    """The eval step over the mesh, on the state ``rule`` places: each
    rank gathers the parameters it uses and evaluates its rows of the
    global batch as the train step lays them out (attention on a ``seq``
    axis runs the ring, MoE on an ``expert`` axis exchanges its tokens,
    a megatron split computes over the model group, a pipeline stack
    runs the GPipe forward over the pipe group), and the metrics are
    summed over the ranks that hold the same blocks (``loss`` weighted
    into the global masked mean, counts summed over the distinct row
    slices)."""

    capture_reason = "the sharded eval step all-reduces over the mesh"

    def __init__(self, workflow, mesh, rule=None):
        from ..parallel.fsdp import ShardedState
        super().__init__(workflow)
        self.mesh = mesh
        self.group = mesh.world_group
        self.state = ShardedState(workflow, mesh, rule)

    def run(self, wstate, batch, sub):
        wf, ev = self.workflow, self.workflow.evaluator
        st = self.state
        layout = _Layout.of(wf, self.mesh, batch, st.sharded)
        local = batch if layout is None else layout.local(self.mesh, batch)
        ctx = Context(train=False, mesh=self.mesh, tp=st.tp or None)
        with torch.inference_mode():
            params = st.use_params(wstate["params"])
            outputs, _ = wf.forward(params, wstate["state"], local, ctx)
            mets = wf._metrics(params, wstate["state"], outputs, ctx)
            if layout is None or ev is None:
                return mets
            w = sample_count(ev, [local[k] for k in ev.inputs[1:]]) \
                / torch.clamp_min(sample_count(
                    ev, [batch[k] for k in ev.inputs[1:]]), 1.0) \
                / layout.replicas
            return _reduce_metrics(mets, w, st, params,
                                   replicas=layout.replicas,
                                   world=layout.world)[0]


def with_aux_losses(loss, nstate, aux_units):
    """The training objective ``loss + sum(aux_weight * aux_loss)``
    over the units with an aux loss, and their ``aux_<name>`` metrics
    (detached); the loss metric itself excludes them, as in the JAX
    step."""
    auxes = {}
    for u in aux_units:
        aux = nstate[u.name]["aux_loss"]
        loss = loss + u.aux_weight * aux
        auxes[f"aux_{u.name}"] = aux.detach()
    return loss, auxes


def split_state_key(key):
    """``key, sub = jax.random.split(wstate["key"])`` of the JAX train
    step (veles_tpu/units/workflow.py:239), on the host: the new state
    key as the uint32 array ``seed_key`` stores, and ``sub`` (the step's
    ``Context.key``) as a pair of ints.  A state without a key keeps
    none."""
    if key is None:
        return None, None
    new, sub = prng.split(np.asarray(key).ravel())
    return np.asarray(new, np.uint32), sub


def _step_generator(sub, params) -> Optional[torch.Generator]:
    """The train step's generator, seeded from its ``sub`` key, on the
    parameters' device; None for a state without a key."""
    if sub is None:
        return None
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else "cpu"
    return torch.Generator(device=dev).manual_seed(
        (int(sub[0]) << 32) | int(sub[1]))


def _grad_or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g
