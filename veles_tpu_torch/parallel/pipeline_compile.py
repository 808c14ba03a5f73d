"""A workflow trained on the fused 1F1B schedule (counterpart of
veles_tpu/parallel/pipeline_compile.py: ``PipelinePlan`` :81-577,
``build_pipeline_step`` :579).

The model is the pipeline: the forward units before the
``PipelineStack`` (embedding, normalizers) fold into stage 0, the stack's
stages map onto the pipe ranks, and the units after it (``seq_last``,
the head) with the evaluator's loss fold into the last stage.  Of the
reference's three transports only the activation ring crosses ranks
here, carrying the stack's (mb, T, E) hidden state in its own dtype
(bf16 stays bf16): every rank holds the global batch, so stage 0 reads
its input microbatch and the last stage its labels where they are, and
the logits never leave the last stage.

The loss is the global masked mean the plain train step computes: each
microbatch contributes its masked loss times its mask count over the
global batch's count (or its mean over n_mb times the data ranks without
a mask), so a ragged tail batch trains as it does without a pipeline.
Dropout in a stage draws from ``fold_in(step_key, m)`` for microbatch
``m`` (and, on the interleaved schedule, ``fold_in`` of the logical stage
too, with stage 0's unit names, as the reference's shared template);
MoE aux losses join through the schedule's aux channel.  Unit state
(normalizer statistics) is read, never written.

The ``seq`` and ``expert`` axes run inside the stages (:192-231,
:625-674).  On a ``seq`` axis above 1 every transport carries this rank's
chunk of the sequence: stage 0 reads its chunk of the input, the ring
carries (mb, T/n, E) and the loss takes its chunk of the per-position
labels, reduced over the seq ranks like a batch axis (so the masked
mean of a ragged batch stays the global one); attention runs the ring's
per-rank body (``Context.manual_axes``), RoPE at global positions, and a
dropout key folds in the seq rank too.  The units folded into the edge
stages must then be positionwise (``seq_last`` is refused).  On a model
with a MoE unit an ``expert`` axis splits the microbatch rows like a
data axis (it must divide them: ``pipeline.row_layout``), and the MoE
units exchange tokens over it; on a model without one the axis stays
idle (replicas).  The rows split over ``data`` x ``fsdp`` (:579's
``batch_axes``); a rule places the state (``parallel/fsdp.py``: the
stages' parameters gathered at the step's entry, the gradients summed
over the ranks that hold the same blocks and cut to this rank's), and
``model`` ranks compute the same rows.  With either axis in the stages the
plan takes the reference's shared stage template (stage 0's units with
each stage's params, the key folded with the stage), which needs
structurally identical stages, and refuses a MoE unit in an edge stage
under expert parallelism.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .. import prng
from ..ops.optimizers import tree_leaves, tree_map
from ..units.base import Context, Spec
from ..units.workflow import sample_count
from .pipeline import row_layout, run_schedule, shard_microbatches


class PipelinePlan:
    """Static plan: the unit partition, the transports' specs, the axes
    the stages run collectives over and the stage closures (:81-577)."""

    def __init__(self, wf, mesh, n_microbatches: int, *,
                 axis_name: str = "pipe", seq_axis: str = "seq",
                 interleave: int = 1):
        from ..units.parallel_nn import PipelineStack
        from ..units.workflow import WorkflowError
        if wf.evaluator is None:
            raise WorkflowError("pipeline training needs an evaluator")
        order = [u for u in wf.topo_order()
                 if not getattr(u, "is_evaluator", False)]
        prev = "@input"
        for u in order:
            if tuple(u.inputs) != (prev,):
                raise WorkflowError(
                    f"1F1B pipeline training requires a linear unit chain; "
                    f"{u.name!r} consumes {list(u.inputs)}, expected "
                    f"[{prev!r}]")
            prev = u.name
        ev = wf.evaluator
        if ev.inputs[0] != prev:
            raise WorkflowError(
                f"evaluator must consume the last forward unit {prev!r}, "
                f"got {ev.inputs[0]!r}")
        for src in ev.inputs[1:]:
            if not src.startswith("@"):
                raise WorkflowError(
                    f"evaluator side input {src!r} must be a batch key")
        for u in order:
            if getattr(u, "self_updating", False):
                raise WorkflowError(
                    f"self-updating unit {u.name!r} is not supported in "
                    "the fused 1F1B step (its state updates do not ride "
                    "the pipeline ring)")
        stacks = [u for u in order if isinstance(u, PipelineStack)]
        if len(stacks) != 1:
            raise WorkflowError(
                f"1F1B pipeline training requires exactly one "
                f"PipelineStack unit, found {len(stacks)}")
        self.stack = stacks[0]
        S = mesh.shape[axis_name]
        self.v = int(interleave)
        self.L = S * self.v
        if self.stack.n_stages != self.L:
            raise WorkflowError(
                f"PipelineStack has {self.stack.n_stages} stages but the "
                f"{axis_name!r} mesh axis is {S}"
                + (f" with interleave {self.v} (needs {self.L} stages, "
                   "one chunk lane per virtual stage)"
                   if self.v > 1 else ""))
        si = order.index(self.stack)
        self.pre: List = order[:si]
        self.post: List = order[si + 1:]
        self.evaluator = ev
        self.axis_name = axis_name
        self.S = S
        specs: Dict[str, Spec] = wf.specs
        in_spec = specs["@input"]
        self.batch_size = int(in_spec.shape[0])
        self.n_mb = int(n_microbatches)
        if self.batch_size % self.n_mb:
            raise WorkflowError(
                f"batch {self.batch_size} not divisible into "
                f"{self.n_mb} microbatches")
        if self.n_mb % S:
            raise WorkflowError(
                f"n_microbatches={self.n_mb} must be a multiple of the "
                f"pipeline depth {S}")
        self.mb = self.batch_size // self.n_mb
        self.in_shape = tuple(in_spec.shape[1:])
        act_spec = specs[self.stack.inputs[0]]
        self.act_shape = tuple(act_spec.shape[1:])
        self.act_dtype = act_spec.dtype
        y_spec = specs[order[-1].name]
        self.y_shape = tuple(y_spec.shape[1:])
        self.y_dtype = y_spec.dtype
        self.label_keys = tuple(ev.inputs[1:])
        self.seq_axis = seq_axis
        self.seq_shards = int(mesh.shape.get(seq_axis, 1))
        if self.seq_shards > 1:
            self._check_seq(specs)
        # microbatch rows split over data (and, on a model with a MoE
        # unit, expert: its units exchange tokens there; :625-641)
        from ..units.parallel_nn import MoEFFN
        has_moe = any(isinstance(u, MoEFFN) for u in
                      self.pre + self.stack.sub_units() + self.post)
        self.batch_axes, self.n_split, self.replicas = row_layout(
            dict(mesh.shape), self.mb, moe=has_moe)
        # the axes stage bodies run collectives over (:642-650)
        self.manual = ((seq_axis,) if self.seq_shards > 1 else ()) + (
            ("expert",) if "expert" in self.batch_axes else ())
        self.shared = bool(self.manual) or self.v > 1
        if self.shared and not self.uniform_stages:
            raise WorkflowError(
                "seq/expert parallelism inside the fused 1F1B stages and "
                "the interleaved schedule require structurally IDENTICAL "
                "pipeline stages (every stage runs the shared stage "
                "template); make every stage the same block, or drop the "
                "seq/expert mesh axes and the interleave to use the "
                "heterogeneous-stage dispatch")
        if "expert" in self.manual:
            for u in self.pre + self.post:
                if isinstance(u, MoEFFN):
                    raise WorkflowError(
                        f"MoE unit {u.name!r} cannot fold into a pipeline "
                        "edge under expert parallelism; put it in the "
                        "pipeline stages")

    def _check_seq(self, specs) -> None:
        """Under sequence parallelism every transport needs a leading
        sequence dim the seq axis divides, and the units folded into the
        edges must keep each position to itself (:196-224)."""
        from ..units.parallel_nn import MultiHeadAttention
        from ..units.workflow import WorkflowError
        n_sp = self.seq_shards
        for what, shape in (("input", self.in_shape),
                            ("activation", self.act_shape),
                            ("output", self.y_shape)):
            if not shape or shape[0] % n_sp:
                raise WorkflowError(
                    f"sequence-parallel pipeline: the {what} shape {shape} "
                    "must have a leading sequence dim divisible by the "
                    f"{self.seq_axis!r} axis ({n_sp})")
        for u in self.pre + self.post:
            ispec = specs[u.inputs[0]]
            ospec = specs[u.name]
            t_in = ispec.shape[1] if len(ispec.shape) > 1 else None
            t_out = ospec.shape[1] if len(ospec.shape) > 1 else None
            if (isinstance(u, MultiHeadAttention) or t_in != t_out
                    or len(ospec.shape) < len(ispec.shape)):
                raise WorkflowError(
                    f"unit {u.name!r} is not positionwise; under sequence "
                    f"parallelism ({self.seq_axis}={n_sp}) folded pre/post "
                    "units must preserve the sequence dim (use a "
                    "per-position head, and put attention inside the "
                    "pipeline stages)")

    def _local(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """This rank's chunk of a transported per-sample shape: the
        leading (sequence) dim divides over the seq axis (:226-231)."""
        if self.seq_shards <= 1 or not shape:
            return tuple(shape)
        return (shape[0] // self.seq_shards,) + tuple(shape[1:])

    @property
    def uniform_stages(self) -> bool:
        """Every stage has the same unit configs (names aside)."""
        cfgs = self.stack.stages_cfg
        if cfgs is None:
            return True

        def norm(stage):
            return tuple(tuple(sorted((k, repr(v)) for k, v in spec.items()
                                      if k != "name")) for spec in stage)
        return len({norm(s) for s in cfgs}) == 1

    # -- closures ------------------------------------------------------------
    @staticmethod
    def _apply_acc(u, p, x, ictx, aux, states):
        """One unit, its aux loss added; unit state is read-only."""
        from ..units.workflow import WorkflowError
        st_in = states.get(u.name, {})
        y, st = u.apply(p.get(u.name, {}), st_in, [x], ictx)
        if getattr(u, "has_aux_loss", False):
            aux = aux + u.aux_weight * st["aux_loss"]
        mutated = [k for k in set(st or {}) | set(st_in)
                   if k != "aux_loss" and (st or {}).get(k) is not
                   st_in.get(k)]
        if mutated:
            raise WorkflowError(
                f"unit {u.name!r} mutates its state ({sorted(mutated)}) "
                "in apply(); the fused 1F1B step treats unit state as "
                "read-only statistics")
        return y, aux

    def stage_fn(self, params, states, inputs, mesh):
        """``fwd(l, m, h, key) -> (ring, out, aux)`` over the live
        ``params`` (the whole tree), read-only ``states`` and this rank's
        input microbatches ``inputs`` (n_mb, mb_local, ...), on this
        rank's ``mesh``."""
        stack, L = self.stack, self.L
        shared = self.shared
        seq_rank = (mesh.axis_index(self.seq_axis)
                    if self.seq_shards > 1 else None)

        def template(l, x, ictx):
            # the shared template: stage 0's units with stage l's params
            sp = stack.stage_param_slice(params[stack.name], l)
            if stack._stage_units is None:
                return stack._stage_fn(sp, x), torch.zeros(
                    (), dtype=torch.float32, device=x.device)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for u0, ul in zip(stack._stage_units[0], stack._stage_units[l]):
                x, st = u0.apply(sp.get(ul.name, {}), {}, [x], ictx)
                if getattr(u0, "has_aux_loss", False):
                    aux = aux + u0.aux_weight * st["aux_loss"]
            return x, aux

        def fwd(l, m, h, key):
            if shared:
                key = prng.fold_in(key, l)
            if seq_rank is not None:
                key = prng.fold_in(key, seq_rank)
            ictx = Context(train=True, key=key, mesh=mesh,
                           manual_axes=self.manual)
            aux = torch.zeros((), dtype=torch.float32,
                              device=inputs.device)
            if l == 0:
                x = inputs[m]
                for u in self.pre:
                    x, aux = self._apply_acc(u, params, x, ictx, aux,
                                             states)
                x = x.to(self.act_dtype)
            else:
                x = h
            if shared:
                x, a = template(l, x, ictx)
            else:
                x, a = stack.stage_apply_aux(
                    l, stack.stage_param_slice(params[stack.name], l), x,
                    ictx)
            aux = aux + a
            ring = x.to(self.act_dtype)
            if l < L - 1:
                return ring, None, aux
            for u in self.post:
                x, aux = self._apply_acc(u, params, x, ictx, aux, states)
            return ring, x.to(self.y_dtype), aux

        return fwd


class PipelineTrainStep:
    """The fused 1F1B train step (``build_pipeline_step``, :579-767) in
    the port's two-part step contract (``units.workflow.TrainStep``):
    ``begin`` splits the key and stages the lr on the host; ``run`` runs
    this rank's part of the schedule, sums the gradients, the loss and
    the aux over the world in one all-reduce, and applies the guarded
    update on every rank alike.  Metrics: ``loss`` (the global masked
    mean, aux excluded), ``aux`` and ``n_samples``, as the reference's."""

    kind = "train"
    #: the train step a CUDA graph cannot hold (it talks to other ranks)
    capture_reason = "the fused pipeline step exchanges with other ranks"

    def __init__(self, workflow, optimizer, mesh, *, n_microbatches: int,
                 interleave: int = 1, axis_name: str = "pipe", rule=None):
        from ..units.workflow import TrainStep
        from .fsdp import ShardedState
        self.workflow = workflow
        self.mesh = mesh
        self.plan = PipelinePlan(workflow, mesh, n_microbatches,
                                 axis_name=axis_name,
                                 interleave=interleave)
        self._host = TrainStep(workflow, optimizer)
        self.optimizer = optimizer
        # the stages use whole parameters: every split is gathered on use
        self.state = ShardedState(workflow, mesh, rule,
                                  tensor_parallel=False)

    def place(self, wstate):
        """This rank's blocks of a whole state (``ShardedTrainStep.
        place``)."""
        return self.state.shard_state(wstate)

    def __call__(self, wstate, batch):
        sub = self.begin(wstate)
        return wstate, self.run(wstate, batch, sub)

    def begin(self, wstate):
        return self._host.begin(wstate)

    def run(self, wstate, batch, sub):
        plan, mesh, ev = self.plan, self.mesh, self.plan.evaluator
        params = wstate["params"]
        n_mb, n_sp = plan.n_mb, plan.seq_shards
        t_glob = plan.y_shape[0] if plan.y_shape else None

        def local(t, seq):
            # (B, ...) -> this rank's (n_mb, mb_local, ...), and with
            # ``seq`` its chunk of the sample's leading (sequence) dim
            return shard_microbatches(
                t.reshape((n_mb, plan.mb) + tuple(t.shape[1:])), mesh,
                plan.batch_axes, (plan.seq_axis,) if seq else ())

        side_g = [batch[k] for k in plan.label_keys]
        masked = len(plan.label_keys) >= 2
        if masked:
            norm = torch.clamp_min(sample_count(ev, side_g), 1.0)
        inputs = local(batch["@input"], n_sp > 1)
        # per-position labels take their chunk too (:390-410)
        side = [local(t, n_sp > 1 and t.dim() > 1 and t.shape[1] == t_glob)
                for t in side_g]
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                        self.state.use_params(params))
        fwd = plan.stage_fn(live, wstate["state"], inputs, mesh)
        lctx = Context(train=True)
        # the sum over the ranks that hold the same blocks adds the
        # shares of the row-splitting ranks and the seq ranks (or the
        # copies of a replicated microbatch: /replicas; model ranks
        # compute the same rows and do not sum)
        scale = 1.0 / (n_mb * plan.n_split * n_sp * plan.replicas)

        def loss(out, m):
            sm = [t[m] for t in side]
            val, _ = ev.apply({}, {}, [out] + sm, lctx)
            if masked:
                return val * sample_count(ev, sm) / (norm * plan.replicas)
            return val * scale

        d = mesh.axis_index(plan.axis_name)
        loss_sum, aux_sum = run_schedule(
            lambda l, m, h: fwd(l, m, h, prng.fold_in(sub, m)), loss,
            n_mb=n_mb, S=plan.S, v=plan.v, d=d,
            ranks=mesh.axis_ranks(plan.axis_name),
            act_shape=(inputs.shape[1],) + plan._local(plan.act_shape),
            act_dtype=plan.act_dtype, aux_scale=scale,
            device=inputs.device)
        gl = [torch.zeros_like(t) if t.grad is None else t.grad
              for t in tree_leaves(live)]
        flat, (loss_t, aux_t) = self.state.reduce(gl, [loss_sum, aux_sum],
                                                  params)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params)
        with torch.no_grad():
            mets = {"loss": loss_t, "aux": aux_t,
                    "n_samples": torch.full((), float(plan.batch_size),
                                            device=loss_t.device)}
            st = self.state
            return self._host.update(wstate, grads, loss_t, mets,
                                     norm=st.grad_norm if st.sharded
                                     else None)[0]


def build_pipeline_step(wf, optimizer, mesh, *, n_microbatches: int,
                        axis_name: str = "pipe", interleave: int = 1,
                        rule=None):
    """The fused step of ``Workflow.make_pipeline_train_step``; ``rule``
    places its state (:579; e.g. stage arrays over ``("pipe", None,
    "fsdp")``)."""
    step = PipelineTrainStep(wf, optimizer, mesh,
                             n_microbatches=n_microbatches,
                             interleave=interleave, axis_name=axis_name,
                             rule=rule)
    plan = step.plan
    wf.info("1F1B plan: %d stages (pipe=%d x v=%d), %d microbatches of "
            "%d, rows split over %s (%d), seq shards %d, in-stage axes %s",
            plan.L, plan.S, plan.v, plan.n_mb, plan.mb,
            list(plan.batch_axes), plan.n_split, plan.seq_shards,
            list(plan.manual))
    return step

