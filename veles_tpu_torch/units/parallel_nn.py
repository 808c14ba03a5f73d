"""Parallelism-aware units (counterpart of veles_tpu/units/parallel_nn.py):
``MultiHeadAttention`` (:178-222), ``MoEFFN`` (:225-282) and
``PipelineStack`` (:284-578), with ``expert_rules`` (:581) and
``pipeline_rules`` (:596).

Attention covers RoPE, the residual stream, grouped-query attention and
the sliding window.  On a ``seq`` axis above 1 it is ring attention
(``parallel/ring_attention.py``) in the mode ``Context.collective_mode``
gives: ``"wrapper"`` (whole tensors on every rank: each takes its
sequence chunk, runs the ring and gathers the output) or ``"manual"``
(a pipeline schedule hands it this rank's chunk: the ring's per-rank
body, RoPE at the chunk's global positions).  On an ``expert`` axis
above 1, MoE is expert parallel (``parallel/moe.py``
``moe_apply_manual``) over this rank's tokens in either mode.  The JAX
package's build-time attention autotune (``prepare``) is not ported: on
the card the flash kernels are the attention.  A stack runs its stages
sequentially with no ``pipe`` axis
(or one of size 1): the same math, so the configs are portable; on a
``pipe`` axis its eval forward runs the GPipe schedule
(``parallel/pipeline.py``) and training the fused 1F1B schedule
(``parallel/pipeline_compile.py``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops import check_gqa_heads, rotary_embedding, smart_uniform_init
from .base import Context, Forward, Spec, dtype_of

class MultiHeadAttention(Forward):
    """Self-attention over (B, T, E) activations.  Under the megatron
    split over the model group (``wq``/``wk``/``wv`` by columns, ``wo``
    by rows: ``Context.tp``) on whole heads and whole GQA groups, each
    model rank runs attention on its H/model query and Hk/model kv heads
    and its partial output product is all-reduced; any other split is
    gathered on use."""

    def __init__(self, n_heads: int, head_dim: Optional[int] = None,
                 name=None, inputs=("@input",), *, causal: bool = True,
                 seq_axis: str = "seq", block_size: int = 512,
                 compute_dtype=None, window: Optional[int] = None,
                 n_kv_heads: Optional[int] = None, rope: bool = False,
                 residual: bool = False):
        super().__init__(name, inputs)
        self.n_heads = int(n_heads)
        self.head_dim = head_dim
        self.causal = causal
        self.seq_axis = seq_axis
        self.block_size = int(block_size)
        self.compute_dtype = dtype_of(compute_dtype)
        self.window = None if window is None else int(window)
        self.rope = bool(rope)
        self.residual = bool(residual)
        self.n_kv_heads = (self.n_heads if n_kv_heads is None
                           else int(n_kv_heads))
        check_gqa_heads(self.n_heads, self.n_kv_heads)

    def output_spec(self, in_specs: Sequence[Spec]) -> Spec:
        return in_specs[0]

    def init(self, generator, in_specs, device):
        E = in_specs[0].shape[-1]
        H, Hk = self.n_heads, self.n_kv_heads
        D = self.head_dim or E // H
        if self.head_dim is None and E % H:
            raise ValueError(f"model dim {E} not divisible by {H} heads")
        return {
            "wq": smart_uniform_init(generator, (E, H * D), E,
                                     device=device),
            "wk": smart_uniform_init(generator, (E, Hk * D), E,
                                     device=device),
            "wv": smart_uniform_init(generator, (E, Hk * D), E,
                                     device=device),
            "wo": smart_uniform_init(generator, (H * D, E), H * D,
                                     device=device),
        }, {}

    def tp_local(self, parts, n_model):
        from .nn import COLUMN, ROW
        whole = self.n_heads % n_model == 0 \
            and self.n_kv_heads % n_model == 0
        if whole and parts.get("wo") == ROW and all(
                parts.get(k) == COLUMN for k in ("wq", "wk", "wv")):
            return {"wq", "wk", "wv", "wo"}
        return set()

    def apply(self, params, state, xs, ctx: Context):
        if ctx.tp_split(self.name):
            from ..parallel import tensor_parallel as tp
            part, finish = self.tp_parts(params, xs[0], ctx)
            return finish(tp.reduce_from_model(part, ctx.mesh)), state
        x = xs[0]
        dt = self.compute_dtype or x.dtype
        xq = x.to(dt)
        o = self._heads(params, xq, xq, self.n_heads, self.n_kv_heads, ctx)
        y = o.reshape(x.shape[0], x.shape[1], -1) @ params["wo"].to(dt)
        if self.residual:
            y = y + xq
        return y.to(x.dtype), state

    def tp_parts(self, params, x, ctx):
        """This model rank's partial output product (float32: the
        compute dtype's operands, accumulated in float32 as its GEMM
        does) over its H/model query and Hk/model kv heads, and the
        ``finish`` of the all-reduced sum (``parallel.tensor_parallel``):
        rounded to the compute dtype, the residual added."""
        from ..parallel import tensor_parallel as tp
        dt = self.compute_dtype or x.dtype
        xq = x.to(dt)
        n = ctx.mesh.shape["model"]
        o = self._heads(params, xq, tp.copy_to_model(xq, ctx.mesh),
                        self.n_heads // n, self.n_kv_heads // n, ctx)
        part = o.reshape(x.shape[0], x.shape[1], -1).float() \
            @ params["wo"].to(dt).float()

        def finish(y):
            y = y.to(dt)
            if self.residual:
                y = y + xq
            return y.to(x.dtype)
        return part, finish

    def _heads(self, params, xq, xin, H, Hk, ctx):
        """Attention over ``H`` query and ``Hk`` kv heads of ``xin``'s
        projections (``xq``'s shape and dtype): (B, T, H, D)."""
        from ..parallel.ring_attention import (_ring_attention_local,
                                               blockwise_attention,
                                               ring_attention)
        mode = ctx.collective_mode(self.seq_axis)
        B, T, E = xq.shape
        dt = xq.dtype

        def proj(w, nh):
            return (xin @ w.to(dt)).reshape(B, T, nh, -1)

        q = proj(params["wq"], H)
        k = proj(params["wk"], Hk)
        v = proj(params["wv"], Hk)
        if self.rope:
            # manual mode: x is this rank's chunk of the sequence, at
            # global positions from rank * T on
            off = (ctx.mesh.axis_index(self.seq_axis) * T
                   if mode == "manual" else 0)
            q = rotary_embedding(q, offset=off)
            k = rotary_embedding(k, offset=off)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if mode == "manual":
            o = _ring_attention_local(q, k, v, mesh=ctx.mesh,
                                      axis_name=self.seq_axis,
                                      causal=self.causal,
                                      window=self.window)
        elif mode == "wrapper":
            o = ring_attention(q, k, v, ctx.mesh, axis_name=self.seq_axis,
                               causal=self.causal, window=self.window)
        else:
            o = blockwise_attention(q, k, v, block_size=self.block_size,
                                    causal=self.causal, window=self.window)
        return o


class MoEFFN(Forward):
    """Mixture-of-experts FFN over (B, T, E) or (N, E) activations
    (veles_tpu/units/parallel_nn.py:225-282).  On an ``expert`` axis
    above 1 (either collective mode) the layer is expert parallel over
    this rank's tokens: the step splits the tokens over the axis and the
    all-to-all dispatch sends each to the rank owning its expert.  The
    Switch/GShard load-balance loss rides the unit-state channel
    (``aux_loss``); the train step adds ``aux_weight * aux_loss`` to the
    training loss and reports it as ``aux_<name>``."""

    has_aux_loss = True

    def __init__(self, n_experts: int, d_hidden: int, name=None,
                 inputs=("@input",), *, top_k: int = 2,
                 capacity_factor: float = 1.25, aux_weight: float = 0.01,
                 dispatch_mode: str = "sort", expert_axis: str = "expert"):
        from ..parallel.moe import DISPATCH_MODES
        super().__init__(name, inputs)
        self.n_experts = int(n_experts)
        self.d_hidden = int(d_hidden)
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.aux_weight = float(aux_weight)
        if dispatch_mode not in DISPATCH_MODES:
            raise ValueError(f"MoEFFN {self.name!r}: unknown dispatch_mode "
                             f"{dispatch_mode!r}")
        self.dispatch_mode = dispatch_mode
        self.expert_axis = expert_axis

    def output_spec(self, in_specs):
        return in_specs[0]

    def init(self, generator, in_specs, device):
        from ..parallel.moe import init_moe_params
        E = in_specs[0].shape[-1]
        params = init_moe_params(generator, self.n_experts, E,
                                 self.d_hidden, device=device)
        return params, {"aux_loss": torch.zeros((), dtype=torch.float32,
                                                device=device)}

    def apply(self, params, state, xs, ctx: Context, *,
              capacity_factor=None):
        """``capacity_factor`` overrides the unit's (decode runs dropless
        at ``n_experts``, veles_tpu/runtime/generate.py:494-506)."""
        from ..parallel.moe import moe_apply, moe_apply_manual
        x = xs[0]
        flat = x.reshape(-1, x.shape[-1])
        cf = self.capacity_factor if capacity_factor is None \
            else float(capacity_factor)
        if ctx.collective_mode(self.expert_axis) != "none":
            y, aux = moe_apply_manual(params, flat, mesh=ctx.mesh,
                                      axis_name=self.expert_axis,
                                      top_k=self.top_k, capacity_factor=cf)
        else:
            y, aux = moe_apply(params, flat, top_k=self.top_k,
                               capacity_factor=cf,
                               dispatch_mode=self.dispatch_mode)
        return y.reshape(x.shape), {"aux_loss": aux.float()}


class PipelineStack(Forward):
    """A stack of S stages pipelined over the ``pipe`` mesh axis
    (veles_tpu/units/parallel_nn.py:284-578).

    * **Homogeneous**: ``PipelineStack(n_stages, d_hidden)`` — S residual
      MLP blocks ``x + relu(x @ w1) @ w2``, params stage-stacked
      ``stage_w1 (S, E, H)``, ``stage_w2 (S, H, E)``.
    * **Config stages**: ``PipelineStack(stages=[[cfg, ...], ...])`` — each
      stage a layer-config sublist built through
      ``models.standard.LAYER_TYPES``; params ``{"s<i>": {unit: {...}}}``.
      Stages may differ, and each must preserve the activation's shape
      and dtype (that is what crosses the pipe ranks).

    Without a ``pipe`` axis > 1 the stages run one after the other.  Unit
    aux losses (MoE) sum into the stack's own ``aux_loss`` (weights
    applied per sub-unit, so the stack's weight is 1)."""

    def __init__(self, n_stages: Optional[int] = None,
                 d_hidden: Optional[int] = None, name=None,
                 inputs=("@input",), *, pipe_axis: str = "pipe",
                 n_microbatches: Optional[int] = None,
                 stages: Optional[Sequence[Sequence[dict]]] = None,
                 compute_dtype=None):
        super().__init__(name, inputs)
        self.pipe_axis = pipe_axis
        self.n_microbatches = n_microbatches
        self.stages_cfg = stages
        self.aux_weight = 1.0
        if stages is not None:
            self.n_stages = len(stages)
            self.d_hidden = None
            self._stage_units = [
                self._build_stage_units(i, cfg, compute_dtype)
                for i, cfg in enumerate(stages)]
            subs = self.sub_units()
            self.has_aux_loss = any(
                getattr(u, "has_aux_loss", False) for u in subs)
            self.stochastic = any(
                getattr(u, "stochastic", False) for u in subs)
        else:
            if n_stages is None or d_hidden is None:
                raise ValueError(
                    "PipelineStack needs (n_stages, d_hidden) or stages=")
            self.n_stages = int(n_stages)
            self.d_hidden = int(d_hidden)
            self._stage_units = None
            self.has_aux_loss = False
            self.stochastic = False

    def sub_units(self) -> List:
        """The stage sub-units in stage order (empty for the homogeneous
        form)."""
        return [u for us in (self._stage_units or []) for u in us]

    @staticmethod
    def _build_stage_units(i: int, cfg: Sequence[dict], compute_dtype):
        from ..models.standard import (COMPUTE_DTYPE_TYPES, LAYER_TYPES,
                                       PENDING_TYPES)
        units = []
        for j, spec in enumerate(cfg):
            spec = dict(spec)
            ltype = spec.pop("type")
            lname = spec.pop("name", f"s{i}u{j}_{ltype}")
            # both schedules rematerialize stage bodies already: a
            # per-sub-unit remat flag is accepted and dropped
            spec.pop("remat", None)
            if "hyperparams" in spec:
                raise ValueError(
                    f"per-layer 'hyperparams' on {lname!r} are not "
                    "supported inside pipeline stages (the stack is one "
                    "optimizer unit); set them on the stack's unit name")
            if ltype not in LAYER_TYPES:
                if ltype in PENDING_TYPES:
                    raise NotImplementedError(
                        f"layer {lname!r}: type {ltype!r} is not ported "
                        f"yet; it comes with ROADMAP.md "
                        f"{PENDING_TYPES[ltype]}")
                raise KeyError(f"unknown layer type {ltype!r}")
            if compute_dtype is not None and ltype.startswith(
                    COMPUTE_DTYPE_TYPES):
                spec.setdefault("compute_dtype", compute_dtype)
            units.append(LAYER_TYPES[ltype](name=lname, inputs=("@x",),
                                            **spec))
        return units

    def _thread_stage_specs(self, spec, visit=None):
        outs = []
        for units in self._stage_units:
            s = spec
            for u in units:
                if visit is not None:
                    visit(u, s)
                s = u.output_spec([s])
            outs.append(s)
        return outs

    def output_spec(self, in_specs):
        if self._stage_units is not None:
            spec = in_specs[0]
            for i, s in enumerate(self._thread_stage_specs(spec)):
                if (tuple(s.shape), s.dtype) != (tuple(spec.shape),
                                                 spec.dtype):
                    raise ValueError(
                        f"pipeline stage {i} must preserve the activation "
                        f"spec {tuple(spec.shape)}/{spec.dtype} (it rides "
                        f"the ring), got {tuple(s.shape)}/{s.dtype}")
        return in_specs[0]

    def init(self, generator, in_specs, device):
        if self._stage_units is not None:
            params = {}
            for i, units in enumerate(self._stage_units):
                spec, sp = in_specs[0], {}
                for u in units:
                    p, s = u.init(generator, [spec], device)
                    # an aux channel is a per-step output riding the
                    # stack's own aux; any other stage state is refused
                    if s and set(s) - {"aux_loss"}:
                        raise ValueError(
                            f"stateful unit {u.name!r} inside a pipeline "
                            "stage is unsupported (stage state does not "
                            "ride the ring)")
                    if p:
                        sp[u.name] = p
                    spec = u.output_spec([spec])
                params[f"s{i}"] = sp
            state = ({"aux_loss": torch.zeros((), dtype=torch.float32,
                                              device=device)}
                     if self.has_aux_loss else {})
            return params, state
        E, H = in_specs[0].shape[-1], self.d_hidden
        w1 = [smart_uniform_init(generator, (E, H), E, device=device)
              for _ in range(self.n_stages)]
        w2 = [smart_uniform_init(generator, (H, E), H, device=device)
              for _ in range(self.n_stages)]
        return {"stage_w1": torch.stack(w1), "stage_w2": torch.stack(w2)}, {}

    @staticmethod
    def _stage_fn(p, x):
        return x + torch.relu(x @ p["w1"]) @ p["w2"]

    # -- per-stage access (the fused schedule's contract) -----------------
    def stage_param_slice(self, params, i: int):
        """Stage i's params, as ``stage_apply(i, ...)`` takes them."""
        if self._stage_units is not None:
            return params[f"s{i}"]
        return {"w1": params["stage_w1"][i], "w2": params["stage_w2"][i]}

    def restack_stage_grads(self, glist):
        """Inverse of :meth:`stage_param_slice` over per-stage grads."""
        if self._stage_units is not None:
            return {f"s{i}": g for i, g in enumerate(glist)}
        return {"stage_w1": torch.stack([g["w1"] for g in glist]),
                "stage_w2": torch.stack([g["w2"] for g in glist])}

    def stage_apply(self, i: int, p, x, ctx: Context):
        return self.stage_apply_aux(i, p, x, ctx)[0]

    def stage_apply_aux(self, i: int, p, x, ctx: Context):
        """Stage i on one activation block -> ``(y, aux)``, ``aux`` the
        weighted sum of the stage's unit aux losses."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self._stage_units is not None:
            for u in self._stage_units[i]:
                x, st = u.apply(p.get(u.name, {}), {}, [x], ctx)
                if getattr(u, "has_aux_loss", False):
                    aux = aux + u.aux_weight * st["aux_loss"]
            return x, aux
        return self._stage_fn(p, x), aux

    def apply(self, params, state, xs, ctx: Context):
        x = xs[0]
        S = ctx.axis_size(self.pipe_axis)
        n_mb = self.n_microbatches or S
        if S > 1 and S != self.n_stages:
            if self.n_stages % S == 0 and not ctx.train:
                # an interleaved stack (v*S stages) evaluates in the
                # numerically identical sequential form, as the
                # reference does (:500-509)
                S = 1
            else:
                raise ValueError(
                    f"PipelineStack has {self.n_stages} stages but the "
                    f"{self.pipe_axis!r} mesh axis is {S}"
                    + (" (interleaved stacks train via "
                       "pipeline_microbatches + pipeline_interleave)"
                       if self.n_stages % S == 0 else ""))
        if S > 1 and ctx.train:
            raise ValueError(
                f"PipelineStack {self.name!r}: on a {self.pipe_axis!r} axis "
                f"of {S} a stack trains on the fused 1F1B schedule "
                "(Workflow.make_pipeline_train_step), not through this "
                "forward")
        if S > 1 and x.shape[0] % n_mb == 0:
            # the GPipe forward; an indivisible eval batch runs the same
            # math sequentially below (:507-531)
            from ..parallel.pipeline import pipeline_apply
            B = x.shape[0]
            xm = x.reshape((n_mb, B // n_mb) + tuple(x.shape[1:]))
            ictx = Context(train=False)
            fns = [(lambda p, h, _i=i: self.stage_apply_aux(_i, p, h, ictx))
                   for i in range(self.n_stages)]
            plist = [self.stage_param_slice(params, i)
                     for i in range(self.n_stages)]
            y, aux = pipeline_apply(fns, plist, xm, ctx.mesh,
                                    axis_name=self.pipe_axis)
            return y.reshape(x.shape), (
                {"aux_loss": aux} if self.has_aux_loss else state)
        if self._stage_units is not None:
            aux_t = torch.zeros((), dtype=torch.float32, device=x.device)
            for i in range(self.n_stages):
                x, a = self.stage_apply_aux(i, params[f"s{i}"], x, ctx)
                aux_t = aux_t + a
            return x, ({"aux_loss": aux_t} if self.has_aux_loss else state)
        for i in range(self.n_stages):
            x = self._stage_fn(self.stage_param_slice(params, i), x)
        return x, state


def expert_rules(axis: str = "expert"):
    """Placement rule for MoEFFN params (veles_tpu/units/parallel_nn.py:
    581-593): a 3-dim ``w1``/``w2`` bank splits its expert dim over
    ``axis``, the router (and everything else) is replicated.  A rank
    stores its experts' block (``parallel/fsdp.py``), gathered on use."""

    def rule(path, shape):
        if len(path) >= 2 and path[-1] in ("w1", "w2") and len(shape) == 3:
            return (axis,)
        return ()

    return rule


def pipeline_rules(axis: str = "pipe"):
    """Placement rule for PipelineStack params
    (veles_tpu/units/parallel_nn.py:596-605): a ``stage_*`` leaf splits
    its leading stage axis over ``axis``, everything else is replicated.
    A rule maps ``(path, shape)`` to a partition tuple (``()``:
    replicated); ``parallel.mesh.state_shardings`` applies it and
    ``parallel/fsdp.py`` stores each rank's block."""

    def rule(path, shape):
        if path and path[-1].startswith("stage_"):
            return (axis,) + (None,) * (len(shape) - 1)
        return ()

    return rule
