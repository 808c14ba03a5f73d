"""StandardWorkflow: build a workflow and its optimizer from a config
(counterpart of veles_tpu/models/standard.py).

``LAYER_TYPES`` holds every layer type of the JAX package's registry; a
type of a later slice would stand in ``PENDING_TYPES`` and fail with an
error that names it.  A layer's
``hyperparams`` key lands in the optimizer's per-unit table.
"""

from __future__ import annotations

import inspect
from typing import Dict, Optional, Sequence

from ..ops.optimizers import HyperParams, LR_POLICIES, OPTIMIZERS, Optimizer
from ..units import nn, parallel_nn, recurrent
from ..units.workflow import Workflow

LAYER_TYPES = {
    "attention": parallel_nn.MultiHeadAttention,
    "all2all": nn.All2All,
    "all2all_tanh": nn.All2AllTanh,
    "all2all_relu": nn.All2AllRELU,
    "all2all_sincos": nn.All2AllSincos,
    "softmax": nn.All2AllSoftmax,
    "embedding": nn.Embedding,
    "ffn": nn.FFN,
    "layer_norm": nn.LayerNorm,
    "seq_last": nn.SeqLast,
    "conv": nn.Conv,
    "conv_relu": nn.ConvRELU,
    "conv_tanh": nn.ConvTanh,
    "deconv": nn.Deconv,
    "max_pooling": nn.MaxPooling,
    "avg_pooling": nn.AvgPooling,
    "stochastic_abs_pooling": nn.StochasticAbsPooling,
    "depool": nn.Depool,
    "dropout": nn.Dropout,
    "lrn": nn.LRN,
    "norm": nn.MeanDispNormalizer,
    "flatten": nn.Flatten,
    "reshape": nn.Reshape,
    "rnn": recurrent.RNN,
    "gru": recurrent.GRU,
    "lstm": recurrent.LSTM,
    "moe": parallel_nn.MoEFFN,
    "pipeline_stack": parallel_nn.PipelineStack,
}

#: layer types of the JAX package not ported yet -> the ROADMAP.md slice
#: that brings them (none left)
PENDING_TYPES: Dict[str, str] = {}

#: layer-type prefixes that take a compute_dtype kwarg
COMPUTE_DTYPE_TYPES = ("all2all", "softmax", "conv", "deconv", "rnn",
                       "gru", "lstm", "attention", "ffn")


def build_workflow(name: str, layers: Sequence[dict], *,
                   loss: str = "softmax",
                   compute_dtype: Optional[str] = None) -> Workflow:
    """Construct a Workflow from a layer-config list (same names, same
    wiring and same unit names as the JAX package).  ``loss``:
    "softmax" (EvaluatorSoftmax on ``@labels``, ``@mask``), "mse"
    (EvaluatorMSE on ``@targets``, ``@mask``), "mse_input" (EvaluatorMSE
    against ``@input``: the autoencoders) or "none"."""
    wf = Workflow(name)
    prev = "@input"
    for i, spec in enumerate(layers):
        spec = dict(spec)
        ltype = spec.pop("type")
        spec.pop("hyperparams", None)
        spec.pop("remat", None)        # a training-memory knob
        lname = spec.pop("name", f"l{i}_{ltype}")
        if ltype not in LAYER_TYPES:
            if ltype in PENDING_TYPES:
                raise NotImplementedError(
                    f"layer {lname!r}: type {ltype!r} is not ported yet; "
                    f"it comes with ROADMAP.md {PENDING_TYPES[ltype]}")
            raise KeyError(f"unknown layer type {ltype!r}")
        if compute_dtype is not None and ltype.startswith(
                COMPUTE_DTYPE_TYPES + ("pipeline_stack",)):
            # a stack forwards it into its stage sublists
            spec.setdefault("compute_dtype", compute_dtype)
        wf.add(LAYER_TYPES[ltype](name=lname, inputs=(prev,), **spec))
        prev = lname

    if loss == "softmax":
        wf.add(nn.EvaluatorSoftmax(name="evaluator",
                                   inputs=(prev, "@labels", "@mask")))
    elif loss == "mse":
        wf.add(nn.EvaluatorMSE(name="evaluator",
                               inputs=(prev, "@targets", "@mask")))
    elif loss == "mse_input":
        wf.add(nn.EvaluatorMSE(name="evaluator",
                               inputs=(prev, "@input", "@mask")))
    elif loss != "none":
        raise ValueError(f"unknown loss {loss!r}")
    return wf


def build_optimizer(kind: str, layers: Sequence[dict],
                    **kwargs) -> Optimizer:
    """Optimizer from its name and the per-layer ``hyperparams`` of the
    layer configs (veles_tpu/models/standard.py:118-149).  ``lr_policy``
    may be a config dict ``{"type": "exp"|"inv"|"step"|"fixed"|
    "warmup_cosine", ...args}``; without a ``base`` it starts from the
    optimizer's own default lr."""
    policy = kwargs.get("lr_policy")
    if isinstance(policy, dict):
        p = dict(policy)
        ptype = p.pop("type")
        if "base" not in p and "lr" not in kwargs:
            sig = inspect.signature(OPTIMIZERS[kind]).parameters.get("lr")
            if sig is not None and sig.default is not inspect.Parameter.empty:
                p["base"] = sig.default
        p.setdefault("base", kwargs.get("lr", 0.01))
        kwargs["lr_policy"] = LR_POLICIES[ptype](**p)
    per_unit: Dict[str, HyperParams] = {}
    for i, spec in enumerate(layers):
        hp = spec.get("hyperparams")
        if hp:
            lname = spec.get("name", f"l{i}_{spec['type']}")
            per_unit[lname] = HyperParams(**hp) \
                if isinstance(hp, dict) else hp
    return OPTIMIZERS[kind](per_unit=per_unit, **kwargs)


class StandardWorkflow:
    """Workflow + optimizer + decision settings from one config dict (the
    shape of a ``configs/*.json`` "workflow" section)."""

    def __init__(self, config: dict):
        self.config = dict(config)
        layers = self.config["layers"]
        self.workflow = build_workflow(
            self.config.get("name", "StandardWorkflow"), layers,
            loss=self.config.get("loss", "softmax"),
            compute_dtype=self.config.get("compute_dtype"))
        self.optimizer = build_optimizer(
            self.config.get("optimizer", "momentum"), layers,
            **dict(self.config.get("optimizer_args", {})))

    def make_trainer(self, loader, decision=None, snapshotter=None, *,
                     device=None, step_cache=None, status=None, mesh=None,
                     rule=None):
        """A :class:`~veles_tpu_torch.runtime.trainer.Trainer` over this
        workflow and optimizer (default decision: the config's
        ``max_epochs`` and ``fail_iterations``; default ``step_cache``: a
        fresh one that captures on the card), with the config's
        ``pipeline_microbatches`` and ``pipeline_interleave`` for a
        ``mesh`` with a pipe axis; ``rule`` places the state on it."""
        from ..runtime.decision import Decision
        from ..runtime.trainer import Trainer
        decision = decision or Decision(
            max_epochs=self.config.get("max_epochs"),
            fail_iterations=self.config.get("fail_iterations", 50))
        return Trainer(self.workflow, loader, self.optimizer, decision,
                       snapshotter, device=device, step_cache=step_cache,
                       status=status, mesh=mesh, rule=rule,
                       pipeline_microbatches=self.config.get(
                           "pipeline_microbatches"),
                       pipeline_interleave=self.config.get(
                           "pipeline_interleave", 1))
