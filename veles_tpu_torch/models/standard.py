"""StandardWorkflow: build a workflow from a config layer list
(counterpart of veles_tpu/models/standard.py).

``LAYER_TYPES`` holds the types this slice ports; a config that names a
type of a later slice fails with an error that names the slice.  The
optimizer settings are kept as data only (the optimizers come with the
training slice).
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..units import nn, parallel_nn
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
}

#: layer types of the JAX package not ported yet -> the ROADMAP.md slice
#: that brings them
PENDING_TYPES = {
    "moe": "slice 8 (parallelism)",
    "pipeline_stack": "slice 8 (parallelism)",
    "rnn": "slice 7 (recurrent units)",
    "gru": "slice 7 (recurrent units)",
    "lstm": "slice 7 (recurrent units)",
    "conv": "slice 6 (image/conv family)",
    "conv_relu": "slice 6 (image/conv family)",
    "conv_tanh": "slice 6 (image/conv family)",
    "deconv": "slice 6 (image/conv family)",
    "max_pooling": "slice 6 (image/conv family)",
    "avg_pooling": "slice 6 (image/conv family)",
    "stochastic_abs_pooling": "slice 6 (image/conv family)",
    "depool": "slice 6 (image/conv family)",
    "dropout": "slice 6 (image/conv family)",
    "lrn": "slice 6 (image/conv family)",
    "norm": "slice 6 (image/conv family)",
    "flatten": "slice 6 (image/conv family)",
    "reshape": "slice 6 (image/conv family)",
}

#: layer-type prefixes that take a compute_dtype kwarg
COMPUTE_DTYPE_TYPES = ("all2all", "softmax", "conv", "deconv", "rnn",
                       "gru", "lstm", "attention", "ffn")


def build_workflow(name: str, layers: Sequence[dict], *,
                   loss: str = "softmax",
                   compute_dtype: Optional[str] = None) -> Workflow:
    """Construct a Workflow from a layer-config list (same names, same
    wiring and same unit names as the JAX package)."""
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
                COMPUTE_DTYPE_TYPES):
            spec.setdefault("compute_dtype", compute_dtype)
        wf.add(LAYER_TYPES[ltype](name=lname, inputs=(prev,), **spec))
        prev = lname

    if loss == "softmax":
        wf.add(nn.EvaluatorSoftmax(name="evaluator",
                                   inputs=(prev, "@labels", "@mask")))
    elif loss != "none":
        raise NotImplementedError(
            f"loss {loss!r} comes with the training slice of the port "
            "(ROADMAP.md, slices 2-3)")
    return wf


class StandardWorkflow:
    """Workflow + optimizer settings from one config dict (the shape of
    a ``configs/*.json`` "workflow" section)."""

    def __init__(self, config: dict):
        self.config = dict(config)
        self.workflow = build_workflow(
            self.config.get("name", "StandardWorkflow"),
            self.config["layers"],
            loss=self.config.get("loss", "softmax"),
            compute_dtype=self.config.get("compute_dtype"))
        # kept as data: the optimizers come with the training slice
        self.optimizer = {"kind": self.config.get("optimizer", "momentum"),
                          "args": dict(self.config.get("optimizer_args",
                                                       {}))}
