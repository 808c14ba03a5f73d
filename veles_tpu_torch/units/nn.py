"""Forward units (counterpart of veles_tpu/units/nn.py): the LM family
(:31-111, :509-625), the image family's Conv/ConvRELU/ConvTanh, Deconv,
MaxPooling/AvgPooling, StochasticAbsPooling, Depool, Dropout, LRN,
MeanDispNormalizer, Flatten and Reshape (:114-500, :627-645), and the
evaluators: the softmax and the MSE one (:648-719).

Image activations are NHWC and conv weights HWIO, the JAX package's
layouts, so weights move across unchanged and the dropout mask (a hash of
each element's row-major index) is the JAX package's.  Deconv, Depool,
StochasticAbsPooling, Flatten, Reshape and the MSE evaluator are plain
tensor code (cuDNN for the deconvolution), as the JAX package leaves them
to XLA outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import ops
from ..ops import losses
from ..ops.activations import ACTIVATIONS
from ..ops.convolution import conv2d, conv_padding, deconv2d, \
    deconv_padding, pair
from ..ops.kernels.fused_dropout import fused_dropout
from ..ops.lrn import METHODS as LRN_METHODS
from ..ops.lrn import local_response_norm
from ..ops.normalize import mean_disp_normalize
from ..ops.pooling import avg_pool, avg_unpool, max_pool
from .base import Forward, Spec, Unit, dtype_of


#: a dense weight's megatron splits over the model axis (the guarded
#: partition form: trailing None trimmed)
COLUMN, ROW = (None, "model"), ("model",)


class All2All(Forward):
    """Fully-connected layer; ``per_position`` projects only the trailing
    feature axis ((B, T, E) -> (B, T, out)), else each sample flattens.
    Under a ``model`` split of ``w`` (``Context.tp``) a column split
    computes its output columns (gathered over the group) and a row
    split its partial product of its input columns (all-reduced)."""

    def __init__(self, output_size: int, *, activation: str = "linear",
                 weights_scale: float = 1.0, include_bias: bool = True,
                 compute_dtype=None, name=None, inputs=("@input",),
                 per_position: bool = False):
        super().__init__(name, inputs)
        self.output_size = int(output_size)
        self.activation = activation
        self.weights_scale = weights_scale
        self.include_bias = include_bias
        self.compute_dtype = dtype_of(compute_dtype)
        self.per_position = bool(per_position)

    def _in_features(self, in_spec: Spec) -> int:
        if self.per_position:
            return int(in_spec.shape[-1])
        return int(np.prod(in_spec.shape[1:]))

    def output_spec(self, in_specs):
        s = in_specs[0]
        if self.per_position:
            return Spec(tuple(s.shape[:-1]) + (self.output_size,), s.dtype)
        return Spec((s.shape[0], self.output_size), s.dtype)

    def init(self, generator, in_specs, device):
        fan_in = self._in_features(in_specs[0])
        params = {"w": ops.smart_uniform_init(
            generator, (fan_in, self.output_size), fan_in,
            scale=self.weights_scale, device=device)}
        if self.include_bias:
            params["b"] = torch.zeros((self.output_size,),
                                      dtype=torch.float32, device=device)
        return params, {}

    def tp_local(self, parts, n_model):
        if parts.get("w") == COLUMN:
            return {"w"} | ({"b"} if parts.get("b") == ROW else set())
        return {"w"} if parts.get("w") == ROW else set()

    def apply(self, params, state, xs, ctx):
        x = xs[0]
        if self.per_position:
            lead = tuple(x.shape[:-1])
            x = x.reshape(-1, x.shape[-1])
        else:
            lead = None
            x = x.reshape(x.shape[0], -1)
        split = ctx.tp_split(self.name)
        if split:
            y = self._split_dense(params, x, ctx.mesh, split)
        else:
            y = ops.dense(x, params["w"], params.get("b"),
                          compute_dtype=self.compute_dtype)
        if lead is not None:
            y = y.reshape(lead + (self.output_size,))
        return ACTIVATIONS[self.activation](y), state


    def _split_dense(self, params, x, mesh, split):
        from ..parallel import tensor_parallel as tp
        cd = self.compute_dtype
        if split["w"] == COLUMN:
            b = (tp.local_param(params, "b", split, 0, mesh)
                 if self.include_bias else None)
            y = ops.dense(tp.copy_to_model(x, mesh), params["w"], b,
                          compute_dtype=cd)
            return tp.gather_from_model(y, -1, mesh)
        part, finish = self._row_parts(params, x, mesh)
        return finish(tp.reduce_from_model(part, mesh))

    def _row_parts(self, params, x, mesh):
        from ..parallel import tensor_parallel as tp
        part = ops.dense(tp.scatter_to_model(x, -1, mesh), params["w"],
                         None, compute_dtype=self.compute_dtype)
        if not self.include_bias:
            return part, lambda y: y
        return part, lambda y: y + params["b"]


class All2AllTanh(All2All):
    def __init__(self, output_size, **kw):
        kw.setdefault("activation", "tanh")
        super().__init__(output_size, **kw)


class All2AllRELU(All2All):
    def __init__(self, output_size, **kw):
        kw.setdefault("activation", "relu")
        super().__init__(output_size, **kw)


class All2AllSincos(All2All):
    def __init__(self, output_size, **kw):
        kw.setdefault("activation", "sincos")
        super().__init__(output_size, **kw)


class All2AllSoftmax(All2All):
    """Output layer: emits LOGITS (softmax fuses into the loss)."""

    def __init__(self, output_size, **kw):
        kw.setdefault("activation", "linear")
        super().__init__(output_size, **kw)


class Conv(Forward):
    """2-D convolution (NHWC activations, HWIO weights) with an optional
    activation."""

    def __init__(self, n_kernels: int, kx: int = 3, ky: Optional[int] = None,
                 *, stride=1, padding="SAME", activation="linear",
                 weights_scale=1.0, include_bias=True, compute_dtype=None,
                 name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.n_kernels = int(n_kernels)
        self.kx = int(kx)
        self.ky = int(ky if ky is not None else kx)
        self.stride = stride
        self.padding = padding
        self.activation = activation
        self.weights_scale = weights_scale
        self.include_bias = include_bias
        self.compute_dtype = dtype_of(compute_dtype)

    def output_spec(self, in_specs):
        n, h, w, _ = in_specs[0].shape
        stride = pair(self.stride)
        pads = conv_padding(self.padding, (h, w), (self.ky, self.kx), stride)
        hw = [(size + lo + hi - k) // s + 1 for size, (lo, hi), k, s in
              zip((h, w), pads, (self.ky, self.kx), stride)]
        return Spec((n, *hw, self.n_kernels), in_specs[0].dtype)

    def init(self, generator, in_specs, device):
        cin = in_specs[0].shape[-1]
        fan_in = self.kx * self.ky * cin
        params = {"w": ops.smart_uniform_init(
            generator, (self.ky, self.kx, cin, self.n_kernels), fan_in,
            scale=self.weights_scale, device=device)}
        if self.include_bias:
            params["b"] = torch.zeros((self.n_kernels,), dtype=torch.float32,
                                      device=device)
        return params, {}

    def apply(self, params, state, xs, ctx):
        y = conv2d(xs[0], params["w"], params.get("b"), stride=self.stride,
                   padding=self.padding, compute_dtype=self.compute_dtype)
        return ACTIVATIONS[self.activation](y), state


class ConvRELU(Conv):
    def __init__(self, n_kernels, kx=3, ky=None, **kw):
        kw.setdefault("activation", "relu")
        super().__init__(n_kernels, kx, ky, **kw)


class ConvTanh(Conv):
    def __init__(self, n_kernels, kx=3, ky=None, **kw):
        kw.setdefault("activation", "tanh")
        super().__init__(n_kernels, kx, ky, **kw)


class Deconv(Forward):
    """Transposed convolution (``ops.convolution.deconv2d``: the JAX
    package's ``conv_transpose`` without a kernel flip), HWIO weights of
    (ky, kx, Cin, n_kernels), a bias, an optional activation."""

    def __init__(self, n_kernels: int, kx: int = 3, ky: Optional[int] = None,
                 *, stride=1, padding="SAME", activation="linear",
                 weights_scale=1.0, compute_dtype=None, name=None,
                 inputs=("@input",)):
        super().__init__(name, inputs)
        self.n_kernels = int(n_kernels)
        self.kx = int(kx)
        self.ky = int(ky if ky is not None else kx)
        self.stride = stride
        self.padding = padding
        self.activation = activation
        self.weights_scale = weights_scale
        self.compute_dtype = dtype_of(compute_dtype)

    def output_spec(self, in_specs):
        n, h, w, _ = in_specs[0].shape
        stride = pair(self.stride)
        pads = deconv_padding(self.padding, (self.ky, self.kx), stride)
        hw = [(size - 1) * s + 1 + lo + hi - k + 1 for size, (lo, hi), k, s
              in zip((h, w), pads, (self.ky, self.kx), stride)]
        return Spec((n, *hw, self.n_kernels), in_specs[0].dtype)

    def init(self, generator, in_specs, device):
        cin = in_specs[0].shape[-1]
        fan_in = self.kx * self.ky * cin
        return {"w": ops.smart_uniform_init(
            generator, (self.ky, self.kx, cin, self.n_kernels), fan_in,
            scale=self.weights_scale, device=device),
            "b": torch.zeros((self.n_kernels,), dtype=torch.float32,
                             device=device)}, {}

    def apply(self, params, state, xs, ctx):
        y = deconv2d(xs[0], params["w"], params["b"], stride=self.stride,
                     padding=self.padding, compute_dtype=self.compute_dtype)
        return ACTIVATIONS[self.activation](y), state


class _Pooling(Unit):
    """VALID pooling over NHWC windows (stride defaults to the window)."""

    pool = None

    def __init__(self, window=2, stride=None, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.window = window
        self.stride = stride

    def output_spec(self, in_specs):
        n, h, w, c = in_specs[0].shape
        win = pair(self.window)
        st = pair(self.stride) if self.stride is not None else win
        return Spec((n, (h - win[0]) // st[0] + 1, (w - win[1]) // st[1] + 1,
                     c), in_specs[0].dtype)

    def apply(self, params, state, xs, ctx):
        return self.pool(xs[0], self.window, self.stride), state


class MaxPooling(_Pooling):
    pool = staticmethod(max_pool)


class AvgPooling(_Pooling):
    pool = staticmethod(avg_pool)


class StochasticAbsPooling(MaxPooling):
    """Pool by the largest magnitude, keeping its sign (the deterministic
    form of Znicz's stochastic abs-pooling; veles_tpu/units/nn.py:237):
    the window's max where it is at least the largest |x|, else its
    min."""

    def apply(self, params, state, xs, ctx):
        x = xs[0]
        mag = max_pool(x.abs(), self.window, self.stride)
        pos = max_pool(x, self.window, self.stride)
        neg = -max_pool(-x, self.window, self.stride)
        return torch.where(pos >= mag, pos, neg), state


class Depool(Unit):
    """Unpooling by uniform spread (``ops.pooling.avg_unpool``; pairs with
    Deconv in the autoencoders)."""

    def __init__(self, window=2, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.window = window

    def output_spec(self, in_specs):
        n, h, w, c = in_specs[0].shape
        win = pair(self.window)
        return Spec((n, h * win[0], w * win[1], c), in_specs[0].dtype)

    def apply(self, params, state, xs, ctx):
        return avg_unpool(xs[0], self.window), state


class Dropout(Unit):
    """Inverted dropout; the identity at eval or at ratio <= 0.

    The JAX package's kernel formulation on every device: the seed is
    ``bits32(fold_in(step key, hash(name)))`` (units/nn.py:338-345) and
    the mask the ``fused_dropout`` kernel's hash, so the mask equals the
    JAX package's with ``use_pallas=True`` bit for bit.  In a train step
    the seed reaches the kernel through the unit's device slot
    (``Context.seeds``, filled by the step's host part), so the step can
    be captured; a direct train-mode call with a ``Context.key`` takes
    the host seed.  The JAX package's other formulation, a threefry
    Bernoulli mask (units/nn.py:346-348), is not ported:
    ``use_pallas=False`` raises."""

    stochastic = True

    def __init__(self, dropout_ratio=0.5, name=None, inputs=("@input",),
                 use_pallas=None):
        super().__init__(name, inputs)
        if use_pallas is not None and not use_pallas:
            raise NotImplementedError(
                f"Dropout {self.name!r}: use_pallas=False asks for the JAX "
                "package's threefry Bernoulli mask, which the port does not "
                "have; it computes the fused kernel's mask on every device "
                "(use_pallas None or True)")
        self.ratio = float(dropout_ratio)
        self.use_pallas = use_pallas

    @property
    def draws_seed(self):
        return self.ratio > 0.0

    def apply(self, params, state, xs, ctx):
        x = xs[0]
        if not ctx.train or self.ratio <= 0.0:
            return x, state
        seed = ctx.unit_seed(self.name)
        if seed is None:
            raise ValueError(f"Dropout {self.name!r}: a train-mode call "
                             "needs the step key (Context.key) or its "
                             "seed slot (Context.seeds)")
        return fused_dropout(x, seed, self.ratio), state


class LRN(Unit):
    """Local response normalization across channels.  ``method``:
    "cumsum", "band" or "band_bf16" (ops/lrn.py), or "auto": measured
    forward plus backward on the device at the input shape, the winner
    persisted per device kind (``runtime/autotune.py``; the JAX
    package's units/nn.py:351-420).  ``root.common.autotune = False``
    makes "auto" "cumsum" at build.  Else it resolves when the
    workflow's state is initialized on a device (:meth:`init`), else at
    :meth:`prepare` or the first call; ``method`` then names the pick
    (what an export writes), never "auto"."""

    def __init__(self, n=5, k=2.0, alpha=1e-4, beta=0.75, name=None,
                 inputs=("@input",), method="cumsum"):
        super().__init__(name, inputs)
        self.n, self.k, self.alpha, self.beta = n, k, alpha, beta
        if method != "auto" and method not in LRN_METHODS:
            raise ValueError(f"LRN {self.name!r}: unknown method {method!r}")
        self.method = method

    def output_spec(self, in_specs):
        from ..config import root
        if self.method == "auto" and not bool(root.common.autotune):
            self.method = "cumsum"      # nothing to measure: at build
        return super().output_spec(in_specs)

    def init(self, generator, in_specs, device):
        if torch.device(device).type != "meta":
            self.prepare(in_specs, device)
        return super().init(generator, in_specs, device)

    def prepare(self, in_specs, device="cpu"):
        """Resolve ``method="auto"`` at ``in_specs[0]``'s shape on
        ``device``: the DB's winner, else the three formulations'
        forward plus backward measured there."""
        if self.method != "auto":
            return
        from ..config import root
        from ..runtime import autotune
        if not bool(root.common.autotune):
            self.method = "cumsum"
            return
        spec = in_specs[0]
        op = f"lrn_fwd_bwd_n{self.n}_b{self.beta}"
        probe = torch.empty(tuple(spec.shape), dtype=spec.dtype,
                            device="meta")
        cached = autotune.lookup(op, LRN_METHODS, [probe], device=device)
        if cached is not None:       # warm start: nothing allocated
            self.method = cached
            return
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(tuple(spec.shape), generator=gen).to(
            device=device, dtype=spec.dtype)

        def run(method):
            def f(x):
                x = x.detach().requires_grad_(True)
                y = local_response_norm(x, n=self.n, k=self.k,
                                        alpha=self.alpha, beta=self.beta,
                                        method=method)
                y.float().sum().backward()
                return x.grad
            return f

        # n and beta in the key: the band's C x C product does not
        # depend on n, the cumulative sum's cost does
        self.method = autotune.pick(
            op, {m: run(m) for m in LRN_METHODS}, [x], default="cumsum")

    def apply(self, params, state, xs, ctx):
        if self.method == "auto":
            self.prepare([Spec(tuple(xs[0].shape), xs[0].dtype)],
                         xs[0].device)
        return local_response_norm(
            xs[0], n=self.n, k=self.k, alpha=self.alpha, beta=self.beta,
            method=self.method), state


class MeanDispNormalizer(Unit):
    """(x - mean) * rdisp with the dataset statistics in unit state
    (``mean``, ``rdisp``, float32), through the ``mean_disp`` kernel on
    the card.  ``use_pallas`` is accepted and changes nothing: the JAX
    package's XLA and Pallas forms are bitwise equal."""

    def __init__(self, mean=None, rdisp=None, name=None, inputs=("@input",),
                 use_pallas=None):
        super().__init__(name, inputs)
        self._mean = mean
        self._rdisp = rdisp
        self.use_pallas = use_pallas

    def output_spec(self, in_specs):
        return Spec(in_specs[0].shape, torch.float32)

    def init(self, generator, in_specs, device):
        shape = tuple(in_specs[0].shape[1:])

        def stat(value, fill):
            if value is None:
                return torch.full(shape, fill, dtype=torch.float32,
                                  device=device)
            arr = np.array(value, dtype=np.float32)
            return torch.from_numpy(arr).to(device)

        return {}, {"mean": stat(self._mean, 0.0),
                    "rdisp": stat(self._rdisp, 1.0)}

    def apply(self, params, state, xs, ctx):
        return mean_disp_normalize(xs[0], state["mean"],
                                   state["rdisp"]), state


class Flatten(Unit):
    """(N, ...) -> (N, prod(...))."""

    def output_spec(self, in_specs):
        s = in_specs[0]
        return Spec((s.shape[0], int(np.prod(s.shape[1:]))), s.dtype)

    def apply(self, params, state, xs, ctx):
        return xs[0].reshape(xs[0].shape[0], -1), state


class LayerNorm(Unit):
    """Layer normalization over the trailing axis, computed in float32,
    with learnable scale/shift."""

    def __init__(self, eps: float = 1e-5, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.eps = float(eps)

    def init(self, generator, in_specs, device):
        d = in_specs[0].shape[-1]
        return {"scale": torch.ones((d,), device=device),
                "shift": torch.zeros((d,), device=device)}, {}

    def apply(self, params, state, xs, ctx):
        x = xs[0]
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        out = y * params["scale"] + params["shift"]
        return out.to(x.dtype), state


class FFN(Unit):
    """Per-position two-layer MLP with residual: y = x + W2.act(W1.x).
    Under the megatron split (``w1`` by columns, ``w2`` by rows over the
    model group: ``Context.tp``) each model rank computes its hidden
    columns and its partial product, all-reduced once."""

    def __init__(self, d_hidden: int, activation: str = "relu",
                 residual: bool = True, name=None, inputs=("@input",),
                 compute_dtype=None):
        super().__init__(name, inputs)
        self.d_hidden = int(d_hidden)
        self.activation = activation
        self.residual = bool(residual)
        self.compute_dtype = dtype_of(compute_dtype)

    def init(self, generator, in_specs, device):
        E = in_specs[0].shape[-1]
        w1 = ops.smart_uniform_init(generator, (E, self.d_hidden), E,
                                    device=device)
        w2 = ops.smart_uniform_init(generator, (self.d_hidden, E),
                                    self.d_hidden, device=device)
        return {"w1": w1,
                "b1": torch.zeros((self.d_hidden,), device=device),
                "w2": w2,
                "b2": torch.zeros((E,), device=device)}, {}

    def tp_local(self, parts, n_model):
        # sincos picks sin or cos by the hidden column's index
        if self.activation == "sincos" or not (
                parts.get("w1") == COLUMN and parts.get("w2") == ROW):
            return set()
        return {"w1", "w2"} | ({"b1"} if parts.get("b1") == ROW
                               else set())

    def apply(self, params, state, xs, ctx):
        x = xs[0]
        lead = tuple(x.shape[:-1])
        flat = x.reshape(-1, x.shape[-1])
        if ctx.tp_split(self.name):
            from ..parallel import tensor_parallel as tp
            part, finish = self.tp_parts(params, x, ctx)
            return finish(tp.reduce_from_model(part, ctx.mesh)), state
        h = ops.dense(flat, params["w1"], params["b1"],
                      compute_dtype=self.compute_dtype)
        h = ACTIVATIONS[self.activation](h)
        y = ops.dense(h, params["w2"], params["b2"],
                      compute_dtype=self.compute_dtype)
        y = y.reshape(lead + (x.shape[-1],))
        if self.residual:
            y = y + x
        return y.to(x.dtype), state

    def tp_parts(self, params, x, ctx):
        """This model rank's partial product (float32) and the
        ``finish`` of the all-reduced sum (``parallel.tensor_parallel``):
        the hidden columns of its ``w1`` block, their part of ``w2``;
        then ``b2`` and the residual."""
        from ..parallel import tensor_parallel as tp
        mesh, split = ctx.mesh, ctx.tp_split(self.name)
        cd = self.compute_dtype
        flat = x.reshape(-1, x.shape[-1])
        h = ops.dense(tp.copy_to_model(flat, mesh), params["w1"],
                      tp.local_param(params, "b1", split, 0, mesh),
                      compute_dtype=cd)
        h = ACTIVATIONS[self.activation](h)
        part = ops.dense(h, params["w2"], None, compute_dtype=cd)

        def finish(y):
            y = (y + params["b2"]).reshape(x.shape)
            if self.residual:
                y = y + x
            return y.to(x.dtype)
        return part, finish


class Embedding(Unit):
    """Token embedding: int tokens (B, T) -> (B, T, dim) float32."""

    def __init__(self, vocab: int, dim: int, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.vocab = int(vocab)
        self.dim = int(dim)

    def output_spec(self, in_specs):
        return Spec(tuple(in_specs[0].shape) + (self.dim,), torch.float32)

    def init(self, generator, in_specs, device):
        return {"table": ops.smart_uniform_init(
            generator, (self.vocab, self.dim), self.vocab,
            device=device)}, {}

    def apply(self, params, state, xs, ctx):
        return params["table"][xs[0].long()], state


def input_vocab(workflow, params) -> Optional[int]:
    """Embedding-table rows of the chain's front (None without an
    Embedding): the bound on acceptable input token ids."""
    for u in workflow.topo_order():
        if isinstance(u, Embedding):
            return int(params[u.name]["table"].shape[0])
    return None


class SeqLast(Unit):
    """(B, T, ...) -> (B, ...): the final time step."""

    def output_spec(self, in_specs):
        s = in_specs[0]
        return Spec((s.shape[0],) + tuple(s.shape[2:]), s.dtype)

    def apply(self, params, state, xs, ctx):
        return xs[0][:, -1], state


class Reshape(Unit):
    """Reshape the per-sample trailing dims (e.g. a flat 784 into 28 x 28
    x 1 for a conv trunk fed by a vector loader)."""

    def __init__(self, shape, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.shape = tuple(int(s) for s in shape)

    def output_spec(self, in_specs):
        s = in_specs[0]
        if int(np.prod(s.shape[1:])) != int(np.prod(self.shape)):
            raise ValueError(
                f"cannot reshape {s.shape[1:]} to {self.shape}")
        return Spec((s.shape[0],) + self.shape, s.dtype)

    def apply(self, params, state, xs, ctx):
        return xs[0].reshape((xs[0].shape[0],) + self.shape), state


class Evaluator(Unit):
    """Base loss unit: its output is the scalar loss, and
    :meth:`metrics` gives the per-batch sums the trainer adds up
    (veles_tpu/units/nn.py:648-656)."""

    is_evaluator = True

    def metrics(self, params, state, xs, ctx) -> dict:
        raise NotImplementedError


class EvaluatorSoftmax(Evaluator):
    """Softmax cross-entropy over logits + integer labels, with the
    loader's ``@mask`` keeping metrics exact on padded batches
    (veles_tpu/units/nn.py:659-694).  Sequence form: logits (B, T, V) with
    labels (B, T) give the per-position loss; a per-sample mask broadcasts
    across positions and the metrics count positions."""

    def __init__(self, name=None, inputs=("@input", "@labels", "@mask")):
        super().__init__(name, inputs)

    def output_spec(self, in_specs):
        return Spec((), torch.float32)

    @staticmethod
    def _mask(xs):
        m = xs[2] if len(xs) > 2 else None
        labels = xs[1]
        if m is not None and m.dim() < labels.dim():
            m = m.reshape(tuple(m.shape) + (1,) * (labels.dim() - m.dim())
                          ).expand(labels.shape)
        return m

    def apply(self, params, state, xs, ctx):
        loss, _ = losses.softmax_cross_entropy(xs[0], xs[1],
                                               mask=self._mask(xs))
        return loss, state

    def metrics(self, params, state, xs, ctx):
        mask = self._mask(xs)
        loss, n_err = losses.softmax_cross_entropy(xs[0], xs[1], mask=mask)
        n = mask.sum() if mask is not None else torch.tensor(
            float(np.prod(xs[1].shape)), device=xs[0].device)
        return {"loss": loss, "n_err": n_err, "n_samples": n}


class EvaluatorMSE(Evaluator):
    """Mean squared error against targets (the autoencoders compare with
    ``@input``); the metrics' ``mse_sum`` (the masked sum of per-sample
    mean squared errors) gives the epoch's ``rmse``
    (veles_tpu/units/nn.py:697-719)."""

    def __init__(self, name=None, inputs=("@input", "@targets", "@mask")):
        super().__init__(name, inputs)

    def output_spec(self, in_specs):
        return Spec((), torch.float32)

    @staticmethod
    def _mask(xs):
        return xs[2] if len(xs) > 2 else None

    def apply(self, params, state, xs, ctx):
        loss, _ = losses.mse_loss(xs[0], xs[1], mask=self._mask(xs))
        return loss, state

    def metrics(self, params, state, xs, ctx):
        mask = self._mask(xs)
        loss, agg = losses.mse_loss(xs[0], xs[1], mask=mask)
        n = mask.sum() if mask is not None else torch.tensor(
            float(xs[0].shape[0]), device=xs[0].device)
        return {"loss": loss, "mse_sum": agg, "n_samples": n}
