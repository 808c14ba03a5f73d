"""Recurrent layer units: RNN, GRU and LSTM over the scan cells
(counterpart of veles_tpu/units/recurrent.py:24-107).

Input is batch-major (B, T, F); a unit transposes to time-major for the
scan and back, so the rest of the workflow keeps the batch-leading
layout.  ``return_sequences=False`` yields the last hidden state (B, H).
The fused gate weight is ``(F+H, n_gates*H)`` and the bias
``(n_gates*H,)``, the JAX package's layout, so weights move across
unchanged.
"""

from __future__ import annotations

import torch

from .. import ops
from ..ops import recurrent as rec_ops
from .base import Forward, Spec, dtype_of


class _RecurrentBase(Forward):
    n_gates = 1  # columns of the fused gate weight = n_gates * hidden
    carry_keys = ("h",)  # the carried state's entries

    def __init__(self, hidden: int, *, return_sequences: bool = True,
                 compute_dtype=None, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.hidden = int(hidden)
        self.return_sequences = bool(return_sequences)
        self.compute_dtype = dtype_of(compute_dtype)

    def _dims(self, in_spec: Spec):
        if len(in_spec.shape) != 3:
            raise ValueError(
                f"{self.name}: recurrent input must be (batch, time, "
                f"features), got {in_spec.shape}")
        return in_spec.shape  # (B, T, F)

    def output_spec(self, in_specs):
        b, t, _ = self._dims(in_specs[0])
        if self.return_sequences:
            return Spec((b, t, self.hidden), in_specs[0].dtype)
        return Spec((b, self.hidden), in_specs[0].dtype)

    def init(self, generator, in_specs, device):
        _, _, f = self._dims(in_specs[0])
        fan_in = f + self.hidden
        params = {
            "w": ops.smart_uniform_init(
                generator, (fan_in, self.n_gates * self.hidden), fan_in,
                device=device),
            "b": torch.zeros((self.n_gates * self.hidden,),
                             dtype=torch.float32, device=device),
        }
        return params, {}

    def carry_init(self, batch: int, device) -> dict:
        """The zero carried state: ``{"h"}`` (and ``"c"`` for the
        LSTM), float32 (B, H)."""
        return {k: torch.zeros((batch, self.hidden), dtype=torch.float32,
                               device=device) for k in self.carry_keys}

    def cell(self, params, x, carry: dict) -> dict:
        """One step of the training scan's own cell: the new carry."""
        raise NotImplementedError

    def _scan(self, params, xs_tm, batch):
        raise NotImplementedError

    def apply(self, params, state, xs, ctx):
        x = xs[0].transpose(0, 1)   # (T, B, F) time-major for the scan
        ys_tm, _ = self._scan(params, x, x.shape[1])
        if self.return_sequences:
            return ys_tm.transpose(0, 1), state
        return ys_tm[-1], state


class RNN(_RecurrentBase):
    """Elman RNN with tanh (or relu) activation."""

    n_gates = 1

    def __init__(self, hidden, *, activation: str = "tanh", **kw):
        super().__init__(hidden, **kw)
        self.activation = activation

    def _act(self):
        return {"tanh": torch.tanh, "relu": torch.relu}[self.activation]

    def cell(self, params, x, carry):
        return {"h": rec_ops.rnn_cell(x, carry["h"], params["w"],
                                      params["b"], activation=self._act(),
                                      compute_dtype=self.compute_dtype)}

    def _scan(self, params, xs_tm, batch):
        h0 = torch.zeros((batch, self.hidden), dtype=torch.float32,
                         device=xs_tm.device)
        return rec_ops.rnn_scan(xs_tm, h0, params["w"], params["b"],
                                activation=self._act(),
                                compute_dtype=self.compute_dtype)


class GRU(_RecurrentBase):
    n_gates = 3

    def cell(self, params, x, carry):
        return {"h": rec_ops.gru_cell(x, carry["h"], params["w"],
                                      params["b"],
                                      compute_dtype=self.compute_dtype)}

    def _scan(self, params, xs_tm, batch):
        h0 = torch.zeros((batch, self.hidden), dtype=torch.float32,
                         device=xs_tm.device)
        return rec_ops.gru_scan(xs_tm, h0, params["w"], params["b"],
                                compute_dtype=self.compute_dtype)


class LSTM(_RecurrentBase):
    n_gates = 4
    carry_keys = ("h", "c")

    def __init__(self, hidden, *, forget_bias: float = 1.0, **kw):
        super().__init__(hidden, **kw)
        self.forget_bias = float(forget_bias)

    def cell(self, params, x, carry):
        h, c = rec_ops.lstm_cell(x, carry["h"], carry["c"], params["w"],
                                 params["b"],
                                 compute_dtype=self.compute_dtype,
                                 forget_bias=self.forget_bias)
        return {"h": h, "c": c}

    def _scan(self, params, xs_tm, batch):
        h0 = torch.zeros((batch, self.hidden), dtype=torch.float32,
                         device=xs_tm.device)
        return rec_ops.lstm_scan(xs_tm, h0, torch.zeros_like(h0),
                                 params["w"], params["b"],
                                 compute_dtype=self.compute_dtype,
                                 forget_bias=self.forget_bias)
