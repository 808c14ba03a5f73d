"""Recurrent cells and their time scans (counterpart of
veles_tpu/ops/recurrent.py:29-118).

* All gates of a step come from ONE fused ``(B, F+H) @ (F+H, G*H)``
  product over the concatenated ``[x, h]``; the GRU's candidate takes a
  second product over ``[x, r*h]``.
* ``compute_dtype`` rounds the product's operands to that type and takes
  the product in float32 (the JAX package's ``preferred_element_type=
  float32``, as ``ops.linear.dense``); the carried state stays float32.
* The scan is a Python loop over the leading (time) axis: a CUDA graph
  captures it whole, and autograd differentiates it as it stands.  The
  JAX package computes these with ``lax.scan`` and ``jnp.dot``, outside
  any Pallas kernel, so plain tensor ops are the port here.

The cell functions are shared by the training scan and the O(1)
carried-state decode (``runtime/generate.py``), so the two paths cannot
drift.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _gates_matmul(x, h, w, b, compute_dtype):
    """One fused (B, F+H) @ (F+H, G*H) product for every gate of a
    step, plus the bias."""
    xh = torch.cat([x, h], dim=-1)
    if compute_dtype is not None:
        y = torch.matmul(xh.to(compute_dtype).float(),
                         w.to(compute_dtype).float())
    else:
        y = torch.matmul(xh, w)
    return y + b


def rnn_cell(x, h, w, b, *, activation=torch.tanh, compute_dtype=None):
    """One Elman step: (B, F), (B, H) -> new h (B, H)."""
    return activation(_gates_matmul(x, h, w, b, compute_dtype))


def gru_cell(x, h, w, b, *, compute_dtype=None):
    """One GRU step: the fused [reset, update] product, then the
    candidate's product over ``[x, r*h]``."""
    hidden = h.shape[-1]
    w_rz, w_cand = w[:, :2 * hidden], w[:, 2 * hidden:]
    b_rz, b_cand = b[:2 * hidden], b[2 * hidden:]
    rz = torch.sigmoid(_gates_matmul(x, h, w_rz, b_rz, compute_dtype))
    r, z = rz[..., :hidden], rz[..., hidden:]
    c = torch.tanh(_gates_matmul(x, r * h, w_cand, b_cand, compute_dtype))
    return (1.0 - z) * h + z * c


def lstm_cell(x, h, c, w, b, *, compute_dtype=None,
              forget_bias: float = 1.0):
    """One LSTM step -> (new h, new c); gates [input, forget, cell,
    output], ``forget_bias`` added to the forget gate's pre-activation."""
    gates = _gates_matmul(x, h, w, b, compute_dtype)
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def rnn_scan(xs, h0, w, b, *, activation=torch.tanh, compute_dtype=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Elman RNN over xs (T, B, F), w (F+H, H): (ys (T, B, H), h_T)."""
    h, ys = h0, []
    for t in range(xs.shape[0]):
        h = rnn_cell(xs[t], h, w, b, activation=activation,
                     compute_dtype=compute_dtype)
        ys.append(h)
    return torch.stack(ys), h


def gru_scan(xs, h0, w, b, *, compute_dtype=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GRU over xs (T, B, F), w (F+H, 3H) for [reset, update,
    candidate]: (ys (T, B, H), h_T)."""
    h, ys = h0, []
    for t in range(xs.shape[0]):
        h = gru_cell(xs[t], h, w, b, compute_dtype=compute_dtype)
        ys.append(h)
    return torch.stack(ys), h


def lstm_scan(xs, h0, c0, w, b, *, compute_dtype=None,
              forget_bias: float = 1.0):
    """LSTM over xs (T, B, F), w (F+H, 4H): (ys (T, B, H), (h_T,
    c_T))."""
    h, c, ys = h0, c0, []
    for t in range(xs.shape[0]):
        h, c = lstm_cell(xs[t], h, c, w, b, compute_dtype=compute_dtype,
                         forget_bias=forget_bias)
        ys.append(h)
    return torch.stack(ys), (h, c)


def rnn_reference(xs, h0, w, b, activation=None):
    """Float64 numpy Elman RNN for tests (the same math, a plain
    loop)."""
    act = np.tanh if activation is None else activation
    h = np.asarray(h0, np.float64)
    w64, b64 = np.asarray(w, np.float64), np.asarray(b, np.float64)
    ys = []
    for x in np.asarray(xs, np.float64):
        h = act(np.concatenate([x, h], axis=-1) @ w64 + b64)
        ys.append(h)
    return np.stack(ys), h
