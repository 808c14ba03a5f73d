"""Kohonen self-organizing map: a self-updating unit trained by no
gradient (counterpart of veles_tpu/units/kohonen.py:21-81).

The codebook lives in unit state; the train step applies
:meth:`KohonenForward.update_state`, a batched winner search and Gaussian
neighbourhood pull in tensor ops.  Only the initial codebook is drawn
(from the init's ``torch.Generator``); from the same codebook the winner
map, the update and the quantization error are the JAX package's
functions.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Spec, Unit


class KohonenForward(Unit):
    """Forward: each sample's winner (best-matching unit) index; state
    holds the (sx*sy, features) codebook, the grid coordinates and the
    update count ``t``."""

    self_updating = True

    def __init__(self, shape=(8, 8), *, init_radius=None, init_lr=0.1,
                 decay_steps=1000.0, name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.sx, self.sy = shape
        self.n_neurons = self.sx * self.sy
        self.init_radius = init_radius or max(self.sx, self.sy) / 2.0
        self.init_lr = init_lr
        self.decay_steps = decay_steps

    def output_spec(self, in_specs):
        return Spec((in_specs[0].shape[0],), torch.int32)

    def init(self, generator, in_specs, device):
        feat = int(np.prod(in_specs[0].shape[1:]))
        u = torch.rand((self.n_neurons, feat), generator=generator,
                       dtype=torch.float32)
        gx, gy = torch.meshgrid(torch.arange(self.sx), torch.arange(self.sy),
                                indexing="ij")
        coords = torch.stack([gx.reshape(-1), gy.reshape(-1)], 1).float()
        return {}, {"weights": (u * 0.2 - 0.1).to(device),
                    "coords": coords.to(device),
                    "t": torch.zeros((), dtype=torch.float32,
                                     device=device)}

    @staticmethod
    def _dists(state, x):
        x = x.reshape(x.shape[0], -1)
        w = state["weights"]
        return ((x * x).sum(1, keepdim=True) - 2.0 * x @ w.T
                + (w * w).sum(1)[None, :])

    def apply(self, params, state, xs, ctx):
        d = self._dists(state, xs[0].float())
        return d.argmin(1).to(torch.int32), state

    def update_state(self, params, state, xs, ctx):
        """Batch SOM update with exponentially decaying lr and radius."""
        x = xs[0].reshape(xs[0].shape[0], -1).float()
        w, coords, t = state["weights"], state["coords"], state["t"]
        winners = self._dists(state, x).argmin(1)
        decay = torch.exp(-t / self.decay_steps)
        sigma = torch.clamp(self.init_radius * decay, min=0.5)
        eta = self.init_lr * decay
        wc = coords[winners]                                    # (B, 2)
        g2 = ((coords[None] - wc[:, None]) ** 2).sum(-1)        # (B, N)
        h = torch.exp(-g2 / (2.0 * sigma * sigma))              # (B, N)
        num = torch.einsum("bn,bf->nf", h, x)
        den = h.sum(0)[:, None]
        w_new = w + eta / x.shape[0] * (num - den * w)
        return {"weights": w_new, "coords": coords, "t": t + 1.0}

    def quantization_error(self, state, x) -> torch.Tensor:
        """Mean distance to the winner: the SOM's quality metric."""
        x = torch.as_tensor(np.asarray(x), device=state["weights"].device)
        d = self._dists(state, x.float())
        return torch.sqrt(torch.clamp(d.min(1).values, min=0.0)).mean()
