"""Bernoulli RBM trained by contrastive divergence: a self-updating unit
(counterpart of veles_tpu/units/rbm.py:16-79).

The Gibbs chain's uniform draws come from a ``torch.Generator`` (the
train step's, seeded from its key) or, for a comparison, from
``uniforms``: the ``cd_k + 1`` arrays the JAX package draws from its
threefry key, so that one CD step equals the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Spec, Unit


class RBM(Unit):
    """Forward: the hidden units' activation probabilities.  State: W,
    vbias, hbias."""

    self_updating = True

    def __init__(self, n_hidden: int, *, lr=0.05, cd_k: int = 1,
                 name=None, inputs=("@input",)):
        super().__init__(name, inputs)
        self.n_hidden = int(n_hidden)
        self.lr = lr
        self.cd_k = cd_k

    def output_spec(self, in_specs):
        return Spec((in_specs[0].shape[0], self.n_hidden), torch.float32)

    def init(self, generator, in_specs, device):
        feat = int(np.prod(in_specs[0].shape[1:]))
        w = torch.randn((feat, self.n_hidden), generator=generator) * 0.01
        return {}, {"w": w.to(device),
                    "vbias": torch.zeros((feat,), device=device),
                    "hbias": torch.zeros((self.n_hidden,), device=device)}

    @staticmethod
    def _h_prob(state, v):
        return torch.sigmoid(v @ state["w"] + state["hbias"])

    @staticmethod
    def _v_prob(state, h):
        return torch.sigmoid(h @ state["w"].T + state["vbias"])

    def apply(self, params, state, xs, ctx):
        v = xs[0].reshape(xs[0].shape[0], -1).float()
        return self._h_prob(state, v), state

    def free_energy(self, state, v) -> torch.Tensor:
        """Per-sample free energy ``-v.vbias - sum softplus(v W +
        hbias)``."""
        v = v.reshape(v.shape[0], -1).float()
        return -(v @ state["vbias"]) - torch.nn.functional.softplus(
            v @ state["w"] + state["hbias"]).sum(1)

    def update_state(self, params, state, xs, ctx, uniforms=None):
        """One CD-k step.  ``uniforms`` (``cd_k + 1`` arrays of the hidden
        layer's shape) replaces the generator's draws."""
        v0 = xs[0].reshape(xs[0].shape[0], -1).float()
        h0p = self._h_prob(state, v0)
        if uniforms is None:
            gen = ctx.generator if ctx is not None else None
            if gen is None:
                gen = torch.Generator(device=v0.device).manual_seed(0)
            uniforms = [torch.rand(h0p.shape, generator=gen,
                                   device=v0.device)
                        for _ in range(self.cd_k + 1)]
        u = [(a if torch.is_tensor(a) else torch.from_numpy(np.array(a)))
             .to(v0.device).float() for a in uniforms]
        hk = (u[0] < h0p).float()
        vk = v0
        for i in range(self.cd_k):
            vk = self._v_prob(state, hk)
            hk = (u[i + 1] < self._h_prob(state, vk)).float()
        hkp = self._h_prob(state, vk)
        n = v0.shape[0]
        dw = (v0.T @ h0p - vk.T @ hkp) / n
        dv = (v0 - vk).mean(0)
        dh = (h0p - hkp).mean(0)
        return {"w": state["w"] + self.lr * dw,
                "vbias": state["vbias"] + self.lr * dv,
                "hbias": state["hbias"] + self.lr * dh}

    def reconstruction_error(self, state, v) -> torch.Tensor:
        v = torch.as_tensor(np.asarray(v), device=state["w"].device)
        v = v.reshape(len(v), -1).float()
        vr = self._v_prob(state, self._h_prob(state, v))
        return ((v - vr) ** 2).mean()
