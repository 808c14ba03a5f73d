"""Activation functions and rotary position embedding (counterpart of
veles_tpu/ops/activations.py).

RoPE rotates INTERLEAVED pairs ``(x[2i], x[2i+1])`` — the JAX package's
convention — not the split halves ``(x[i], x[i + D/2])`` common in PyTorch
code; the two are different functions of the same weights.
"""

from __future__ import annotations

import torch


class _ReLU(torch.autograd.Function):
    """``max(x, 0)`` with the JAX package's gradient: ``jnp.maximum``
    splits a tie evenly, so the gradient at exactly 0 is 0.5 (1 above,
    0 below), where ``torch.clamp_min``'s is 1.  The forward is
    ``clamp_min`` itself, bit for bit."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # heaviside: 0 below, 1 above, the given 0.5 at 0 (and 0 at NaN),
        # the factor JAX multiplies the cotangent by
        half = torch.full((), 0.5, dtype=x.dtype, device=x.device)
        return g * torch.heaviside(x, half).to(g.dtype)


def relu(x):
    return _ReLU.apply(x)


def scaled_tanh(x):
    return 1.7159 * torch.tanh(0.6666 * x)


def sincos(x):
    """Even feature indices -> sin, odd -> cos."""
    idx = torch.arange(x.shape[-1], device=x.device)
    return torch.where(idx % 2 == 0, torch.sin(x), torch.cos(x))


def identity(x):
    return x


ACTIVATIONS = {
    "linear": identity,
    "relu": relu,
    "tanh": scaled_tanh,
    "raw_tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "sincos": sincos,
}


def rope_inv_freq(half: int, base: float, device) -> torch.Tensor:
    """Per-pair angular frequency ``base ** (-i / half)``, float32."""
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    # a fill, not a host-to-device copy, so a captured step can hold it
    return torch.pow(torch.full((), base, dtype=torch.float32,
                                device=device), exponent)


def rotate_pairs(x, cos, sin):
    """Rotate interleaved pairs of ``x`` (..., D) by angles whose cos/sin
    broadcast against (..., D/2)."""
    x1 = x[..., 0::2]
    x2 = x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def rotary_embedding(x, *, base: float = 10000.0, offset: int = 0):
    """Rotary position embedding over (B, T, H, D) with even D: pairs
    (x[2i], x[2i+1]) rotate by angle pos / base^(2i/D), pos = offset + t.
    cos/sin are computed in float32 and cast to ``x.dtype`` before the
    rotation, as in the JAX package."""
    B, T, H, D = x.shape
    if D % 2:
        raise ValueError(f"RoPE needs an even head dim, got {D}")
    inv_freq = rope_inv_freq(D // 2, base, x.device)
    pos = offset + torch.arange(T, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * inv_freq[None, :]                 # (T, half)
    cos = torch.cos(ang)[None, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[None, :, None, :].to(x.dtype)
    return rotate_pairs(x, cos, sin)
