"""Matrix row/column reduction (counterpart of veles_tpu/ops/reduce.py,
``matrix_reduce``): a sum, max, min or mean over one axis, which
PyTorch's reductions compute (the JAX package leaves it to XLA's
``jnp`` reductions; no kernel of either package is involved)."""

from __future__ import annotations

import torch


def _max(x, axis):
    return torch.amax(x, dim=axis)


def _min(x, axis):
    return torch.amin(x, dim=axis)


def _mean(x, axis):
    # XLA's mean: the sum times the reciprocal of the count rounded to
    # the input's type (not a division), bit for bit
    return torch.sum(x, dim=axis) * (1.0 / x.shape[axis])


def matrix_reduce(x, axis=0, op="sum"):
    fns = {"sum": torch.sum, "max": _max, "min": _min, "mean": _mean}
    return fns[op](x, axis)
