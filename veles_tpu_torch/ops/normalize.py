"""Mean/dispersion normalization op (counterpart of
veles_tpu/ops/normalize.py:17-22): ``(x - mean) * rdisp`` in float32,
through the ``mean_disp`` kernel on the card (its plain version on the
CPU).  The JAX package's XLA and Pallas forms are bitwise equal, so the
port has one form.
"""

from __future__ import annotations

import torch

from .kernels.mean_disp import mean_disp_normalize as _kernel


def mean_disp_normalize(x, mean, rdisp, dtype=torch.float32):
    """x: (N, *features) uint8 or float32 -> float32 of x's shape."""
    if dtype != torch.float32:
        raise NotImplementedError(
            f"mean_disp_normalize to {dtype}: the port normalizes to "
            "float32 only (the normalizer unit's output type)")
    return _kernel(x, mean, rdisp)
