"""Dense (all2all) op + weight init (counterpart of
veles_tpu/ops/linear.py).

Weights keep the JAX layout ``(in, out)`` and the op is ``x @ w``, so
weights carried across from a JAX snapshot are used as they are, never
transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def dense(x, w, b=None, *, compute_dtype=None):
    """y = x @ w + b with float32 accumulation.

    x: (batch, in), w: (in, out).  With ``compute_dtype`` set (the bf16
    policy) both operands are rounded to it, and the product is taken in
    float32 over the rounded values and kept in float32 — the JAX
    package's ``preferred_element_type=float32`` contract (products of
    bf16 values are exact in float32).  The result has the operands'
    original dtype, as in the JAX package."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    y = torch.matmul(x, w).to(out_dtype)
    if b is not None:
        y = y + b
    return y


def smart_uniform_init(generator: torch.Generator, shape, fan_in=None,
                       scale: float = 1.0, device=None):
    """Znicz "smart weight init": uniform in ±scale/sqrt(fan_in).  Draws
    from the explicit ``generator`` (a CPU generator keeps the draw the
    same on every device) and moves the result to ``device``."""
    if fan_in is None:
        fan_in = int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]
    limit = scale / np.sqrt(max(fan_in, 1))
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32)
    return ((u * 2 - 1) * limit).to(device)
