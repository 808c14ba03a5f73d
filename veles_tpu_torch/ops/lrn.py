"""Local response normalization across channels (counterpart of
veles_tpu/ops/lrn.py:28-111).

y = x / (k + alpha/n * sum_{j in window} x_j^2)^beta over the trailing
(channel) axis, with the JAX package's window (j - i in [-n//2,
n - 1 - n//2]), its AlexNet alpha/n scaling and its three formulations of
the window sum: ``"cumsum"`` (an exact float32 cumulative-sum
difference), ``"band"`` (a C x C 0/1 band product in float32) and
``"band_bf16"`` (the same band over bf16-rounded squares, float32
accumulation).  ``F.local_response_norm`` is not this function: its
window and alpha scaling differ.  beta = 0.75 runs as
``rsqrt(y * sqrt(y))`` as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# above this channel count the band forms fall back to a windowed sum
_BAND_MATMUL_MAX_C = 2048
METHODS = ("cumsum", "band", "band_bf16")


def _window_sum_cumsum(sq, n: int):
    """sum_{j=i-half}^{i+up} sq[j] = cs[min(i+up, C-1)] - cs[i-half-1],
    both shifted copies made by padding and slicing as the JAX package
    does (an index gather would cost a scattering backward)."""
    half = n // 2
    up = n - 1 - half
    cs = torch.cumsum(sq.float(), dim=-1)
    c = cs.shape[-1]
    edge = cs[..., -1:].expand(*cs.shape[:-1], up)
    hi = torch.cat([cs, edge], dim=-1)[..., up:]
    lo = F.pad(cs, (half + 1, 0))[..., :c]
    return hi - lo


def _window_sum(sq, n: int, method: str = "cumsum"):
    if method not in METHODS:
        raise ValueError(f"LRN method must be 'cumsum', 'band' or "
                         f"'band_bf16', got {method!r}")
    c = sq.shape[-1]
    half = n // 2
    if method == "cumsum":
        return _window_sum_cumsum(sq, n)
    if c <= _BAND_MATMUL_MAX_C:
        idx = torch.arange(c, device=sq.device)
        diff = idx[None, :] - idx[:, None]
        mask = (diff >= -(n - 1 - half)) & (diff <= half)
        operand = sq.reshape(-1, c).float()
        if method == "band_bf16":
            # bf16-rounded squares; their products with a 0/1 band are
            # exact in float32, summed in float32
            operand = operand.to(torch.bfloat16).float()
        return torch.matmul(operand, mask.float()).reshape(sq.shape)
    padded = F.pad(sq, (half, n - 1 - half))
    return padded.unfold(-1, n, 1).sum(-1)


def local_response_norm(x, *, n=5, k=2.0, alpha=1e-4, beta=0.75,
                        method="cumsum"):
    """x: (..., C).  Returns x's dtype."""
    ssum = _window_sum(torch.square(x), n, method)
    y = k + (alpha / n) * ssum
    if beta == 0.75:
        out = x * torch.rsqrt(y * torch.sqrt(y))
    elif beta == 0.5:
        out = x * torch.rsqrt(y)
    elif beta == 1.0:
        out = x / y
    else:
        out = x * torch.pow(y, -beta)
    return out.to(x.dtype)
