"""Fused dropout: the hand-written CUDA kernel (``csrc/fused_dropout.cu``),
its plain PyTorch version, and the ``torch.autograd.Function`` joining
them.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``_dropout_apply``
(pallas_call at :694) and its custom_vjp ``fused_dropout`` (:710-727).
The mask bit of element ``i`` is ``splitmix32(lin ^ splitmix32(seed))``
with ``lin`` its row-major index in the tensor's logical layout mod 2^32
(the JAX package's NHWC for conv activations), so the mask, the forward
and the gradient equal the JAX kernel's bit for bit.  The backward pass
runs the same kernel on the cotangent with the same seed; only the seed
and the rate are saved.

:func:`fused_dropout` routes on its input's device: a CPU tensor takes
:func:`fused_dropout_plain`, a tensor on a Hopper card launches the
kernel, and anything else raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernel_route
from . import build

NAME = "fused_dropout"
SOURCE = "veles_tpu_torch/csrc/fused_dropout.cu"
REPLACES = "veles_tpu/ops/pallas_kernels.py:694"

#: launches of the CUDA kernel (forward and backward; never of the plain
#: version)
launches = build.LaunchCounter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_M32 = 0xFFFFFFFF
_GOLDEN, _MIX1, _MIX2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def splitmix32(z: int) -> int:
    """The kernel's 32-bit finalizer on a host int (pallas_kernels.py
    ``_splitmix32``)."""
    z = (int(z) + _GOLDEN) & _M32
    z = ((z ^ (z >> 16)) * _MIX1) & _M32
    z = ((z ^ (z >> 13)) * _MIX2) & _M32
    return z ^ (z >> 16)


def rate_and_scale(rate: float):
    """(rate, 1 / (1 - rate)) as the float32 values the JAX kernel uses:
    ``rate`` rounded to float32, ``1 - rate`` taken in double and rounded,
    then one float32 division."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"{NAME}: rate must be in [0, 1), got {rate}")
    return np.float32(rate), np.float32(1.0) / np.float32(1.0 - rate)


def _mul32(z: torch.Tensor, m: int) -> torch.Tensor:
    """``z * m mod 2^32`` for int64 tensors holding uint32 values, in
    16-bit halves of ``m`` so no int64 product overflows."""
    lo, hi = m & 0xFFFF, m >> 16
    return (z * lo + (((z * hi) & 0xFFFF) << 16)) & _M32


def _splitmix32_t(z: torch.Tensor) -> torch.Tensor:
    z = (z + _GOLDEN) & _M32
    z = _mul32(z ^ (z >> 16), _MIX1)
    z = _mul32(z ^ (z >> 13), _MIX2)
    return z ^ (z >> 16)


def keep_mask(n: int, seed: int, rate: float, device) -> torch.Tensor:
    """The plain version's float32 keep factors (0 or 1/(1 - rate)) of
    ``n`` elements, flat."""
    rate32, scale = rate_and_scale(rate)
    lin = torch.arange(n, dtype=torch.int64, device=device) & _M32
    bits = _splitmix32_t(lin ^ splitmix32(seed))
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    thr = torch.tensor(rate32, device=device)
    return torch.where(u >= thr, torch.tensor(scale, device=device),
                       torch.zeros((), dtype=torch.float32, device=device))


def fused_dropout_plain(x: torch.Tensor, seed: int,
                        rate: float) -> torch.Tensor:
    """The plain version: the same hash over the flat index in PyTorch
    integer ops, ``x`` times the keep factor in float32, rounded to
    ``x``'s dtype."""
    keep = keep_mask(x.numel(), seed, rate, x.device).reshape(x.shape)
    return (x.float() * keep).to(x.dtype)


def _fn():
    lib = build.load("fused_dropout")
    fn = lib.vt_fused_dropout
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: the kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    rate32, scale = rate_and_scale(rate)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib, fn = _fn()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
            splitmix32(seed), float(rate32), float(scale), sms, stream)
    build.check(lib, rc, NAME)
    launches.inc()
    return out


def _apply(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    if kernel_route(x, NAME):
        return _launch(x, seed, rate)
    return fused_dropout_plain(x, seed, rate)


class _FusedDropout(torch.autograd.Function):
    """custom_vjp of pallas_kernels.py:718-727: the backward re-runs the
    forward's kernel (or plain version) on the cotangent, same seed."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.seed, ctx.rate = seed, rate
        return _apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return _apply(g, ctx.seed, ctx.rate), None, None


def fused_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Dropout of ``x`` with the uint32 ``seed`` (a host int) at drop
    probability ``rate`` in [0, 1): kept elements scale by 1/(1 - rate).
    Differentiable; the gradient regenerates the mask."""
    return _FusedDropout.apply(x, int(seed) & _M32, float(rate))
