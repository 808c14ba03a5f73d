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

The seed is a one-element int32 tensor holding the uint32's bits (torch
has few uint32 ops), on ``x``'s device: the kernel reads it through a
pointer, as the TPU kernel reads ``seed_ref``, and the plain version with
tensor ops, so neither takes a host value and a step captured as a CUDA
graph replays the mask of whatever seed the host wrote into the slot
(``units/workflow.py`` ``TrainStep``).  A host int is taken too (tests):
it becomes such a tensor first (:func:`seed_tensor`).

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


def splitmix32_tensor(z: torch.Tensor) -> torch.Tensor:
    """:func:`splitmix32` elementwise over int64 tensors holding uint32
    values (no product overflows int64)."""
    z = (z + _GOLDEN) & _M32
    z = _mul32(z ^ (z >> 16), _MIX1)
    z = _mul32(z ^ (z >> 13), _MIX2)
    return z ^ (z >> 16)


def seed_bits(seed: int) -> int:
    """The uint32 ``seed``'s bits as the int32 a seed tensor stores."""
    return int(np.uint32(int(seed) & _M32).view(np.int32))


def seed_tensor(seed, device) -> torch.Tensor:
    """A host seed as the one-element int32 seed tensor on ``device``; a
    tensor passes as it is."""
    if torch.is_tensor(seed):
        return seed
    return torch.tensor([seed_bits(seed)], dtype=torch.int32, device=device)


def keep_mask(n: int, seed, rate: float, device) -> torch.Tensor:
    """The plain version's float32 keep factors (0 or 1/(1 - rate)) of
    ``n`` elements, flat, for the int32 seed tensor (or host int)
    ``seed``."""
    rate32, scale = rate_and_scale(rate)
    lin = torch.arange(n, dtype=torch.int64, device=device) & _M32
    wseed = splitmix32_tensor(
        seed_tensor(seed, device).reshape(-1).long() & _M32)
    bits = splitmix32_tensor(lin ^ wseed)
    u = (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)
    thr = torch.tensor(rate32, device=device)
    return torch.where(u >= thr, torch.tensor(scale, device=device),
                       torch.zeros((), dtype=torch.float32, device=device))


def fused_dropout_plain(x: torch.Tensor, seed,
                        rate: float) -> torch.Tensor:
    """The plain version: the same hash over the flat index in PyTorch
    integer ops (the seed tensor's whitening too), ``x`` times the keep
    factor in float32, rounded to ``x``'s dtype.  ``seed`` as
    :func:`fused_dropout`'s."""
    keep = keep_mask(x.numel(), seed, rate, x.device).reshape(x.shape)
    return (x.float() * keep).to(x.dtype)


def _fn():
    lib = build.load("fused_dropout")
    fn = lib.vt_fused_dropout
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(x: torch.Tensor, seed: torch.Tensor,
            rate: float) -> torch.Tensor:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: the kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if seed.dtype != torch.int32 or seed.device != x.device \
            or seed.numel() != 1:
        raise ValueError(f"{NAME}: the seed must be one int32 element on "
                         f"{x.device}, got {seed.dtype} {tuple(seed.shape)}"
                         f" on {seed.device}")
    rate32, scale = rate_and_scale(rate)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib, fn = _fn()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
            seed.data_ptr(), float(rate32), float(scale), sms, stream)
    build.check(lib, rc, NAME)
    launches.inc()
    return out


def cost(x: torch.Tensor) -> dict:
    """``{"flops", "bytes"}`` of one launch: x read and the output written
    once, the 4-byte seed read; the mask's integer hash is not counted
    as floating-point work."""
    return {"flops": 0.0, "bytes": float(2 * x.numel() * x.element_size()
                                         + 4)}


def _apply(x: torch.Tensor, seed: torch.Tensor,
           rate: float) -> torch.Tensor:
    with build.reporting(NAME, lambda: cost(x)):
        if kernel_route(x, NAME):
            return _launch(x, seed, rate)
        return fused_dropout_plain(x, seed, rate)


class _FusedDropout(torch.autograd.Function):
    """custom_vjp of pallas_kernels.py:718-727: the backward re-runs the
    forward's kernel (or plain version) on the cotangent, reading the
    same seed tensor (saved for backward: a write into it between the
    forward and the backward makes autograd raise)."""

    @staticmethod
    def forward(ctx, x, seed, rate):
        ctx.save_for_backward(seed)
        ctx.rate = rate
        return _apply(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        seed, = ctx.saved_tensors
        return _apply(g, seed, ctx.rate), None, None


def fused_dropout(x: torch.Tensor, seed, rate: float) -> torch.Tensor:
    """Dropout of ``x`` at drop probability ``rate`` in [0, 1): kept
    elements scale by 1/(1 - rate).  ``seed``: the one-element int32 seed
    tensor on ``x``'s device (the train step's slot), or a host int
    (tests), made into one.  Differentiable; the gradient regenerates the
    mask from the same seed."""
    return _FusedDropout.apply(x, seed_tensor(seed, x.device), float(rate))
