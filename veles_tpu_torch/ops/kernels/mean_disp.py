"""Mean/dispersion normalize: the hand-written CUDA kernel
(``csrc/mean_disp.cu``) and its plain PyTorch version.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``mean_disp_normalize``
(pallas_call at :760): ``(float32(x) - mean) * rdisp`` over a batch
``x`` of shape (N, *features), uint8 or float32, with ``mean`` and
``rdisp`` of the features' shape; the result is float32, bitwise equal
to the JAX kernel's and to its XLA form (``veles_tpu/ops/normalize.py``).

:func:`mean_disp_normalize` routes on its input's device: a CPU tensor
takes :func:`mean_disp_normalize_plain`, a tensor on a Hopper card
launches the kernel, and anything else raises.  No gradient flows: the
normalizer is the first unit and its statistics are not trained.

The wrapper calls the custom op ``torch.ops.veles_tpu_torch.
mean_disp_normalize``: its CUDA implementation launches the kernel (the
launch counter moves there and nowhere else), its CPU implementation is
the plain version, and its fake implementation gives ``torch.export``
the output's shape, so a sealed forward program (``export/compiled.py``)
calls the kernel as the live forward does.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernel_route
from . import build

NAME = "mean_disp_normalize"
SOURCE = "veles_tpu_torch/csrc/mean_disp.cu"
REPLACES = "veles_tpu/ops/pallas_kernels.py:760"

#: launches of the CUDA kernel (never of the plain version)
launches = build.LaunchCounter()

_DTYPES = {torch.uint8: 0, torch.float32: 1}


def _check(x, mean, rdisp):
    if x.dim() < 1:
        raise ValueError(f"{NAME}: x needs a leading batch axis")
    feat = tuple(x.shape[1:])
    for name, t in (("mean", mean), ("rdisp", rdisp)):
        if int(np.prod(t.shape)) != int(np.prod(feat)):
            raise ValueError(f"{NAME}: {name} has shape {tuple(t.shape)}, "
                             f"the samples {feat}")


def mean_disp_normalize_plain(x: torch.Tensor, mean: torch.Tensor,
                              rdisp: torch.Tensor) -> torch.Tensor:
    """The plain version: ``(x.float() - mean) * rdisp``, float32."""
    _check(x, mean, rdisp)
    feat = tuple(x.shape[1:])
    return (x.float() - mean.float().reshape(feat)) \
        * rdisp.float().reshape(feat)


def mean_disp_normalize(x: torch.Tensor, mean: torch.Tensor,
                        rdisp: torch.Tensor) -> torch.Tensor:
    """``(float32(x) - mean) * rdisp`` for x (N, *features), uint8 or
    float32; float32 result of x's shape."""
    _check(x, mean, rdisp)
    with build.reporting(NAME, lambda: cost(x, mean)):
        return _op(x, mean, rdisp)


@torch.library.custom_op("veles_tpu_torch::mean_disp_normalize",
                         mutates_args=(), device_types="cpu")
def _op(x: torch.Tensor, mean: torch.Tensor,
        rdisp: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return mean_disp_normalize_plain(x, mean, rdisp)


@_op.register_kernel("cuda")
def _op_cuda(x, mean, rdisp):
    """The op's CUDA implementation: the kernel, routed as every wrapper
    routes (``kernel_route`` raises on a card it is not built for)."""
    if kernel_route(x, NAME):
        return _launch(x, mean, rdisp)
    return mean_disp_normalize_plain(x, mean, rdisp)


@_op.register_fake
def _op_fake(x, mean, rdisp):
    return x.new_empty(x.shape, dtype=torch.float32)


build.register_op(_op, NAME, lambda x, mean, rdisp: cost(x, mean))


def cost(x: torch.Tensor, mean: torch.Tensor) -> dict:
    """``{"flops", "bytes"}`` of one launch: x read and the float32
    output written once, mean and rdisp (float32) read once; a subtract
    and a multiply an element."""
    return {"flops": float(2 * x.numel()),
            "bytes": float(x.numel() * x.element_size() + x.numel() * 4
                           + 2 * mean.numel() * 4)}


def _fn():
    lib = build.load("mean_disp")
    fn = lib.vt_mean_disp
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(x, mean, rdisp):
    _check(x, mean, rdisp)
    if x.dtype not in _DTYPES:
        raise TypeError(f"{NAME}: the kernel takes uint8 or float32 input, "
                        f"got {x.dtype}")
    for name, t in (("mean", mean), ("rdisp", rdisp)):
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(f"{NAME}: {name} must be float32 on {x.device}")
    x = x.contiguous()
    mean, rdisp = mean.contiguous(), rdisp.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    rows = x.shape[0]
    features = x.numel() // rows if rows else 0
    if out.numel() == 0:
        return out
    lib, fn = _fn()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), mean.data_ptr(), rdisp.data_ptr(), out.data_ptr(),
            rows, features, _DTYPES[x.dtype], stream)
    build.check(lib, rc, NAME)
    launches.inc()
    return out
