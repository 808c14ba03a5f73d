"""Minibatch row gather: the hand-written CUDA kernel
(``csrc/gather_rows.cu``) and its plain PyTorch version.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``gather_rows_packed``
(pallas_call at :818).  The fullbatch loader (``loader/fullbatch.py``)
draws every minibatch of its device-resident arrays through
:func:`gather_rows`: a tensor on a Hopper card launches the kernel, a CPU
tensor takes :func:`gather_rows_plain` (``torch.index_select``).  The
TPU's ``pack_rows``/``unpack_rows`` (8, 128) row layout has no
counterpart here: rows are gathered as they lie.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernel_route
from . import build

NAME = "gather_rows"
SOURCE = "veles_tpu_torch/csrc/gather_rows.cu"
REPLACES = "veles_tpu/ops/pallas_kernels.py:818"

#: launches of the CUDA kernel (never of the plain version)
launches = build.LaunchCounter()

_UNITS = (16, 8, 4, 2, 1)


def gather_rows(data: torch.Tensor, idx) -> torch.Tensor:
    """``data[idx]`` along the first axis: (N, *sample) -> (m, *sample),
    contiguous, bitwise equal to ``torch.index_select``.  ``idx`` is a
    host-side integer sequence (a numpy chunk of the epoch permutation);
    every index is checked against N on the host before anything runs,
    and one outside ``[0, N)`` raises ``IndexError``."""
    idx = np.asarray(idx)
    if idx.ndim != 1 or (idx.size and not np.issubdtype(idx.dtype,
                                                         np.integer)):
        raise TypeError(f"{NAME}: idx must be a 1-D integer sequence")
    n = data.shape[0]
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"{NAME}: index out of range [0, {n}): "
                         f"min {int(idx.min())}, max {int(idx.max())}")
    idx_t = torch.from_numpy(idx.astype(np.int32)).to(data.device)
    if kernel_route(data, NAME):
        return _launch(data, idx_t)
    return gather_rows_plain(data, idx_t)


def gather_rows_plain(data: torch.Tensor, idx: torch.Tensor):
    """The plain version: ``torch.index_select`` along the first axis."""
    return torch.index_select(data, 0, idx.long())


def copy_unit(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit that divides the row size and every base
    address."""
    for unit in _UNITS:
        if row_bytes % unit == 0 and all(p % unit == 0 for p in ptrs):
            return unit
    return 1


def _fn():
    lib = build.load("gather_rows")
    fn = lib.vt_gather_rows
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(data, idx):
    if not data.is_contiguous():
        raise ValueError(f"{NAME}: kernel needs a contiguous data tensor")
    m = idx.shape[0]
    out = torch.empty((m,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    row_bytes = int(np.prod(data.shape[1:])) * data.element_size()
    if m == 0 or row_bytes == 0:
        return out
    lib, fn = _fn()
    unit = copy_unit(row_bytes, data.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(data.device).cuda_stream
    rc = fn(data.data_ptr(), idx.data_ptr(), out.data_ptr(), m, row_bytes,
            unit, stream)
    build.check(lib, rc, NAME)
    launches.inc()
    return out
