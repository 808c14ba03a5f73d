"""Minibatch row gather: the hand-written CUDA kernels
(``csrc/gather_rows.cu``) and their plain PyTorch versions.

Replaces ``veles_tpu/ops/pallas_kernels.py`` ``gather_rows_packed``
(pallas_call at :818).  Two entries, each routed by ``ops.kernel_route``
(a tensor on a Hopper card launches the kernel, a CPU tensor takes the
plain version):

* :func:`gather_batch` is what the fullbatch loaders
  (``loader/fullbatch.py``) draw every minibatch through: all the arrays
  of a class and the ``@mask`` row in one launch, the indices read on the
  card from the epoch's permutation (:func:`index_tensor`, uploaded once
  an epoch), the rows written into tensors the caller gives (a captured
  step's static inputs, or fresh ones);
* :func:`gather_rows` is the single-array counterpart of
  ``gather_rows_packed``, with host-side indices checked per call.

The TPU's ``pack_rows``/``unpack_rows`` (8, 128) row layout has no
counterpart here: rows are gathered as they lie.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from .. import kernel_route
from . import build

NAME = "gather_rows"
SOURCE = "veles_tpu_torch/csrc/gather_rows.cu"
REPLACES = "veles_tpu/ops/pallas_kernels.py:818"

#: launches of the CUDA kernels (never of the plain versions), by entry:
#: ``"batch"`` (:func:`gather_batch`) and ``"rows"`` (:func:`gather_rows`)
launches = build.LaunchCounter()

_UNITS = (16, 8, 4, 2, 1)
#: arrays one batch launch takes (``MAX_ARRAYS`` in the source)
MAX_ARRAYS = 8


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
    with build.reporting(NAME, lambda: cost([data], len(idx))):
        if kernel_route(data, NAME):
            return _launch(data, idx_t)
        return gather_rows_plain(data, idx_t)


def cost(arrays, m: int, mask: bool = False) -> dict:
    """``{"flops", "bytes"}`` of one launch gathering ``m`` rows of each
    of ``arrays``: each row read and written once, the m int32 indices
    read, and with ``mask`` the m float32 mask entries written."""
    row_bytes = sum(int(np.prod(a.shape[1:])) * a.element_size()
                    for a in arrays)
    return {"flops": 0.0,
            "bytes": float(2 * m * row_bytes + m * 4 + (m * 4 if mask
                                                         else 0))}


def gather_rows_plain(data: torch.Tensor, idx: torch.Tensor):
    """The plain version: ``torch.index_select`` along the first axis."""
    return torch.index_select(data, 0, idx.long())


def index_tensor(order, n_rows: int, length: int, device) -> torch.Tensor:
    """The epoch's row order as the int32 index tensor
    :func:`gather_batch` reads on ``device``: ``order`` (host integers)
    padded with index 0 to ``length`` entries, every entry checked against
    ``n_rows`` here, once (``IndexError`` outside ``[0, n_rows)``).  On
    the card it goes up from pinned memory without blocking the host."""
    order = np.asarray(order)
    if order.ndim != 1 or len(order) > length:
        raise ValueError(f"{NAME}: order must be 1-D with at most "
                         f"{length} entries, got shape {order.shape}")
    if order.size and not np.issubdtype(order.dtype, np.integer):
        raise TypeError(f"{NAME}: order must hold integers")
    if n_rows > np.iinfo(np.int32).max:
        raise ValueError(f"{NAME}: {n_rows} rows exceed int32 indices")
    if order.size and (int(order.min()) < 0 or int(order.max()) >= n_rows):
        raise IndexError(f"{NAME}: index out of range [0, {n_rows}): "
                         f"min {int(order.min())}, max {int(order.max())}")
    host = torch.zeros(length, dtype=torch.int32)
    host[:len(order)] = torch.from_numpy(order.astype(np.int32))
    device = torch.device(device)
    if device.type != "cuda":
        return host.to(device)
    # the caching host allocator keeps the pinned block until the copy ran
    return host.pin_memory().to(device, non_blocking=True)


def gather_batch(arrays, outs, perm: torch.Tensor, offset: int, count: int,
                 mask=None) -> None:
    """One minibatch of every array of a class: ``outs[j][i] =
    arrays[j][perm[offset + i]]`` for ``i < m = len(outs[0])``, bitwise
    ``torch.index_select``, and ``mask[i] = 1.0`` for ``i < count``, 0.0
    for the padding rows (``mask`` float32 (m,), or None).  ``perm`` is
    :func:`index_tensor`'s (already checked); ``outs`` are contiguous,
    each ``(m, *row)`` of its array's dtype.  On the card this is one
    launch: no host-to-device copy, no synchronisation."""
    if not 1 <= len(arrays) <= MAX_ARRAYS or len(outs) != len(arrays):
        raise ValueError(f"{NAME}: 1 to {MAX_ARRAYS} arrays, each with "
                         f"its output, got {len(arrays)} and {len(outs)}")
    m = outs[0].shape[0]
    for a, o in zip(arrays, outs):
        if o.shape != (m,) + tuple(a.shape[1:]) or o.dtype != a.dtype:
            raise ValueError(f"{NAME}: output {tuple(o.shape)} {o.dtype} "
                             f"does not hold {m} rows of {tuple(a.shape)} "
                             f"{a.dtype}")
    if not 0 <= count <= m or offset < 0 or offset + m > perm.shape[0]:
        raise ValueError(f"{NAME}: rows [{offset}, {offset + m}) of a "
                         f"{perm.shape[0]}-entry order, count {count}")
    if mask is not None and (mask.shape != (m,)
                             or mask.dtype != torch.float32):
        raise ValueError(f"{NAME}: mask must be float32 ({m},)")
    with build.reporting(NAME, lambda: cost(arrays, m, mask is not None)):
        if kernel_route(perm, NAME):
            _launch_batch(arrays, outs, perm, offset, m, count, mask)
            return
        gather_batch_plain(arrays, outs, perm, offset, count, mask)


def gather_batch_plain(arrays, outs, perm, offset, count, mask=None):
    """The plain version: ``index_select`` of ``perm[offset:offset+m]``
    into each output, and the ``arange`` padding mask."""
    m = outs[0].shape[0]
    idx = perm[offset:offset + m].long()
    for a, o in zip(arrays, outs):
        torch.index_select(a, 0, idx, out=o)
    if mask is not None:
        mask.copy_(torch.arange(m, device=mask.device) < count)


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


def _fn_batch():
    lib = build.load("gather_rows")
    fn = lib.vt_gather_batch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, ctypes.POINTER(p), ctypes.POINTER(p),
                       ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(i), p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch_batch(arrays, outs, perm, offset, m, count, mask):
    n = len(arrays)
    if not all(t.is_contiguous() for t in (*arrays, *outs, perm)):
        raise ValueError(f"{NAME}: kernel needs contiguous tensors")
    if perm.dtype != torch.int32 or any(
            t.device != perm.device
            for t in (*arrays, *outs, *([] if mask is None else [mask]))):
        raise ValueError(f"{NAME}: int32 order and every tensor on one "
                         "card")
    row_bytes = [math.prod(a.shape[1:]) * a.element_size() for a in arrays]
    if m == 0 or 0 in row_bytes:
        raise ValueError(f"{NAME}: empty rows or batch")
    lib, fn = _fn_batch()
    src = [a.data_ptr() for a in arrays]
    dst = [o.data_ptr() for o in outs]
    units = [copy_unit(rb, s, d) for rb, s, d in zip(row_bytes, src, dst)]
    stream = torch.cuda.current_stream(perm.device).cuda_stream
    rc = fn(n, (ctypes.c_void_p * n)(*src), (ctypes.c_void_p * n)(*dst),
            (ctypes.c_longlong * n)(*row_bytes), (ctypes.c_int * n)(*units),
            perm.data_ptr(), offset, m, count,
            None if mask is None else mask.data_ptr(), stream)
    build.check(lib, rc, NAME)
    launches.inc("batch")


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
    launches.inc("rows")
    return out
