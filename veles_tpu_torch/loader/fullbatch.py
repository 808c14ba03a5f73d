"""Fullbatch loader: the whole dataset held on the card, each minibatch
gathered there (counterpart of veles_tpu/loader/fullbatch.py:37-230,
``FullBatchLoader`` only).

``initialize`` uploads every class's arrays once; ``make_batch`` sends
only the minibatch's indices (a few bytes), gathers every device-resident
array through the ``gather_rows`` kernel (``ops/kernels/gather_rows.py``,
the counterpart of the TPU's ``gather_rows_packed``) and builds ``@mask``
on the device.  Not carried over: the TPU's packed row layout, its
row-size envelope and autotune pick (on the card the kernel is the
gather), and the silent host fallback after a failed upload — a failed
upload raises here.  ``force_host=True`` is the caller's explicit choice
of the host gather (numpy batches).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.kernels.gather_rows import gather_rows
from .base import ArrayLoader, TEST, TRAIN, VALID


class FullBatchLoader(ArrayLoader):
    """ArrayLoader whose gather happens on the device (default: the CUDA
    card, see ``ops.resolve_device``)."""

    def __init__(self, *args, device=None, force_host: bool = False, **kw):
        super().__init__(*args, **kw)
        self._device = device
        self._force_host = force_host
        self._dev_data: Dict[int, Dict[str, torch.Tensor]] = {}
        self.on_device = False

    def initialize(self):
        super().initialize()
        if self._force_host or self.on_device:
            return
        self._upload()
        self.on_device = True

    @property
    def device(self) -> torch.device:
        return resolve_device(self._device)

    def _upload(self):
        dev = self.device
        for klass in (TEST, VALID, TRAIN):
            if self.class_lengths[klass] == 0:
                continue
            entry = {"@input": torch.from_numpy(
                np.ascontiguousarray(self._data[klass])).to(dev)}
            for key, arrays in (("@labels", self._labels),
                                ("@targets", self._targets)):
                if arrays.get(klass) is not None:
                    entry[key] = torch.from_numpy(
                        np.ascontiguousarray(arrays[klass])).to(dev)
            self._dev_data[klass] = entry

    def padded_index(self, chunk: np.ndarray) -> np.ndarray:
        """The chunk padded to the minibatch with index 0 (the padding
        rows are masked out)."""
        idx = np.zeros(self.minibatch_size, np.int64)
        idx[:len(chunk)] = chunk
        return idx

    def padding_mask(self, valid_n: int) -> torch.Tensor:
        """(minibatch,) float32 on the device: 1 for the chunk's rows, 0
        for padding."""
        return (torch.arange(self.minibatch_size, device=self.device)
                < valid_n).float()

    def make_batch(self, chunk: np.ndarray, klass: int):
        if not self.on_device:
            return super().make_batch(chunk, klass)
        idx = self.padded_index(chunk)
        batch = {key: gather_rows(arr, idx)
                 for key, arr in self._dev_data[klass].items()}
        batch["@mask"] = self.padding_mask(len(chunk))
        return batch
