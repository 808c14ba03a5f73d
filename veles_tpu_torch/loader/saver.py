"""Minibatch capture/replay.

Reference parity: veles/loader/saver.py — ``MinibatchesSaver`` dumped every
served minibatch to a snappy-compressed stream; ``MinibatchesLoader``
replayed them for dataset-free training (ship the minibatch file instead of
the dataset).

TPU redesign: one compressed .npz per capture with stacked batch arrays —
portable, seekable, no codec dependency.

(The port's copy of veles_tpu/loader/saver.py, which holds no
JAX: the same batches from the same files, rewired to the port's
package.)
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from .base import Loader, TEST, TRAIN, VALID


class MinibatchesSaver:
    """Wrap a loader; record every batch it serves."""

    def __init__(self, loader: Loader):
        self.loader = loader
        self.captured: Dict[int, List[dict]] = {TEST: [], VALID: [],
                                                TRAIN: []}

    def initialize(self):
        self.loader.initialize()

    def iter_epoch(self, klass: int, epoch=None):
        for batch in self.loader.iter_epoch(klass, epoch):
            # a device loader's batch holds tensors on the card
            host = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                        else np.asarray(v)) for k, v in batch.items()}
            self.captured[klass].append(host)
            yield batch

    def save(self, path: str) -> str:
        arrays = {}
        meta = []
        for klass, batches in self.captured.items():
            for i, b in enumerate(batches):
                for key, arr in b.items():
                    arrays[f"c{klass}_b{i}_{key.lstrip('@')}"] = arr
            meta.append(len(batches))
        arrays["__meta__"] = np.asarray(meta)
        keys = sorted({key.lstrip("@") for bs in self.captured.values()
                       for b in bs for key in b})
        arrays["__keys__"] = np.asarray(keys)
        np.savez_compressed(path, **arrays)
        return path


class MinibatchesLoader(Loader):
    """Replay captured minibatches (dataset-free training)."""

    def __init__(self, path: str, **kw):
        super().__init__(**kw)
        self.path = path
        self._batches: Dict[int, List[dict]] = {}

    def load_data(self):
        with np.load(self.path, allow_pickle=False) as z:
            meta = z["__meta__"]
            keys = [str(k) for k in z["__keys__"]]
            for klass in (TEST, VALID, TRAIN):
                n = int(meta[klass])
                batches = []
                for i in range(n):
                    b = {}
                    for key in keys:
                        zkey = f"c{klass}_b{i}_{key}"
                        if zkey in z:
                            b["@" + key] = z[zkey]
                    batches.append(b)
                self._batches[klass] = batches
                bs = (len(next(iter(batches[0].values())))
                      if batches else 0)
                self.class_lengths[klass] = sum(
                    int(b.get("@mask", np.ones(bs)).sum())
                    for b in batches)
        if self._batches[TRAIN]:
            self.minibatch_size = len(
                next(iter(self._batches[TRAIN][0].values())))

    def n_minibatches(self, klass):
        return len(self._batches.get(klass, []))

    def iter_epoch(self, klass: int, epoch=None):
        yield from self._batches.get(klass, [])

    def fill_minibatch(self, indices, klass):  # replay path bypasses this
        raise NotImplementedError("MinibatchesLoader replays whole batches")
