"""Loader base: the minibatch-serving contract (a copy of
veles_tpu/loader/base.py, which holds no JAX, rewired to the port).

* **Fixed shapes.** Every batch has ``minibatch_size`` rows; a short last
  batch is padded by repeating index 0, and the ``@mask`` array zeroes
  the padding, so metrics stay exact.
* **Deterministic epochs.** Each epoch is a permutation derived from
  (stream seed, epoch, class) with numpy PCG64 — the JAX package's
  streams, so both packages serve the same minibatch order.
* **Checkpointable.** ``state()``/``set_state()`` capture epoch and
  position, and a normalizer's statistics, in the JAX package's layout.
* **Normalized on the host.** ``ArrayLoader(normalizer=...)`` analyzes
  the train arrays and normalizes every class with the numpy normalizer
  (``normalization.py``) before anything is uploaded, as the JAX
  package does (veles_tpu/loader/base.py:298-316), so the arrays a
  loader holds are bitwise the JAX package's.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .. import prng
from ..logger import Logger

# Reference class order (veles/loader/base.py:72-80).
TEST, VALID, TRAIN = 0, 1, 2
CLASS_NAMES = ("test", "validation", "train")


class LoaderError(Exception):
    pass


class Loader(Logger):
    """Abstract minibatch server.

    Subclasses implement :meth:`load_data` (fill ``class_lengths``) and
    :meth:`fill_minibatch` (produce arrays for given sample indices).
    """

    def __init__(self, minibatch_size: int = 100, *,
                 shuffle_limit: float = np.inf,
                 prng_name: str = "loader",
                 shard_index: int = 0, shard_count: int = 1,
                 train_ratio: float = 1.0, subset_seed: int = 0):
        self.minibatch_size = int(minibatch_size)
        self.class_lengths: List[int] = [0, 0, 0]
        self.shuffle_limit = shuffle_limit  # epochs after which shuffling stops
        self.epoch_number = 0
        self.prng_name = prng_name
        self.shard_index = int(shard_index)
        self.shard_count = int(shard_count)
        # train_ratio < 1 trains on a fixed random subset (ensemble bagging)
        self.train_ratio = float(train_ratio)
        self.subset_seed = int(subset_seed)
        self.normalizer = None
        self._loaded = False

    # -- subclass contract -------------------------------------------------
    def load_data(self) -> None:
        """Populate class_lengths (and any dataset storage)."""
        raise NotImplementedError

    def fill_minibatch(self, indices: np.ndarray, klass: int
                       ) -> Dict[str, np.ndarray]:
        """Return batch arrays for the given within-class sample indices.
        Keys are workflow input names ("@input", "@labels", "@targets")."""
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------
    def initialize(self) -> None:
        if self._loaded:
            return
        self.load_data()
        self._loaded = True
        if sum(self.class_lengths) == 0:
            raise LoaderError("loader has no samples")
        self.info("dataset: test=%d valid=%d train=%d, minibatch=%d",
                  *self.class_lengths, self.minibatch_size)

    @property
    def total_samples(self) -> int:
        return sum(self.class_lengths)

    def class_offset(self, klass: int) -> int:
        """Index of the class's first sample in the loader's global
        order test | validation | train (veles_tpu/loader/base.py:96)."""
        return sum(self.class_lengths[:klass])

    # -- epoch iteration ---------------------------------------------------
    def _train_indices(self, klass: int) -> np.ndarray:
        """Class sample indices, restricted to the bagging subset for
        train when train_ratio < 1."""
        n = self.class_lengths[klass]
        if klass != TRAIN or self.train_ratio >= 1.0:
            return np.arange(n)
        keep = max(1, int(round(n * self.train_ratio)))
        rng = np.random.Generator(
            np.random.PCG64([self.subset_seed, 0xBA66]))
        return np.sort(rng.choice(n, size=keep, replace=False))

    def epoch_permutation(self, klass: int,
                          epoch: Optional[int] = None) -> np.ndarray:
        """Deterministic permutation for (class, epoch). Train shuffles per
        epoch (until shuffle_limit); valid/test are served in order."""
        base = self._train_indices(klass)
        if epoch is None:
            epoch = self.epoch_number
        if klass != TRAIN or epoch >= self.shuffle_limit:
            return base
        seed_stream = prng.get(self.prng_name)
        rng = np.random.Generator(
            np.random.PCG64([seed_stream.seed, epoch, klass]))
        return rng.permutation(base)

    def n_minibatches(self, klass: int) -> int:
        n = len(self._train_indices(klass))
        if self.shard_count > 1:
            n = -(-n // self.shard_count)
        return -(-n // self.minibatch_size) if n else 0

    def epoch_order(self, klass: int, epoch: Optional[int] = None
                    ) -> np.ndarray:
        """The sample order this host serves for (class, epoch): the
        epoch permutation, under sharding its strided slice."""
        perm = self.epoch_permutation(klass, epoch)
        if self.shard_count > 1:
            perm = perm[self.shard_index::self.shard_count]
        return perm

    def iter_epoch(self, klass: int, epoch: Optional[int] = None
                   ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-size padded batches with '@mask'.  Under sharding,
        this host sees a strided slice of the permutation, and every
        shard yields the same number of batches."""
        order = self.epoch_order(klass, epoch)
        for i in range(self.n_minibatches(klass)):
            yield self._fetch_batch(self.chunk(order, i), klass, i)

    def chunk(self, order: np.ndarray, i: int) -> np.ndarray:
        """Batch ``i``'s slice of ``order`` (empty once a shard is
        exhausted: a fully-masked batch)."""
        bs = self.minibatch_size
        chunk = order[i * bs:(i + 1) * bs]
        return chunk if len(chunk) else np.zeros(0, np.int64)

    def _fetch_batch(self, chunk: np.ndarray, klass: int,
                     batch_index: int, **kw) -> Dict[str, np.ndarray]:
        """``make_batch(chunk, klass, **kw)`` with bounded transient-read
        retry: ``OSError`` retries up to ``root.common.loader.retries``
        times with exponential backoff, then raises :class:`LoaderError`
        naming the batch.  The fault harness (``runtime/faults.py``) can
        fail a batch's first fetch or slow every fetch."""
        from ..config import root
        retries = int(root.common.loader.get("retries", 2))
        backoff = float(root.common.loader.get("retry_backoff_s", 0.05))
        attempt = 0
        while True:
            try:
                self._maybe_inject_fault(batch_index)
                return self.make_batch(chunk, klass, **kw)
            except OSError as e:
                if attempt >= retries:
                    raise LoaderError(
                        f"minibatch {batch_index} (class "
                        f"{CLASS_NAMES[klass]}) failed after "
                        f"{attempt + 1} attempts: {e}") from e
                delay = backoff * (2 ** attempt)
                self.warning(
                    "transient read error on minibatch %d (attempt "
                    "%d/%d): %s — retrying in %.2fs", batch_index,
                    attempt + 1, retries + 1, e, delay)
                time.sleep(delay)
                attempt += 1

    def _maybe_inject_fault(self, batch_index: int) -> None:
        """An armed ``loader_ioerror_at_batch`` raises OSError on the
        first fetch of that index (so the retry above recovers);
        ``slow_batch_ms`` stalls every fetch (veles_tpu/loader/base.py
        :192-208)."""
        from ..runtime import faults
        if not faults.enabled():
            return
        plan = faults.get_plan()
        if plan.slow_batch_ms > 0:
            time.sleep(plan.slow_batch_ms / 1e3)
        if (batch_index in plan.loader_ioerror_at_batch
                and faults.fire_once("loader_ioerror", batch_index)):
            raise OSError(
                f"injected loader IOError at batch {batch_index}")

    def make_batch(self, chunk: np.ndarray, klass: int
                   ) -> Dict[str, np.ndarray]:
        bs = self.minibatch_size
        valid_n = len(chunk)
        if valid_n < bs:  # pad by repeating index 0; mask zeroes them out
            pad = np.zeros(bs - valid_n, dtype=chunk.dtype)
            chunk = np.concatenate([chunk, pad])
        batch = self.fill_minibatch(chunk, klass)
        mask = np.zeros(bs, np.float32)
        mask[:valid_n] = 1.0
        if "@mask" in batch:
            # loader-supplied mask: AND it with the padding mask
            m = np.asarray(batch["@mask"], np.float32)
            batch["@mask"] = m * mask.reshape((bs,) + (1,) * (m.ndim - 1))
        else:
            batch["@mask"] = mask
        return batch

    def next_epoch(self) -> None:
        self.epoch_number += 1

    # -- label statistics (veles_tpu/loader/base.py:226-250) ----------------
    def analyze_label_distribution(self, labels_by_class: Dict[int, Sequence]
                                   ) -> Dict[str, dict]:
        """Per-class label histogram and a chi-square-style balance
        figure between the train and validation label distributions."""
        report, hists = {}, {}
        for klass, labels in labels_by_class.items():
            vals, counts = np.unique(np.asarray(labels), return_counts=True)
            hists[klass] = dict(zip(vals.tolist(), counts.tolist()))
            report[CLASS_NAMES[klass]] = hists[klass]
        if TRAIN in hists and VALID in hists and hists[VALID]:
            keys = sorted(set(hists[TRAIN]) | set(hists[VALID]))
            tr = np.array([hists[TRAIN].get(k, 0) for k in keys], np.float64)
            va = np.array([hists[VALID].get(k, 0) for k in keys], np.float64)
            expected = tr / max(tr.sum(), 1) * va.sum()
            with np.errstate(divide="ignore", invalid="ignore"):
                chi2 = float(np.nansum(
                    np.where(expected > 0,
                             np.square(va - expected) / expected, 0.0)))
            report["train_valid_chi2"] = chi2
        return report

    # -- checkpointable state ----------------------------------------------
    def state(self) -> dict:
        st = {"epoch_number": self.epoch_number,
              "minibatch_size": self.minibatch_size,
              "shard_index": self.shard_index,
              "shard_count": self.shard_count,
              "train_ratio": self.train_ratio,
              "subset_seed": self.subset_seed}
        if self.normalizer is not None:
            st["normalizer"] = {
                "mapping": type(self.normalizer).MAPPING,
                "state": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                          for k, v in self.normalizer.state().items()},
            }
        return st

    def set_state(self, st: dict) -> None:
        self.epoch_number = int(st["epoch_number"])
        self.minibatch_size = int(st["minibatch_size"])
        # shard_index/shard_count are topology, not training state: they
        # stay in state() for inspection only
        self.train_ratio = float(st.get("train_ratio", 1.0))
        self.subset_seed = int(st.get("subset_seed", 0))
        norm = st.get("normalizer")
        if norm:
            from ..normalization import NormalizerRegistry
            if (self.normalizer is None
                    or type(self.normalizer).MAPPING != norm["mapping"]):
                self.normalizer = NormalizerRegistry.create(norm["mapping"])
            self.normalizer.set_state({
                k: (np.asarray(v, np.float32) if isinstance(v, list) else v)
                for k, v in norm["state"].items()})


class ArrayLoader(Loader):
    """Loader over in-memory numpy arrays: ``data[klass]`` -> (N, ...)
    inputs; ``labels[klass]`` -> (N,) int labels or None;
    ``targets[klass]`` -> regression targets or None; ``normalizer`` (a
    ``normalization`` normalizer or None) analyzes the train inputs and
    normalizes every class's in ``load_data``."""

    def __init__(self, data: Dict[int, np.ndarray],
                 labels: Optional[Dict[int, np.ndarray]] = None,
                 targets: Optional[Dict[int, np.ndarray]] = None,
                 normalizer=None, **kw):
        super().__init__(**kw)
        self._data = data
        self._labels = labels or {}
        self._targets = targets or {}
        self.normalizer = normalizer

    def load_data(self):
        for klass in (TEST, VALID, TRAIN):
            arr = self._data.get(klass)
            self.class_lengths[klass] = 0 if arr is None else len(arr)
        if self.normalizer is not None:
            if self._data.get(TRAIN) is not None:  # stats from train only
                self.normalizer.analyze(self._data[TRAIN])
            for klass in (TEST, VALID, TRAIN):
                if self._data.get(klass) is not None:
                    self._data[klass] = self.normalizer.normalize(
                        self._data[klass])

    def fill_minibatch(self, indices, klass):
        batch = {"@input": self._data[klass][indices]}
        if klass in self._labels and self._labels[klass] is not None:
            batch["@labels"] = self._labels[klass][indices]
        if klass in self._targets and self._targets[klass] is not None:
            batch["@targets"] = self._targets[klass][indices]
        return batch
