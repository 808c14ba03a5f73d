"""Fullbatch loaders: the whole dataset held on the card, each minibatch
gathered there (counterpart of veles_tpu/loader/fullbatch.py:37-384:
``FullBatchLoader`` and the image store's ``FullBatchAugmentedLoader``).

``initialize`` uploads every class's arrays once.  An epoch uploads its
row order once (``gather_rows.index_tensor``: padded with index 0 to
whole minibatches, checked against the row count on the host, copied
from pinned memory without blocking), and each batch is then a
:class:`DeviceBatch`: ``(offset, count)`` into that order.  Its
:meth:`~DeviceBatch.gather` draws every array of the class and the
``@mask`` row in one launch of the ``gather_batch`` kernel
(``ops/kernels/gather_rows.py``, the counterpart of the TPU's
``gather_rows_packed``, as the JAX loader gathers a class's whole tree in
one jitted call, fullbatch.py:149-171), into tensors the caller gives (a
captured step's static inputs) or fresh ones; read as a mapping, a
``DeviceBatch`` gathers into fresh tensors on first use.  Not carried
over: the TPU's packed row layout, its row-size envelope and autotune
pick (on the card the kernel is the gather), and the silent host fallback
after a failed upload — a failed upload raises here.  ``force_host=True``
is the caller's explicit choice of the host gather (numpy batches).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import resolve_device
from ..ops.kernels.gather_rows import gather_batch, index_tensor
from ..units.base import Spec
from .base import ArrayLoader, TEST, TRAIN, VALID


class DeviceBatch(Mapping):
    """One minibatch of a card-resident class before its gather: rows
    ``[offset, offset + minibatch)`` of the epoch's order ``perm`` (an
    index tensor on the card), ``count`` of them real, the rest padding.
    ``aug`` carries the augmented loader's crop offsets and flips."""

    __slots__ = ("loader", "klass", "perm", "offset", "count", "aug",
                 "_fresh")

    def __init__(self, loader, klass, perm, offset, count, aug=None):
        self.loader, self.klass, self.perm = loader, klass, perm
        self.offset, self.count, self.aug = offset, count, aug
        self._fresh = None

    def gather(self, out: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
        """The batch's tensors, written into ``out``'s (same keys, shapes
        and dtypes as :meth:`specs`) or into fresh ones."""
        return self.loader.gather_batch(self, out)

    def specs(self) -> Dict[str, Spec]:
        return self.loader.batch_specs(self.klass)

    def _batch(self):
        if self._fresh is None:
            self._fresh = self.gather()
        return self._fresh

    def __getitem__(self, key):
        return self._batch()[key]

    def __iter__(self):
        return iter(self._batch())

    def __len__(self):
        return len(self._batch())


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

    def iter_epoch(self, klass, epoch=None):
        """The base contract; on the card every batch is a
        :class:`DeviceBatch` over the epoch's order, uploaded once."""
        if not self.on_device:
            yield from super().iter_epoch(klass, epoch)
            return
        order = self.epoch_order(klass, epoch)
        n = self.n_minibatches(klass)
        bs = self.minibatch_size
        perm = index_tensor(order, self.class_lengths[klass], n * bs,
                            self.device)
        for i in range(n):
            yield self._fetch_batch(self.chunk(order, i), klass, i,
                                    perm=perm, offset=i * bs)

    def make_batch(self, chunk: np.ndarray, klass: int, *, perm=None,
                   offset: int = 0):
        """On the card, the :class:`DeviceBatch` of ``chunk``: rows
        ``offset`` on of the epoch's order ``perm`` (``iter_epoch``'s)."""
        if not self.on_device:
            return super().make_batch(chunk, klass)
        if perm is None:
            raise ValueError("a card-resident batch reads the epoch's "
                             "order on the card: make it through "
                             "iter_epoch")
        return DeviceBatch(self, klass, perm, offset, len(chunk))

    def batch_specs(self, klass: int) -> Dict[str, Spec]:
        """Shape and dtype of every tensor of a class's device batch."""
        m = self.minibatch_size
        out = {key: Spec((m,) + tuple(arr.shape[1:]), arr.dtype)
               for key, arr in self._dev_data[klass].items()}
        out["@mask"] = Spec((m,), torch.float32)
        return out

    def gather_batch(self, ref: DeviceBatch, out=None
                     ) -> Dict[str, torch.Tensor]:
        """Every array of ``ref``'s class and its ``@mask`` in one
        ``gather_batch`` launch, into ``out``'s tensors where given."""
        arrays = self._dev_data[ref.klass]
        m = self.minibatch_size
        out = out or {}
        batch = {key: out[key] if key in out else torch.empty(
            (m,) + tuple(arr.shape[1:]), dtype=arr.dtype, device=arr.device)
            for key, arr in arrays.items()}
        batch["@mask"] = out["@mask"] if "@mask" in out else torch.empty(
            m, dtype=torch.float32, device=self.device)
        gather_batch(list(arrays.values()), [batch[k] for k in arrays],
                     ref.perm, ref.offset, ref.count, batch["@mask"])
        return batch


class FullBatchAugmentedLoader(FullBatchLoader):
    """Random crop + mirror over a uint8 image store held on the card
    (counterpart of veles_tpu/loader/fullbatch.py:232-384).

    Train batches get crop offsets and flips drawn from (loader seed,
    epoch, class, first index) by numpy PCG64 (``_draw_aug``, copied as
    is), so crops and flips are the JAX package's bits; valid/test
    batches get the center crop and no flip.  Per step the host sends a
    (B, 2) offset array and a (B,) flip mask: the rows come through the
    ``gather_batch`` kernel, and the crop and mirror are one
    advanced-indexing op with per-sample row and column index tensors (a
    mirrored sample's column index runs backwards).
    ``force_host=True`` takes the host form (:meth:`fill_minibatch`),
    pixel-identical."""

    def __init__(self, *args, crop_hw, mirror: bool = True, **kw):
        super().__init__(*args, **kw)
        self.crop_hw = tuple(int(c) for c in crop_hw)
        self.mirror = bool(mirror)
        self._aug_epoch = 0

    def initialize(self):
        # validated before the (GB-scale) upload
        ch, cw = self.crop_hw
        for klass in (TEST, VALID, TRAIN):
            if self._data.get(klass) is None:
                continue
            if self._data[klass].ndim < 3:
                raise ValueError(
                    f"class-{klass} store must be (N, H, W[, C]) images, "
                    f"got shape {self._data[klass].shape}")
            hs, ws = self._store_hw(klass)
            if ch > hs or cw > ws:
                raise ValueError(
                    f"crop_hw {self.crop_hw} exceeds class-{klass} store "
                    f"geometry {(hs, ws)}")
        super().initialize()

    def _store_hw(self, klass: int):
        return self._data[klass].shape[1:3]

    def iter_epoch(self, klass, epoch=None):
        # only a TRAIN iterator sets the epoch the crops are drawn for
        if klass == TRAIN:
            self._aug_epoch = (self.epoch_number if epoch is None
                               else int(epoch))
        yield from super().iter_epoch(klass, epoch)

    def _draw_aug(self, n: int, klass: int, anchor: int):
        """(offsets (n,2) int32, flips (n,) bool) for one minibatch —
        deterministic in (loader seed, epoch, klass, first index),
        matching the epoch_permutation determinism contract."""
        hs, ws = self._store_hw(klass)
        ch, cw = self.crop_hw
        if klass == TRAIN:
            from .. import prng
            rng = np.random.Generator(np.random.PCG64(
                [prng.get(self.prng_name).seed, self._aug_epoch, klass,
                 anchor, 0xC407]))
            offs = np.stack([rng.integers(0, hs - ch + 1, n),
                             rng.integers(0, ws - cw + 1, n)],
                            1).astype(np.int32)
            flips = (rng.random(n) < 0.5) if self.mirror \
                else np.zeros(n, bool)
        else:
            offs = np.broadcast_to(
                np.array([(hs - ch) // 2, (ws - cw) // 2], np.int32),
                (n, 2)).copy()
            flips = np.zeros(n, bool)
        return offs, flips

    def crop(self, imgs: torch.Tensor, offs, flips) -> torch.Tensor:
        """(B, H, W, ...) -> (B, ch, cw, ...): each sample's crop at its
        offset, columns reversed where it flips, as one indexing op."""
        dev = imgs.device
        ch, cw = self.crop_hw
        offs = torch.from_numpy(np.asarray(offs, np.int64)).to(dev)
        flips = torch.from_numpy(np.asarray(flips, bool)).to(dev)
        ar_h = torch.arange(ch, device=dev)
        ar_w = torch.arange(cw, device=dev)
        rows = offs[:, :1] + ar_h
        cols = offs[:, 1:] + torch.where(flips[:, None], cw - 1 - ar_w, ar_w)
        b = torch.arange(imgs.shape[0], device=dev)
        return imgs[b[:, None, None], rows[:, :, None], cols[:, None, :]]

    def make_batch(self, chunk: np.ndarray, klass: int, **kw):
        batch = super().make_batch(chunk, klass, **kw)
        if isinstance(batch, DeviceBatch):
            anchor = int(chunk[0]) if len(chunk) else 0
            batch.aug = self._draw_aug(self.minibatch_size, klass, anchor)
        return batch

    def batch_specs(self, klass: int) -> Dict[str, Spec]:
        out = super().batch_specs(klass)
        s = out["@input"]
        out["@input"] = Spec(s.shape[:1] + self.crop_hw + s.shape[3:],
                             s.dtype)
        return out

    def gather_batch(self, ref: DeviceBatch, out=None):
        """The store's rows in one launch (whole images, into a scratch
        tensor), then the crop and mirror into ``@input``."""
        scratch = {k: v for k, v in (out or {}).items() if k != "@input"}
        batch = super().gather_batch(ref, scratch)
        crop = self.crop(batch["@input"], *ref.aug)
        batch["@input"] = crop if not out else out["@input"].copy_(crop)
        return batch

    def fill_minibatch(self, indices, klass):
        """The host form: numpy slicing, pixel-identical to the device
        path (same ``_draw_aug`` descriptors)."""
        batch = super().fill_minibatch(indices, klass)
        ch, cw = self.crop_hw
        offs, flips = self._draw_aug(
            len(indices), klass, int(indices[0]) if len(indices) else 0)
        imgs = batch["@input"]
        out = np.empty(imgs.shape[:1] + (ch, cw) + imgs.shape[3:],
                       imgs.dtype)
        for i in range(len(imgs)):
            oy, ox = offs[i]
            c = imgs[i, oy:oy + ch, ox:ox + cw]
            out[i] = c[:, ::-1] if flips[i] else c
        batch["@input"] = out
        return batch
