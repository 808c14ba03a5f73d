"""Image loading pipeline.

Reference parity: the PIL-based image stack (reference:
veles/loader/image.py:106 ImageLoader — decode, scale, crop, mirror,
rotation, color space, background blending; file scanning with
auto-labeling from path regex, veles/loader/file_image.py:53-177;
fullbatch variant veles/loader/fullbatch_image.py:56).

TPU redesign: decoding/augment happens on host into numpy (the device gets
fixed-shape normalized batches); scale/crop/mirror keep the reference
semantics. Heavy random augmentation is deterministic per (epoch, index)
via the loader PRNG stream, so distributed shards and checkpoint resume
reproduce the exact pixel stream.

(The port's copy of veles_tpu/loader/image.py, which holds no
JAX: the same batches from the same files, rewired to the port's
package.)
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .base import Loader, TEST, TRAIN, VALID


def _pil():
    from PIL import Image
    return Image


class ImageLoader(Loader):
    """Base for image loaders: decode → scale → crop → (mirror) → float.

    scale: (W, H) target;  crop: (W, H) center crop after scale;
    mirror: "random" | True | False;  grayscale: collapse channels;
    rotations: sequence of degrees to sample per train image (reference:
    rotation augmentation, veles/loader/image.py:106);
    background: None | float | array — fill revealed by rotation/crop
    (reference: background blending).
    """

    def __init__(self, scale: Tuple[int, int] = (32, 32),
                 crop: Optional[Tuple[int, int]] = None,
                 mirror=False, grayscale: bool = False,
                 rotations: Optional[Tuple[float, ...]] = None,
                 background=None, **kw):
        super().__init__(**kw)
        self.scale = tuple(scale)
        self.crop = tuple(crop) if crop else None
        self.mirror = mirror
        self.grayscale = grayscale
        self.rotations = tuple(rotations) if rotations else None
        self.background = background

    # -- subclass contract: sample keys ------------------------------------
    def get_image_paths(self, klass: int) -> List[str]:
        raise NotImplementedError

    def get_label(self, path: str) -> int:
        raise NotImplementedError

    # -- pipeline ----------------------------------------------------------
    def decode(self, path: str) -> np.ndarray:
        Image = _pil()
        with Image.open(path) as im:
            im = im.convert("L" if self.grayscale else "RGB")
            im = im.resize(self.scale, Image.BILINEAR)
            arr = np.asarray(im, np.float32)
        if self.grayscale:
            arr = arr[..., None]
        return arr

    def _bg_value(self, arr: np.ndarray):
        if self.background is None:
            return 0.0
        if np.isscalar(self.background):
            return float(self.background)
        return np.asarray(self.background, np.float32)

    def augment(self, arr: np.ndarray, index: int, epoch: int,
                klass: int) -> np.ndarray:
        if self.rotations and klass == TRAIN:
            rng = np.random.Generator(np.random.PCG64(
                [self.subset_seed, epoch, index, 0x207A7E]))
            deg = float(self.rotations[rng.integers(len(self.rotations))])
            if deg:
                Image = _pil()
                bg = self._bg_value(arr)
                if arr.ndim == 3 and arr.shape[-1] == 3:
                    # broadcast a scalar to all 3 channels — a 1-tuple
                    # fillcolor would paint (bg, 0, 0)
                    fill = tuple(int(v) for v in np.broadcast_to(
                        np.atleast_1d(bg), (3,)))
                else:
                    fill = int(np.mean(bg))
                im = Image.fromarray(arr.astype(np.uint8).squeeze())
                im = im.rotate(deg, resample=Image.BILINEAR,
                               fillcolor=fill)
                arr = np.asarray(im, np.float32)
                if arr.ndim == 2:
                    arr = arr[..., None]
        if self.crop:
            cw, ch = self.crop
            h, w = arr.shape[:2]
            y0, x0 = (h - ch) // 2, (w - cw) // 2
            arr = arr[y0:y0 + ch, x0:x0 + cw]
        do_mirror = self.mirror is True
        if self.mirror == "random" and klass == TRAIN:
            # deterministic per (epoch, index): resume-stable augmentation
            rng = np.random.Generator(np.random.PCG64(
                [self.subset_seed, epoch, index, 0x51DE]))
            do_mirror = bool(rng.integers(2))
        if do_mirror:
            arr = arr[:, ::-1]
        return arr

    # -- Loader contract ----------------------------------------------------
    def load_data(self):
        self._paths = {k: self.get_image_paths(k)
                       for k in (TEST, VALID, TRAIN)}
        self._labels = {k: np.asarray([self.get_label(p)
                                       for p in v], np.int32)
                        for k, v in self._paths.items()}
        for k in (TEST, VALID, TRAIN):
            self.class_lengths[k] = len(self._paths[k])

    def fill_minibatch(self, indices, klass):
        imgs = []
        for idx in indices:
            arr = self.decode(self._paths[klass][int(idx)])
            arr = self.augment(arr, int(idx), self.epoch_number, klass)
            imgs.append(arr)
        batch = {"@input": np.stack(imgs)}
        if len(self._labels[klass]):
            batch["@labels"] = self._labels[klass][indices]
        return batch


class FileImageLoader(ImageLoader):
    """Directory-scanning image loader with auto-labels from a path regex
    (reference: veles/loader/file_image.py — AutoLabelFileImageLoader).

    train_paths/valid_paths/test_paths: directories to walk;
    label_regexp: first group = label string; label mapping is sorted
    strings -> dense ints (reference label-mapping behavior,
    veles/loader/base.py:925+)."""

    EXTENSIONS = {".png", ".jpg", ".jpeg", ".bmp", ".gif", ".tif"}

    def __init__(self, train_paths: Sequence[str] = (),
                 valid_paths: Sequence[str] = (),
                 test_paths: Sequence[str] = (),
                 label_regexp: str = r"/([^/]+)/[^/]+$", **kw):
        super().__init__(**kw)
        self._dirs = {TRAIN: list(train_paths), VALID: list(valid_paths),
                      TEST: list(test_paths)}
        self.label_regexp = re.compile(label_regexp)
        self.label_mapping: Dict[str, int] = {}

    def get_image_paths(self, klass: int) -> List[str]:
        found = []
        for d in self._dirs[klass]:
            for base, _, files in sorted(os.walk(d)):
                for fn in sorted(files):
                    if os.path.splitext(fn)[1].lower() in self.EXTENSIONS:
                        found.append(os.path.join(base, fn))
        return found

    def load_data(self):
        super().load_data()
        raw = set()
        for k in (TEST, VALID, TRAIN):
            for p in self._paths[k]:
                m = self.label_regexp.search(p)
                raw.add(m.group(1) if m else "")
        self.label_mapping = {s: i for i, s in enumerate(sorted(raw))}
        for k in (TEST, VALID, TRAIN):
            labs = []
            for p in self._paths[k]:
                m = self.label_regexp.search(p)
                labs.append(self.label_mapping[m.group(1) if m else ""])
            self._labels[k] = np.asarray(labs, np.int32)

    def get_label(self, path: str) -> int:
        return 0  # replaced in load_data by the mapped labels


class Hdf5Loader(Loader):
    """HDF5 dataset loader (reference: veles/loader/loader_hdf5.py:48-151 —
    datasets named by class with data/labels pairs)."""

    def __init__(self, files: Dict[int, str], data_key: str = "data",
                 labels_key: str = "labels", **kw):
        super().__init__(**kw)
        self._files = dict(files)
        self.data_key = data_key
        self.labels_key = labels_key
        self._h5: Dict[int, object] = {}

    def load_data(self):
        import h5py
        for k, path in self._files.items():
            f = h5py.File(path, "r")
            self._h5[k] = f
            self.class_lengths[k] = len(f[self.data_key])

    def fill_minibatch(self, indices, klass):
        f = self._h5[klass]
        order = np.argsort(indices)  # h5py wants increasing indices
        inv = np.argsort(order)
        sorted_idx = np.asarray(indices)[order]
        # h5py fancy indexing requires strictly increasing unique indices;
        # fall back to per-row reads when padding duplicated indices.
        if len(np.unique(sorted_idx)) == len(sorted_idx):
            data = f[self.data_key][sorted_idx][inv]
            batch = {"@input": np.asarray(data, np.float32)}
            if self.labels_key in f:
                batch["@labels"] = np.asarray(
                    f[self.labels_key][sorted_idx][inv], np.int32)
        else:
            data = np.stack([f[self.data_key][int(i)] for i in indices])
            batch = {"@input": np.asarray(data, np.float32)}
            if self.labels_key in f:
                batch["@labels"] = np.asarray(
                    [f[self.labels_key][int(i)] for i in indices], np.int32)
        return batch
