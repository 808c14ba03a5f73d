"""ImageNet AlexNet, the image family's flagship (a copy of
veles_tpu/models/alexnet.py, which holds no JAX, rewired to the port).

NHWC activations, bf16 compute with float32 master weights, 227 x 227
inputs, LRN after conv1/conv2.  ImageNet itself is not here; the loaders
are deterministic synthetic ImageNet-shaped streams.  Copied: the config,
``ImagenetSyntheticLoader`` (float32 batches made on the host),
``_synth_store`` and ``_e2e_config``, ``alexnet_workflow``,
``alexnet_e2e_device_workflow`` (the uint8 store held on the card,
cropped, mirrored and normalized there), and ``ImagenetHostLoader`` with
``alexnet_e2e_workflow`` (the host crop path: uint8 batches cropped and
mirrored on the host, normalized on the card by the prepended ``norm``
unit's mean/disp kernel).
"""

from __future__ import annotations

import os

import numpy as np

from ..loader.base import TRAIN, VALID, Loader
from .standard import StandardWorkflow

ALEXNET_CONFIG = {
    "name": "AlexNet",
    "compute_dtype": "bfloat16",
    "layers": [
        {"type": "conv_relu", "n_kernels": 96, "kx": 11, "stride": 4,
         "padding": "VALID", "name": "conv1"},
        {"type": "lrn", "name": "lrn1", "method": "auto"},
        {"type": "max_pooling", "window": 3, "stride": 2, "name": "pool1"},
        {"type": "conv_relu", "n_kernels": 256, "kx": 5, "padding": 2,
         "name": "conv2"},
        {"type": "lrn", "name": "lrn2", "method": "auto"},
        {"type": "max_pooling", "window": 3, "stride": 2, "name": "pool2"},
        {"type": "conv_relu", "n_kernels": 384, "kx": 3, "padding": 1,
         "name": "conv3"},
        {"type": "conv_relu", "n_kernels": 384, "kx": 3, "padding": 1,
         "name": "conv4"},
        {"type": "conv_relu", "n_kernels": 256, "kx": 3, "padding": 1,
         "name": "conv5"},
        {"type": "max_pooling", "window": 3, "stride": 2, "name": "pool5"},
        {"type": "all2all_relu", "output_size": 4096, "name": "fc6"},
        {"type": "dropout", "dropout_ratio": 0.5, "name": "drop6"},
        {"type": "all2all_relu", "output_size": 4096, "name": "fc7"},
        {"type": "dropout", "dropout_ratio": 0.5, "name": "drop7"},
        {"type": "softmax", "output_size": 1000, "name": "fc8"},
    ],
    "loss": "softmax",
    "optimizer": "momentum",
    "optimizer_args": {"lr": 0.01, "momentum": 0.9, "l2": 5e-4},
    "max_epochs": 90,
}

INPUT_HW = 227
STORE_HW = 256  # stored image side; random-cropped to INPUT_HW


class ImagenetSyntheticLoader(Loader):
    """Deterministic ImageNet-shaped stream: 227x227x3 f32, 1000 classes,
    each batch generated on the host from (seed, class, first index)."""

    def __init__(self, minibatch_size=128, n_train=4096, n_valid=512,
                 n_classes=1000, seed=13, **kw):
        super().__init__(minibatch_size=minibatch_size, **kw)
        self.n_train = n_train
        self.n_valid = n_valid
        self.n_classes = n_classes
        self.seed = seed

    def load_data(self):
        self.class_lengths = [0, self.n_valid, self.n_train]

    def fill_minibatch(self, indices, klass):
        rng = np.random.default_rng(
            [self.seed, klass, int(indices[0]) if len(indices) else 0])
        n = len(indices)
        labels = (indices % self.n_classes).astype(np.int32)
        x = rng.standard_normal(
            (n, INPUT_HW, INPUT_HW, 3)).astype(np.float32)
        return {"@input": x, "@labels": labels}


class ImagenetHostLoader(Loader):
    """The end-to-end input pipeline on the host
    (veles_tpu/models/alexnet.py:86-159): a host-resident uint8 store,
    each sample randomly cropped to 227 and mirrored on the host (the
    validation class centre-cropped), uint8 batches out; the uint8 ->
    float mean/disp normalization is left to the card (the workflow's
    first unit).  The crop offsets and flips come from
    ``default_rng([seed, klass, first index])``, the JAX package's
    stream, so the batches are bitwise its batches.  Batches of 128 or
    more are cut on one long-lived thread pool (the slice copies release
    the GIL); the trainer's prefetch thread overlaps them with the
    step."""

    def __init__(self, minibatch_size=128, n_train=4096, n_valid=512,
                 n_classes=1000, seed=13, **kw):
        super().__init__(minibatch_size=minibatch_size, **kw)
        self.n_train = n_train
        self.n_valid = n_valid
        self.n_classes = n_classes
        self.seed = seed
        self._store = None
        self._pool = None

    def _executor(self, workers: int):
        # one pool for the loader's life: a pool a batch would be created
        # and joined every minibatch
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(workers)
        return self._pool

    def load_data(self):
        self._store, _ = _synth_store(self.n_train + self.n_valid,
                                      self.seed)
        self.class_lengths = [0, self.n_valid, self.n_train]

    def fill_minibatch(self, indices, klass):
        hw, out = STORE_HW, INPUT_HW
        base = self.n_valid if klass == TRAIN else 0
        rng = np.random.default_rng(
            [self.seed, klass, int(indices[0]) if len(indices) else 0])
        n = len(indices)
        if klass == TRAIN:
            offs = rng.integers(0, hw - out + 1, (n, 2))
            flip = rng.random(n) < 0.5
        else:
            c = (hw - out) // 2
            offs = np.full((n, 2), c)
            flip = np.zeros(n, bool)
        idx = np.asarray(indices) + base
        xs = np.empty((n, out, out, 3), np.uint8)

        def fill(lo, hi):
            for i in range(lo, hi):
                oy, ox = offs[i]
                img = self._store[idx[i], oy:oy + out, ox:ox + out]
                xs[i] = img[:, ::-1] if flip[i] else img

        workers = min(8, os.cpu_count() or 1)
        if n >= 128 and workers > 1:
            chunk = -(-n // workers)
            list(self._executor(workers).map(
                lambda lo: fill(lo, min(lo + chunk, n)),
                range(0, n, chunk)))
        else:
            fill(0, n)
        labels = (indices % self.n_classes).astype(np.int32)
        return {"@input": xs, "@labels": labels}


def alexnet_workflow(minibatch_size=128, loader=None,
                     **overrides) -> StandardWorkflow:
    cfg = dict(ALEXNET_CONFIG)
    cfg.update(overrides)
    sw = StandardWorkflow(cfg)
    sw.loader = loader if loader is not None else \
        ImagenetSyntheticLoader(minibatch_size=minibatch_size)
    return sw


def _e2e_config(**overrides) -> dict:
    """AlexNet config with the mean/disp normalize unit prepended (the
    uint8 store's pixels normalized on the card)."""
    cfg = dict(ALEXNET_CONFIG)
    cfg["layers"] = [
        {"type": "norm", "name": "norm0",
         "mean": np.full((INPUT_HW, INPUT_HW, 3), 127.5, np.float32),
         "rdisp": np.full((INPUT_HW, INPUT_HW, 3), 1 / 64.0, np.float32)},
    ] + [dict(layer) for layer in ALEXNET_CONFIG["layers"]]
    cfg.update(overrides)
    return cfg


def _synth_store(n: int, seed: int = 13):
    """Deterministic synthetic decoded-JPEG store (uint8 256x256x3) +
    labels."""
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 256, (n, STORE_HW, STORE_HW, 3), np.uint8)
    labels = np.arange(n, dtype=np.int32) % 1000
    return store, labels


def alexnet_e2e_workflow(minibatch_size=128, n_train=4096, n_valid=512,
                         seed=13, **overrides) -> StandardWorkflow:
    """AlexNet fed through the host image path
    (veles_tpu/models/alexnet.py:196-204): uint8 batches from
    :class:`ImagenetHostLoader`, normalized on the card by the prepended
    mean/disp unit."""
    sw = StandardWorkflow(_e2e_config(**overrides))
    sw.loader = ImagenetHostLoader(minibatch_size=minibatch_size,
                                   n_train=n_train, n_valid=n_valid,
                                   seed=seed)
    return sw


def alexnet_e2e_device_workflow(minibatch_size=128, n_train=4096,
                                n_valid=512, seed=13, device=None,
                                **overrides) -> StandardWorkflow:
    """End-to-end AlexNet on the card-resident input pipeline: the uint8
    256x256 store is held on ``device`` (default: the CUDA card) by a
    ``FullBatchAugmentedLoader``, and the random crop, mirror and
    mean/disp normalize all run there."""
    from ..loader.fullbatch import FullBatchAugmentedLoader

    sw = StandardWorkflow(_e2e_config(**overrides))
    store, labels = _synth_store(n_train + n_valid, seed)
    sw.loader = FullBatchAugmentedLoader(
        {TRAIN: store[n_valid:], VALID: store[:n_valid]},
        {TRAIN: labels[n_valid:], VALID: labels[:n_valid]},
        minibatch_size=minibatch_size, crop_hw=(INPUT_HW, INPUT_HW),
        mirror=True, device=device)
    return sw
