"""CIFAR-10 convolutional workflow and loader (a copy of
veles_tpu/models/cifar.py, which holds no JAX, rewired to the port).

Reference: the Znicz CIFAR conv net ("cifar_caffe"), 17.21 % validation
error target.  Real CIFAR-10 python batches are read from local files
only (``$VELES_DATA_DIR`` or ``~/data/cifar-10-batches-py``); otherwise
the full-size fixed-seed SynthShapes dataset (``models/synth_data.py``)
stands in, at the JAX package's sizes and seed.  The images are
mean/disp-normalized on the host with the numpy normalizer and held on
the card by :class:`~veles_tpu_torch.loader.fullbatch.FullBatchLoader`.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np

from ..loader.base import TEST, TRAIN, VALID
from ..loader.fullbatch import FullBatchLoader
from ..normalization import NormalizerRegistry
from .standard import StandardWorkflow

DATA_DIRS = [
    os.environ.get("VELES_DATA_DIR", ""),
    os.path.expanduser("~/data/cifar-10-batches-py"),
]


def load_real_cifar() -> Optional[Tuple[np.ndarray, ...]]:
    for d in DATA_DIRS:
        if d and os.path.exists(os.path.join(d, "data_batch_1")):
            xs, ys = [], []
            for i in range(1, 6):
                with open(os.path.join(d, f"data_batch_{i}"), "rb") as f:
                    b = pickle.load(f, encoding="bytes")
                xs.append(b[b"data"])
                ys.extend(b[b"labels"])
            with open(os.path.join(d, "test_batch"), "rb") as f:
                b = pickle.load(f, encoding="bytes")
            xt = np.concatenate(xs).reshape(-1, 3, 32, 32) \
                .transpose(0, 2, 3, 1)
            xte = b[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            return (xt, np.asarray(ys, np.int32),
                    xte, np.asarray(b[b"labels"], np.int32))
    return None


def synthesize_cifar(n_train=50000, n_valid=10000, seed=20260730):
    """Full-size deterministic SynthShapes (see models/synth_data.py)."""
    from .synth_data import synth_shapes
    return synth_shapes(n_train, n_valid, seed)


class CifarLoader(FullBatchLoader):
    def __init__(self, minibatch_size=100, validation_ratio=0.1,
                 n_train=50000, n_valid=10000, **kw):
        real = load_real_cifar()
        if real is not None:
            xt, yt, xte, yte = real
            nv = int(len(xt) * validation_ratio)
            data = {TRAIN: xt[nv:], VALID: xt[:nv], TEST: xte}
            labels = {TRAIN: yt[nv:], VALID: yt[:nv], TEST: yte}
            self.synthetic = False
        else:
            xt, yt, xv, yv = synthesize_cifar(n_train, n_valid)
            data = {TRAIN: xt, VALID: xv}
            labels = {TRAIN: yt, VALID: yv}
            self.synthetic = True
        data = {k: v.astype(np.float32) for k, v in data.items()}
        super().__init__(
            data, labels,
            normalizer=NormalizerRegistry.create("mean_disp"),
            minibatch_size=minibatch_size, **kw)


CIFAR_CONFIG = {
    "name": "CifarWorkflow",
    "layers": [
        {"type": "conv_relu", "n_kernels": 32, "kx": 5, "padding": 2,
         "name": "conv1"},
        {"type": "max_pooling", "window": 3, "stride": 2, "name": "pool1"},
        {"type": "conv_relu", "n_kernels": 32, "kx": 5, "padding": 2,
         "name": "conv2"},
        {"type": "avg_pooling", "window": 3, "stride": 2, "name": "pool2"},
        {"type": "conv_relu", "n_kernels": 64, "kx": 5, "padding": 2,
         "name": "conv3"},
        {"type": "avg_pooling", "window": 3, "stride": 2, "name": "pool3"},
        {"type": "softmax", "output_size": 10, "name": "fc_softmax"},
    ],
    "loss": "softmax",
    "optimizer": "momentum",
    "optimizer_args": {"lr": 0.01, "momentum": 0.9, "l2": 4e-3},
    "max_epochs": 40,
    "fail_iterations": 40,
}


def cifar_workflow(minibatch_size=100, loader_args=None,
                   **overrides) -> StandardWorkflow:
    cfg = dict(CIFAR_CONFIG)
    cfg.update(overrides)
    sw = StandardWorkflow(cfg)
    sw.loader = CifarLoader(minibatch_size=minibatch_size,
                            **(loader_args or {}))
    return sw
