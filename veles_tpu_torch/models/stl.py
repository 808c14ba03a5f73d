"""STL-10 convolutional workflow and loader (a copy of
veles_tpu/models/stl.py, which holds no JAX, rewired to the port).

Reference: the Znicz STL-10 result, 35.10 % validation error: the CIFAR
conv stack on 96 x 96 images with STL-10's small labeled split (5k train
/ 8k test).  Real STL-10 binaries are read from local files only
(``$VELES_DATA_DIR`` or ``~/data/stl10_binary``); otherwise SynthShapes
at 96 px with STL-10's split sizes stands in, at the JAX package's
seed.  Mean/disp-normalized on the host, held on the card by
:class:`~veles_tpu_torch.loader.fullbatch.FullBatchLoader`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..loader.base import TEST, TRAIN, VALID
from ..loader.fullbatch import FullBatchLoader
from ..normalization import NormalizerRegistry
from .standard import StandardWorkflow

DATA_DIRS = [
    os.environ.get("VELES_DATA_DIR", ""),
    os.path.expanduser("~/data/stl10_binary"),
]


def load_real_stl10() -> Optional[Tuple[np.ndarray, ...]]:
    """STL-10 binary format: uint8, (N, 3, 96, 96) column-major per
    plane; labels are 1-based."""
    for d in DATA_DIRS:
        if d and os.path.exists(os.path.join(d, "train_X.bin")):
            def imgs(name):
                raw = np.fromfile(os.path.join(d, name), np.uint8)
                return (raw.reshape(-1, 3, 96, 96)
                        .transpose(0, 3, 2, 1))  # -> (N, H, W, C)

            def labels(name):
                return (np.fromfile(os.path.join(d, name), np.uint8)
                        .astype(np.int32) - 1)

            return (imgs("train_X.bin"), labels("train_y.bin"),
                    imgs("test_X.bin"), labels("test_y.bin"))
    return None


def synthesize_stl(n_train=5000, n_valid=8000, seed=20260731):
    """SynthShapes at 96 px with STL-10 split sizes (synth_data.py)."""
    from .synth_data import synth_shapes
    return synth_shapes(n_train, n_valid, seed, size=96)


class StlLoader(FullBatchLoader):
    def __init__(self, minibatch_size=50, n_train=5000, n_valid=8000, **kw):
        real = load_real_stl10()
        if real is not None:
            xt, yt, xte, yte = real
            data = {TRAIN: xt, VALID: xte}
            labels = {TRAIN: yt, VALID: yte}
            self.synthetic = False
        else:
            xt, yt, xv, yv = synthesize_stl(n_train, n_valid)
            data = {TRAIN: xt, VALID: xv}
            labels = {TRAIN: yt, VALID: yv}
            self.synthetic = True
        data = {k: v.astype(np.float32) for k, v in data.items()}
        super().__init__(
            data, labels,
            normalizer=NormalizerRegistry.create("mean_disp"),
            minibatch_size=minibatch_size, **kw)


STL_CONFIG = {
    "name": "StlWorkflow",
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
        {"type": "all2all_relu", "output_size": 128, "name": "fc4"},
        {"type": "dropout", "dropout_ratio": 0.5, "name": "drop4"},
        {"type": "softmax", "output_size": 10, "name": "fc_softmax"},
    ],
    "loss": "softmax",
    "optimizer": "momentum",
    "optimizer_args": {"lr": 0.01, "momentum": 0.9, "l2": 4e-3},
    "max_epochs": 60,
    "fail_iterations": 60,
}


def stl_workflow(minibatch_size=50, loader_args=None,
                 **overrides) -> StandardWorkflow:
    cfg = dict(STL_CONFIG)
    cfg.update(overrides)
    sw = StandardWorkflow(cfg)
    sw.loader = StlLoader(minibatch_size=minibatch_size,
                          **(loader_args or {}))
    return sw
