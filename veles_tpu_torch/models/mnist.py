"""MNIST fully-connected workflow and the MNIST loader (a copy of
veles_tpu/models/mnist.py, which holds no JAX, rewired to the port).

Reference: the Znicz MNIST workflow, FC 784-100(tanh)-10(softmax), target
1.48-1.92 % validation error.  Real MNIST is read from local files only
(idx or npz under ``$VELES_DATA_DIR`` or ``~/data/mnist``); nothing is
fetched.  Otherwise the full-size fixed-seed SynthDigits dataset
(``models/synth_data.py``) stands in, at the JAX package's sizes and
seed, so the arrays are bitwise the JAX package's.  The loader is a
card-resident :class:`~veles_tpu_torch.loader.fullbatch.FullBatchLoader`
(``device=`` as every entry point's): the 28 x 28 uint8 images become
flat float32 rows, range-normalized to [-1, 1] on the host with the
numpy normalizer before the upload, and every minibatch comes from the
one-launch batch gather on the card.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from ..loader.base import TEST, TRAIN, VALID
from ..loader.fullbatch import FullBatchLoader
from ..normalization import NormalizerRegistry
from .standard import StandardWorkflow

DATA_DIRS = [
    os.environ.get("VELES_DATA_DIR", ""),
    os.path.expanduser("~/data/mnist"),
]


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def load_real_mnist() -> Optional[Tuple[np.ndarray, ...]]:
    for d in DATA_DIRS:
        if not d:
            continue
        npz = os.path.join(d, "mnist.npz")
        if os.path.exists(npz):
            with np.load(npz) as z:
                return (z["x_train"], z["y_train"],
                        z["x_test"], z["y_test"])
        for ext in ("", ".gz"):
            ti = os.path.join(d, "train-images-idx3-ubyte" + ext)
            if os.path.exists(ti):
                return (
                    _read_idx(ti),
                    _read_idx(os.path.join(
                        d, "train-labels-idx1-ubyte" + ext)),
                    _read_idx(os.path.join(
                        d, "t10k-images-idx3-ubyte" + ext)),
                    _read_idx(os.path.join(
                        d, "t10k-labels-idx1-ubyte" + ext)))
    return None


def synthesize_mnist(n_train=60000, n_valid=10000, seed=20260729
                     ) -> Tuple[np.ndarray, ...]:
    """Full-size deterministic SynthDigits (see models/synth_data.py)."""
    from .synth_data import synth_digits
    return synth_digits(n_train, n_valid, seed)


class MnistLoader(FullBatchLoader):
    """Fullbatch MNIST loader: 28x28 uint8 -> flat normalized f32."""

    def __init__(self, minibatch_size=100, validation_ratio=1 / 6,
                 synthetic_ok=True, n_train=60000, n_valid=10000, **kw):
        real = load_real_mnist()
        if real is not None:
            xt, yt, xte, yte = real
            nv = int(len(xt) * validation_ratio)
            data = {TRAIN: xt[nv:], VALID: xt[:nv], TEST: xte}
            labels = {TRAIN: yt[nv:].astype(np.int32),
                      VALID: yt[:nv].astype(np.int32),
                      TEST: yte.astype(np.int32)}
            self.synthetic = False
        elif synthetic_ok:
            xt, yt, xv, yv = synthesize_mnist(n_train, n_valid)
            data = {TRAIN: xt, VALID: xv}
            labels = {TRAIN: yt, VALID: yv}
            self.synthetic = True
        else:
            raise FileNotFoundError("no MNIST data found; set VELES_DATA_DIR")
        data = {k: (v.reshape(len(v), -1).astype(np.float32))
                for k, v in data.items()}
        super().__init__(
            data, labels,
            normalizer=NormalizerRegistry.create(
                "range_linear", source_range=(0, 255), interval=(-1, 1)),
            minibatch_size=minibatch_size, **kw)


MNIST_CONFIG = {
    "name": "MnistWorkflow",
    "layers": [
        {"type": "all2all_tanh", "output_size": 100, "name": "fc_tanh",
         "hyperparams": {"lr_scale": 1.0}},
        {"type": "softmax", "output_size": 10, "name": "fc_softmax"},
    ],
    "loss": "softmax",
    "optimizer": "momentum",
    "optimizer_args": {"lr": 0.03, "momentum": 0.9, "l2": 1e-5},
    "max_epochs": 25,
    "fail_iterations": 25,
}


def mnist_workflow(minibatch_size=100, loader_args=None,
                   **overrides) -> StandardWorkflow:
    cfg = dict(MNIST_CONFIG)
    cfg.update(overrides)
    sw = StandardWorkflow(cfg)
    sw.loader = MnistLoader(minibatch_size=minibatch_size,
                            **(loader_args or {}))
    return sw
