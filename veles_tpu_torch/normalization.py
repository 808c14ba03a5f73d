"""Data normalizer registry (a copy of veles_tpu/normalization.py, which
holds no JAX: ``NormalizerRegistry`` and its seven normalizers, none,
linear, range_linear, mean_disp, external_mean, exp and pointwise).

Normalizers are numpy and run on the host, in the loader's analysis pass
before the upload (``loader/base.py`` ``ArrayLoader(normalizer=...)``), so
the arrays a loader uploads are bitwise the JAX package's.  ``state()`` /
``set_state()`` carry a normalizer's statistics through snapshots under
the JAX package's keys.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np


class NormalizerRegistry:
    _reg: Dict[str, Type["NormalizerBase"]] = {}

    @classmethod
    def register(cls, name):
        def deco(klass):
            cls._reg[name] = klass
            klass.MAPPING = name
            return klass
        return deco

    @classmethod
    def create(cls, name: str, **kwargs) -> "NormalizerBase":
        return cls._reg[name](**kwargs)

    @classmethod
    def names(cls):
        return sorted(cls._reg)


class NormalizerBase:
    """analyze(data) accumulates statistics; normalize(data) applies in
    place-free fashion; denormalize inverts (for inference-time output
    mapping, reference: veles/normalization.py state serialization)."""

    MAPPING = "base"

    def analyze(self, data: np.ndarray) -> None:
        pass

    def normalize(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def denormalize(self, data: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def state(self) -> dict:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    def set_state(self, st: dict) -> None:
        for k, v in st.items():
            setattr(self, k, v)


@NormalizerRegistry.register("none")
class NoneNormalizer(NormalizerBase):
    def normalize(self, data):
        return data

    def denormalize(self, data):
        return data


@NormalizerRegistry.register("linear")
class LinearNormalizer(NormalizerBase):
    """Scale each sample into [-1, 1] by per-dataset min/max."""

    def __init__(self, interval=(-1.0, 1.0)):
        self.interval = tuple(interval)
        self.vmin: Optional[float] = None
        self.vmax: Optional[float] = None

    def analyze(self, data):
        lo, hi = float(np.min(data)), float(np.max(data))
        self.vmin = lo if self.vmin is None else min(self.vmin, lo)
        self.vmax = hi if self.vmax is None else max(self.vmax, hi)

    def normalize(self, data):
        a, b = self.interval
        span = (self.vmax - self.vmin) or 1.0
        return (data.astype(np.float32) - self.vmin) / span * (b - a) + a

    def denormalize(self, data):
        a, b = self.interval
        span = (self.vmax - self.vmin) or 1.0
        return (data - a) / (b - a) * span + self.vmin


@NormalizerRegistry.register("range_linear")
class RangeLinearNormalizer(LinearNormalizer):
    """Linear with a fixed, known source range (e.g. uint8 images 0..255)."""

    def __init__(self, source_range=(0.0, 255.0), interval=(-1.0, 1.0)):
        super().__init__(interval)
        self.vmin, self.vmax = map(float, source_range)

    def analyze(self, data):
        pass


@NormalizerRegistry.register("mean_disp")
class MeanDispNormalizer(NormalizerBase):
    """(x - mean) / disp with dataset-wide statistics (reference:
    veles/mean_disp_normalizer.py + 'mean_disp' normalizer)."""

    def __init__(self):
        self._sum = None
        self._sumsq = None
        self._count = 0
        self.mean = None
        self.disp = None

    def analyze(self, data):
        d = data.astype(np.float64).reshape(len(data), -1)
        s = d.sum(axis=0)
        ss = np.square(d).sum(axis=0)
        if self._sum is None:
            self._sum, self._sumsq = s, ss
        else:
            self._sum = self._sum + s
            self._sumsq = self._sumsq + ss
        self._count += len(d)
        mean = self._sum / self._count
        var = np.maximum(self._sumsq / self._count - np.square(mean), 1e-12)
        self.mean = mean.astype(np.float32)
        self.disp = np.sqrt(var).astype(np.float32)

    def normalize(self, data):
        shape = data.shape
        flat = data.astype(np.float32).reshape(len(data), -1)
        return ((flat - self.mean) / self.disp).reshape(shape)

    def denormalize(self, data):
        shape = data.shape
        flat = data.reshape(len(data), -1)
        return (flat * self.disp + self.mean).reshape(shape)


@NormalizerRegistry.register("external_mean")
class ExternalMeanNormalizer(NormalizerBase):
    """Subtract a provided mean image (reference 'external_mean')."""

    def __init__(self, mean=None, scale=1.0):
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.scale = scale

    def normalize(self, data):
        return (data.astype(np.float32) - self.mean) * self.scale

    def denormalize(self, data):
        return data / self.scale + self.mean


@NormalizerRegistry.register("exp")
class ExpNormalizer(NormalizerBase):
    """Sigmoid-ish squashing (reference 'exp')."""

    def normalize(self, data):
        return 1.0 / (1.0 + np.exp(-data.astype(np.float32)))

    def denormalize(self, data):
        d = np.clip(data, 1e-7, 1 - 1e-7)
        return np.log(d / (1.0 - d))


@NormalizerRegistry.register("pointwise")
class PointwiseNormalizer(NormalizerBase):
    """Per-feature linear mapping into [-1, 1] (reference 'pointwise')."""

    def __init__(self):
        self.vmin = None
        self.vmax = None

    def analyze(self, data):
        d = data.reshape(len(data), -1)
        lo, hi = d.min(axis=0), d.max(axis=0)
        self.vmin = lo if self.vmin is None else np.minimum(self.vmin, lo)
        self.vmax = hi if self.vmax is None else np.maximum(self.vmax, hi)

    def normalize(self, data):
        shape = data.shape
        d = data.astype(np.float32).reshape(len(data), -1)
        span = np.maximum(self.vmax - self.vmin, 1e-12)
        return ((d - self.vmin) / span * 2.0 - 1.0).reshape(shape)

    def denormalize(self, data):
        shape = data.shape
        d = data.reshape(len(data), -1)
        span = np.maximum(self.vmax - self.vmin, 1e-12)
        return ((d + 1.0) / 2.0 * span + self.vmin).reshape(shape)
