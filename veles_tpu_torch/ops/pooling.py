"""Pooling ops (counterpart of veles_tpu/ops/pooling.py:17-35, ``max_pool``
and ``avg_pool`` with VALID windows; the unpooling helpers come with the
autoencoder part of the image slice).

Activations stay NHWC: the pools read ``x.permute(0, 3, 1, 2)`` (a
channels-last view) and return NHWC.
"""

from __future__ import annotations

import torch.nn.functional as F

from .convolution import pair


def _window(window, stride, padding):
    if padding != "VALID":
        raise NotImplementedError(
            f"pooling padding {padding!r}: the port pools VALID windows "
            "only (the image units' only use)")
    w = pair(window)
    return w, (pair(stride) if stride is not None else w)


def max_pool(x, window=2, stride=None, padding="VALID"):
    """x: (N, H, W, C); max over each VALID window (stride defaults to
    the window)."""
    w, s = _window(window, stride, padding)
    y = F.max_pool2d(x.permute(0, 3, 1, 2), w, s)
    return y.permute(0, 2, 3, 1)


def avg_pool(x, window=2, stride=None, padding="VALID"):
    """x: (N, H, W, C); mean over each VALID window."""
    w, s = _window(window, stride, padding)
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), w, s)
    return y.permute(0, 2, 3, 1)
