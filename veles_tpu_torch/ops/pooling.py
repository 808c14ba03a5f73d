"""Pooling and unpooling ops (counterpart of veles_tpu/ops/pooling.py):
``max_pool`` and ``avg_pool`` with VALID windows (:17-35), and the
unpooling helpers ``max_pool_with_argmax``, ``max_unpool`` and
``avg_unpool`` (:39-76) that the Depool unit and the autoencoders use.

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


def max_pool_with_argmax(x, window=2, stride=None):
    """(pooled, switches): the switches are 1 where an input equals its
    window's max broadcast back, else 0; positions no VALID window covers
    (odd sizes) are never a switch."""
    w = pair(window)
    s = pair(stride) if stride is not None else w
    pooled = max_pool(x, w, s)
    up = _broadcast_back(pooled, tuple(x.shape), s, fill=float("-inf"))
    return pooled, (x == up).to(x.dtype)


def _broadcast_back(pooled, in_shape, s, fill=0.0):
    """``pooled`` repeated by the stride back to ``in_shape`` (N, H, W,
    C), the uncovered tail filled with ``fill``."""
    y = pooled.repeat_interleave(s[0], dim=1).repeat_interleave(s[1], dim=2)
    y = y[:, :in_shape[1], :in_shape[2], :]
    pad_h = in_shape[1] - y.shape[1]
    pad_w = in_shape[2] - y.shape[2]
    if pad_h or pad_w:
        y = F.pad(y, (0, 0, 0, pad_w, 0, pad_h), value=fill)
    return y


def max_unpool(pooled, switches, window=2):
    """Depool through stored switches: each window's max back where it
    came from, zeros elsewhere."""
    up = _broadcast_back(pooled, tuple(switches.shape), pair(window))
    return up * switches


def avg_unpool(pooled, window=2, out_hw=None):
    """Unpool by uniform spread: each value repeated over its window and
    divided by the window's size, cut to ``out_hw`` where given."""
    w = pair(window)
    up = pooled.repeat_interleave(w[0], dim=1).repeat_interleave(w[1], dim=2)
    up = up / (w[0] * w[1])
    if out_hw is not None:
        up = up[:, :out_hw[0], :out_hw[1], :]
    return up
