"""Convolution op (counterpart of veles_tpu/ops/convolution.py:24-45,
``conv2d``; ``deconv2d`` comes with the autoencoder part of the image
slice).

The JAX package runs the convolution outside any Pallas kernel
(``lax.conv_general_dilated``), so here it is ``F.conv2d`` (cuDNN on the
card).  Layouts stay the JAX package's: activations NHWC, weights HWIO
as snapshots store them.  The convolution reads ``x.permute(0, 3, 1, 2)``
(a channels-last view, no copy) with ``w.permute(3, 2, 0, 1)`` and its
result is permuted back to NHWC.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def pair(v) -> Tuple[int, int]:
    """An int or a pair as a pair of ints (strides, windows)."""
    return (int(v), int(v)) if isinstance(v, int) else tuple(
        int(a) for a in v)


def conv_padding(padding, in_hw, k_hw, stride) -> Tuple[Tuple[int, int],
                                                        Tuple[int, int]]:
    """((top, bottom), (left, right)) of the JAX package's padding
    argument: ``"SAME"`` pads ``max((ceil(in/s) - 1) * s + k - in, 0)``
    in all, ``p // 2`` low and the rest high (asymmetric for some
    strides); ``"VALID"`` none; an int p means (p, p) on both axes; else
    explicit ((top, bottom), (left, right))."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "VALID":
            return (0, 0), (0, 0)
        if mode != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for n, k, s in zip(in_hw, k_hw, stride):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            out.append((total // 2, total - total // 2))
        return tuple(out)
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (t, b), (lft, r) = padding
    return (int(t), int(b)), (int(lft), int(r))


def conv2d(x, w, b=None, *, stride=1, padding="SAME", compute_dtype=None):
    """x: (N, H, W, Cin), w: (kh, kw, Cin, Cout) -> (N, H', W', Cout).

    With ``compute_dtype`` (the bf16 policy) both operands are cast to it
    and the convolution runs and returns in it (cuDNN accumulates in
    float32), as the JAX package leaves it to the MXU; the result then
    takes the operands' original dtype and the bias is added."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    stride = pair(stride)
    (t, bot), (lft, r) = conv_padding(padding, tuple(x.shape[1:3]),
                                      tuple(w.shape[:2]), stride)
    xt = x.permute(0, 3, 1, 2)
    if t == bot and lft == r:
        pad = (t, lft)
    else:
        xt = F.pad(xt, (lft, r, t, bot))
        pad = (0, 0)
    y = F.conv2d(xt, w.permute(3, 2, 0, 1), stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1).to(out_dtype)
    if b is not None:
        y = y + b
    return y
