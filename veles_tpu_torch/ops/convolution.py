"""Convolution ops (counterpart of veles_tpu/ops/convolution.py:
``conv2d`` :24-45 and ``deconv2d`` :52-73).

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


def deconv_padding(padding, k_hw, stride) -> Tuple[Tuple[int, int],
                                                   Tuple[int, int]]:
    """((top, bottom), (left, right)) padding of the stride-dilated input
    that ``jax.lax.conv_transpose`` takes for ``padding``: for "SAME"
    ``k + s - 2`` in all, ``k - 1`` low where ``s > k - 1`` else half
    rounded up; for "VALID" ``k + s - 2 + max(k - s, 0)`` in all, ``k -
    1`` low; an int p is (p, p) on both axes, explicit pairs pass as
    given (JAX's ``_conv_transpose_padding``)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for k, s in zip(k_hw, stride):
            if mode == "SAME":
                total = k + s - 2
                lo = k - 1 if s > k - 1 else -(-total // 2)
            else:
                total = k + s - 2 + max(k - s, 0)
                lo = k - 1
            out.append((lo, total - lo))
        return tuple(out)
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (t, b), (lft, r) = padding
    return (int(t), int(b)), (int(lft), int(r))


def deconv2d(x, w, b=None, *, stride=1, padding="SAME", compute_dtype=None):
    """Transposed convolution as ``jax.lax.conv_transpose`` computes it
    with ``transpose_kernel=False`` (the JAX package's ``deconv2d``):
    x: (N, H, W, Cin), w: (kh, kw, Cin, Cout) HWIO, the kernel NOT
    flipped.  That is a fractionally-strided convolution: the input
    dilated by the stride (``stride - 1`` zeros between samples), padded
    by :func:`deconv_padding` (a negative pad crops), then a stride-1
    ``conv2d`` with ``w`` as it is.  ``F.conv_transpose2d`` is the other
    operation (the gradient of a convolution: kernel flipped, in and out
    swapped) and is not used.  ``compute_dtype`` as :func:`conv2d`."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    s = pair(stride)
    (t, bot), (lft, r) = deconv_padding(padding, tuple(w.shape[:2]), s)
    xt = x.permute(0, 3, 1, 2)
    if s != (1, 1):
        n, c, h, wd = xt.shape
        dil = xt.new_zeros((n, c, (h - 1) * s[0] + 1, (wd - 1) * s[1] + 1))
        dil[:, :, ::s[0], ::s[1]] = xt
        xt = dil
    xt = F.pad(xt, (lft, r, t, bot))
    y = F.conv2d(xt, w.permute(3, 2, 0, 1))
    y = y.permute(0, 2, 3, 1).to(out_dtype)
    if b is not None:
        y = y + b
    return y
