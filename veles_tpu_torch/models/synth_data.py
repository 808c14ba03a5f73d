"""Full-size, fixed-seed procedural datasets standing in for MNIST,
CIFAR-10 and STL-10 (a copy of veles_tpu/models/synth_data.py, which holds
no JAX).

* **SynthDigits**: 28x28 grayscale digits rendered from per-class stroke
  skeletons under random affine pose, stroke jitter, width and intensity
  variation, background noise and clutter; MNIST's splits (60k / 10k).
* **SynthShapes**: 32x32 RGB images of 10 parametric shape classes
  (signed-distance renders) under random pose, fill style, textured
  backgrounds, lighting gradients, distractors and noise; CIFAR-10's
  splits (50k / 10k), and at ``size=96`` with STL-10's splits the STL-10
  stand-in.

The renderers are the JAX package's numpy code unchanged, so the same
arguments give bitwise the same arrays.  The cache is the port's own:
npz files under ``$VELES_TORCH_CACHE/datasets`` (default
``~/.cache/veles_tpu_torch/datasets``), keyed by (name, version, n,
seed), never the JAX package's directory, so a renderer that diverged
could not hide behind a file the other package wrote.  Rendering is host
time, linear in the sample count; the cache spares it after the first
run.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def cache_dir() -> str:
    """The port's dataset cache directory (read at each call, so a
    process can point it elsewhere by ``VELES_TORCH_CACHE``)."""
    return os.path.join(os.path.expanduser(os.environ.get(
        "VELES_TORCH_CACHE", "~/.cache/veles_tpu_torch")), "datasets")


_DIGITS_VERSION = 3  # bump to invalidate caches when the renderer changes
_SHAPES_VERSION = 3


def _publish_cache(path: str, **arrays) -> None:
    """Atomic cache write safe under concurrent cold-cache processes (e.g.
    --workers farm-out): per-process unique temp file, then rename."""
    import tempfile
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


# ---------------------------------------------------------------------------
# SynthDigits: stroke-skeleton digit renderer
# ---------------------------------------------------------------------------

def _arc(cx: float, cy: float, rx: float, ry: float,
         deg0: float, deg1: float, n: int = 14) -> np.ndarray:
    """Polyline approximation of an ellipse arc. Angles in degrees; y is
    down, 0 deg = +x (right), 90 deg = +y (down)."""
    a = np.radians(np.linspace(deg0, deg1, n))
    return np.stack([cx + rx * np.cos(a), cy + ry * np.sin(a)], axis=1)


def _pl(*pts: Tuple[float, float]) -> np.ndarray:
    return np.asarray(pts, np.float64)


def digit_strokes() -> List[List[np.ndarray]]:
    """Per-class stroke skeletons in the unit square (x right, y down)."""
    return [
        # 0 — closed oval
        [_arc(0.5, 0.5, 0.24, 0.34, 0, 360, 22)],
        # 1 — flag + vertical stem
        [_pl((0.36, 0.30), (0.55, 0.14), (0.55, 0.86))],
        # 2 — top hook, diagonal, base bar
        [np.concatenate([
            _arc(0.48, 0.33, 0.22, 0.19, 185, 355, 10),
            _pl((0.69, 0.40), (0.28, 0.84), (0.74, 0.84))])],
        # 3 — two right bumps
        [np.concatenate([
            _arc(0.44, 0.31, 0.23, 0.17, 190, 430, 12),
            _arc(0.44, 0.67, 0.25, 0.19, 280, 530, 12)])],
        # 4 — diagonal+bar, vertical stem
        [_pl((0.58, 0.13), (0.24, 0.62), (0.80, 0.62)),
         _pl((0.63, 0.38), (0.63, 0.90))],
        # 5 — top bar, left drop, bottom bulge
        [np.concatenate([
            _pl((0.73, 0.14), (0.31, 0.14), (0.29, 0.46)),
            _arc(0.47, 0.64, 0.25, 0.21, 250, 480, 12)])],
        # 6 — left sweep into bottom loop
        [np.concatenate([
            _arc(0.60, 0.42, 0.34, 0.34, 250, 180, 8),
            _arc(0.50, 0.66, 0.22, 0.20, 180, 540, 16)])],
        # 7 — top bar, long diagonal
        [_pl((0.26, 0.16), (0.76, 0.16), (0.44, 0.88))],
        # 8 — stacked loops
        [_arc(0.50, 0.32, 0.19, 0.17, 90, 450, 16),
         _arc(0.50, 0.68, 0.23, 0.19, 270, 630, 16)],
        # 9 — top loop with tail
        [np.concatenate([
            _arc(0.47, 0.34, 0.21, 0.19, 0, 360, 16),
            _pl((0.68, 0.34), (0.64, 0.88))])],
    ]


def _segments(strokes: Sequence[np.ndarray]
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Stack stroke polylines into (P,2) points + (S,2) index pairs."""
    pts, pairs, off = [], [], 0
    for s in strokes:
        pts.append(s)
        pairs.extend((off + i, off + i + 1) for i in range(len(s) - 1))
        off += len(s)
    return np.concatenate(pts), np.asarray(pairs, np.int32)


def _render_stroke_batch(points: np.ndarray, pairs: np.ndarray,
                         widths: np.ndarray, size: int) -> np.ndarray:
    """Distance-field rasterization.

    points: (n, P, 2) in pixel coords; pairs: (S, 2) point-index pairs;
    widths: (n,) stroke half-widths in pixels. Returns (n, size, size)
    float32 in [0, 1].
    """
    n = points.shape[0]
    a = points[:, pairs[:, 0]]           # (n, S, 2)
    b = points[:, pairs[:, 1]]
    ab = b - a                            # (n, S, 2)
    ab2 = np.maximum((ab * ab).sum(-1), 1e-12)           # (n, S)
    g = np.stack(np.meshgrid(np.arange(size), np.arange(size),
                             indexing="xy"), axis=-1).astype(np.float32)
    px = g.reshape(-1, 2)                 # (size*size, 2) as (x, y)
    # (n, S, Q, 2) would be huge; loop over segments instead (S is ~20-40).
    dmin = np.full((n, px.shape[0]), np.inf, np.float32)
    for s in range(pairs.shape[0]):
        ap = px[None, :, :] - a[:, s, None, :]            # (n, Q, 2)
        t = np.clip((ap * ab[:, s, None, :]).sum(-1)
                    / ab2[:, s, None], 0.0, 1.0)          # (n, Q)
        proj = a[:, s, None, :] + t[..., None] * ab[:, s, None, :]
        d = np.sqrt(((px[None] - proj) ** 2).sum(-1))
        np.minimum(dmin, d, out=dmin)
    aa = 0.9  # soft-edge width in pixels (antialias)
    img = np.clip((widths[:, None] + aa - dmin) / aa, 0.0, 1.0)
    return img.reshape(n, size, size)


_RENDER_CHUNK = 2048  # PART OF THE DATASET IDENTITY: per-chunk RNG streams
# are seeded at chunk boundaries, so a different chunking produces a
# different (equally valid) dataset — bump _*_VERSION if this changes.


def render_digits(labels: np.ndarray, rng: np.random.Generator,
                  size: int = 28) -> np.ndarray:
    """Render one image per label with random pose/jitter. Returns uint8."""
    chunk = _RENDER_CHUNK
    skel = digit_strokes()
    out = np.empty((len(labels), size, size), np.uint8)
    # Pose/width/intensity nuisances are drawn for ALL samples up front;
    # the per-chunk `local` streams below are seeded at _RENDER_CHUNK
    # boundaries (part of the dataset identity, see above).
    n = len(labels)
    rot = rng.uniform(-0.33, 0.33, n)
    shear = rng.uniform(-0.26, 0.26, n)
    sx = rng.uniform(0.70, 1.12, n)
    sy = rng.uniform(0.70, 1.12, n)
    tx = rng.uniform(-3.0, 3.0, n)
    ty = rng.uniform(-3.0, 3.0, n)
    width = rng.uniform(0.8, 2.1, n)
    inten = rng.uniform(0.60, 1.00, n)
    # smooth per-sample warp (elastic-like): quadratic coordinate bend
    bend = rng.uniform(-0.155, 0.155, (n, 2))
    noise_seed = rng.integers(0, 2 ** 31, n)
    for cls in range(10):
        pts0, pairs = _segments(skel[cls])
        idx = np.nonzero(labels == cls)[0]
        for lo in range(0, len(idx), chunk):
            ii = idx[lo:lo + chunk]
            m = len(ii)
            # jitter skeleton points (wiggly strokes), then affine to pixels
            local = np.random.default_rng(
                int(noise_seed[ii[0]]) ^ (cls << 20) ^ lo)
            p = pts0[None] + local.normal(0, 0.024, (m,) + pts0.shape)
            c, s = np.cos(rot[ii]), np.sin(rot[ii])
            # affine: rotate * shear * scale, about glyph center
            p = p - 0.5
            x = p[..., 0] * sx[ii, None]
            y = p[..., 1] * sy[ii, None]
            # quadratic bend (elastic-like smooth deformation)
            x = x + bend[ii, 0, None] * (y * y - 0.08)
            y = y + bend[ii, 1, None] * (x * x - 0.08)
            x = x + shear[ii, None] * y
            xr = c[:, None] * x - s[:, None] * y
            yr = s[:, None] * x + c[:, None] * y
            px = (xr + 0.5) * (size - 1) + tx[ii, None]
            py = (yr + 0.5) * (size - 1) + ty[ii, None]
            img = _render_stroke_batch(
                np.stack([px, py], -1), pairs, width[ii], size)
            img *= inten[ii, None, None]
            img += local.normal(0, 0.045, img.shape)  # sensor noise
            # clutter: a faint random short bar on ~40 % of images
            mask = local.random(m) < 0.35
            if mask.any():
                k = np.nonzero(mask)[0]
                cx = local.uniform(3, size - 3, len(k))
                cy = local.uniform(3, size - 3, len(k))
                ang = local.uniform(0, np.pi, len(k))
                ln = local.uniform(2, 5, len(k))
                p2 = np.stack([
                    np.stack([cx - np.cos(ang) * ln, cy - np.sin(ang) * ln],
                             -1),
                    np.stack([cx + np.cos(ang) * ln, cy + np.sin(ang) * ln],
                             -1)], axis=1)  # (k, 2, 2)
                bar = _render_stroke_batch(
                    p2, np.asarray([[0, 1]], np.int32),
                    local.uniform(0.5, 0.9, len(k)).astype(np.float32),
                    size)
                img[k] = np.maximum(
                    img[k], bar * local.uniform(
                        0.20, 0.40, (len(k), 1, 1)))
            out[ii] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return out


def synth_digits(n_train: int = 60000, n_valid: int = 10000,
                 seed: int = 20260729, cache: bool = True
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full-size deterministic digit dataset (MNIST stand-in)."""
    tag = f"synthdigits_v{_DIGITS_VERSION}_{n_train}_{n_valid}_{seed}.npz"
    path = os.path.join(cache_dir(), tag)
    if cache and os.path.exists(path):
        with np.load(path) as z:
            return z["xt"], z["yt"], z["xv"], z["yv"]
    rng = np.random.default_rng(seed)
    yt = rng.integers(0, 10, n_train).astype(np.int32)
    yv = rng.integers(0, 10, n_valid).astype(np.int32)
    xt = render_digits(yt, rng)
    xv = render_digits(yv, rng)
    if cache:
        _publish_cache(path, xt=xt, yt=yt, xv=xv, yv=yv)
    return xt, yt, xv, yv


# ---------------------------------------------------------------------------
# SynthShapes: SDF shape renderer (CIFAR-10 stand-in)
# ---------------------------------------------------------------------------

def _shape_sdf(cls: int, x: np.ndarray, y: np.ndarray,
               r: np.ndarray) -> np.ndarray:
    """Signed distance (negative inside) for shape class ``cls`` at
    pose-normalized coords x, y (arrays (..., Q)); r = shape radius."""
    if cls == 0:       # disk
        return np.hypot(x, y) - r
    if cls == 1:       # ring (annulus)
        return np.abs(np.hypot(x, y) - r) - 0.38 * r
    if cls == 2:       # square
        return np.maximum(np.abs(x), np.abs(y)) - r
    if cls == 3:       # equilateral triangle (3 half-planes)
        k = np.sqrt(3.0)
        d1 = y - r * 0.5
        d2 = (-y * 0.5 + x * k / 2) - r * 0.5
        d3 = (-y * 0.5 - x * k / 2) - r * 0.5
        return np.maximum(np.maximum(d1, d2), d3)
    if cls == 4:       # 5-pointed star (angular radius modulation)
        th = np.arctan2(y, x)
        rad = np.hypot(x, y)
        return rad - r * (0.72 + 0.38 * np.cos(5 * th))
    if cls == 5:       # plus / cross
        ax, ay = np.abs(x), np.abs(y)
        w = 0.36 * r
        d_h = np.maximum(ax - r, ay - w)
        d_v = np.maximum(ax - w, ay - r)
        return np.minimum(d_h, d_v)
    if cls == 6:       # crescent (disk minus offset disk)
        d1 = np.hypot(x, y) - r
        d2 = np.hypot(x - 0.55 * r, y) - 0.78 * r
        return np.maximum(d1, -d2)
    if cls == 7:       # diamond (rotated square / L1 ball)
        return (np.abs(x) + np.abs(y)) - r * 1.2
    if cls == 8:       # three parallel bars clipped to a disk
        stripe = np.abs(((y / r) * 2.4 + 1.5) % 1.5 - 0.75) - 0.28
        return np.maximum(stripe * r, np.hypot(x, y) - r)
    if cls == 9:       # T shape (two rectangles)
        top = np.maximum(np.abs(x) - r, np.abs(y + 0.6 * r) - 0.32 * r)
        stem = np.maximum(np.abs(x) - 0.30 * r, np.abs(y - 0.2 * r)
                          - 0.75 * r)
        return np.minimum(top, stem)
    raise ValueError(cls)


def _low_freq_noise(rng: np.random.Generator, n: int, size: int,
                    coarse: int, channels: int = 3) -> np.ndarray:
    """Smooth random fields via bilinear-upsampled coarse noise."""
    c = rng.standard_normal((n, coarse, coarse, channels)).astype(np.float32)
    # bilinear upsample coarse -> size
    xi = np.linspace(0, coarse - 1, size)
    i0 = np.floor(xi).astype(int)
    i1 = np.minimum(i0 + 1, coarse - 1)
    f = (xi - i0).astype(np.float32)
    c = (c[:, i0] * (1 - f[None, :, None, None])
         + c[:, i1] * f[None, :, None, None])
    c = (c[:, :, i0] * (1 - f[None, None, :, None])
         + c[:, :, i1] * f[None, None, :, None])
    return c


def render_shapes(labels: np.ndarray, rng: np.random.Generator,
                  size: int = 32) -> np.ndarray:
    """Render RGB shape images; returns (n, size, size, 3) uint8."""
    chunk = 2 * _RENDER_CHUNK
    n = len(labels)
    out = np.empty((n, size, size, 3), np.uint8)
    # global per-sample nuisances (chunk-independent)
    rot = rng.uniform(0, 2 * np.pi, n)
    rad = rng.uniform(0.28, 0.46, n) * size
    cx = rng.uniform(0.35, 0.65, n) * size
    cy = rng.uniform(0.35, 0.65, n) * size
    aspect = rng.uniform(0.75, 1.3, n)
    fg = rng.uniform(0.15, 1.0, (n, 3)).astype(np.float32)
    outline = rng.random(n) < 0.25            # 25 % outline-only style
    contrast = rng.uniform(0.35, 1.0, n).astype(np.float32)
    noise_seed = rng.integers(0, 2 ** 31, n)
    g = np.stack(np.meshgrid(np.arange(size), np.arange(size),
                             indexing="xy"), axis=-1).astype(np.float32)
    px = g.reshape(-1, 2)                      # (Q, 2) (x, y)
    for lo in range(0, n, chunk):
        ii = np.arange(lo, min(lo + chunk, n))
        m = len(ii)
        local = np.random.default_rng(int(noise_seed[ii[0]]) ^ lo)
        # pose-normalized coordinates
        dx = (px[None, :, 0] - cx[ii, None])
        dy = (px[None, :, 1] - cy[ii, None])
        c, s = np.cos(rot[ii, None]), np.sin(rot[ii, None])
        xr = (c * dx + s * dy) * aspect[ii, None]
        yr = -s * dx + c * dy
        sd = np.empty((m, px.shape[0]), np.float32)
        for cls in range(10):
            k = np.nonzero(labels[ii] == cls)[0]
            if len(k):
                sd[k] = _shape_sdf(cls, xr[k], yr[k], rad[ii][k, None])
        edge = 1.0
        alpha = np.clip((-sd) / edge + 0.5, 0.0, 1.0)    # fill coverage
        ol = np.clip((1.6 - np.abs(sd)) / edge, 0.0, 1.0)  # outline band
        cover = np.where(outline[ii, None], ol, alpha)   # (m, Q)
        # background: low-frequency colored texture + lighting gradient
        bg = _low_freq_noise(local, m, size, coarse=4) * 0.22
        bg += _low_freq_noise(local, m, size, coarse=8) * 0.12
        base = local.uniform(0.1, 0.9, (m, 1, 1, 3)).astype(np.float32)
        gx = local.uniform(-0.25, 0.25, (m, 1, 1, 1)).astype(np.float32)
        gy = local.uniform(-0.25, 0.25, (m, 1, 1, 1)).astype(np.float32)
        ramp = (gx * (g[None, ..., :1] / size - 0.5)
                + gy * (g[None, ..., 1:] / size - 0.5))
        bg = np.clip(base + bg + ramp, 0.0, 1.0)
        # distractor: a small faint disk on ~35 % of images
        dmask = local.random(m) < 0.35
        if dmask.any():
            k = np.nonzero(dmask)[0]
            dcx = local.uniform(0.1, 0.9, len(k)) * size
            dcy = local.uniform(0.1, 0.9, len(k)) * size
            drr = local.uniform(0.06, 0.14, len(k)) * size
            dd = np.hypot(px[None, :, 0] - dcx[:, None],
                          px[None, :, 1] - dcy[:, None]) - drr[:, None]
            dal = np.clip(-dd + 0.5, 0, 1)[..., None]
            dcol = local.uniform(0, 1, (len(k), 1, 3)).astype(np.float32)
            flat = bg[k].reshape(len(k), -1, 3)
            flat = flat * (1 - 0.6 * dal) + dcol * 0.6 * dal
            bg[k] = flat.reshape(len(k), size, size, 3)
        # composite: low-contrast blend of fg color over bg
        covi = cover.reshape(m, size, size, 1)
        col = fg[ii, None, None, :] * contrast[ii, None, None, None] \
            + bg * (1 - contrast[ii, None, None, None])
        img = bg * (1 - covi) + col * covi
        img += local.normal(0, 0.045, img.shape)
        out[ii] = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return out


def synth_shapes(n_train: int = 50000, n_valid: int = 10000,
                 seed: int = 20260730, cache: bool = True, size: int = 32
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Full-size deterministic shape dataset (CIFAR-10 stand-in; at
    ``size=96`` with STL-10 split sizes it is the STL-10 stand-in —
    see models/stl.py)."""
    tag = (f"synthshapes_v{_SHAPES_VERSION}_{n_train}_{n_valid}_{seed}"
           + (f"_s{size}" if size != 32 else "") + ".npz")
    path = os.path.join(cache_dir(), tag)
    if cache and os.path.exists(path):
        with np.load(path) as z:
            return z["xt"], z["yt"], z["xv"], z["yv"]
    rng = np.random.default_rng(seed)
    yt = rng.integers(0, 10, n_train).astype(np.int32)
    yv = rng.integers(0, 10, n_valid).astype(np.int32)
    xt = render_shapes(yt, rng, size=size)
    xv = render_shapes(yv, rng, size=size)
    if cache:
        _publish_cache(path, xt=xt, yt=yt, xv=xv, yv=yv)
    return xt, yt, xv, yv
