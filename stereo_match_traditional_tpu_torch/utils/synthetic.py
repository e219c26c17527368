"""Synthetic rectified stereo pairs with ground truth.

The port's own NumPy copy of ``stereo_match_traditional_tpu.utils.synthetic``:
the same seed gives the same bytes in both packages.

The reference repo ships no images (it hard-codes Middlebury Teddy file
names, `SAD/SADmain.cpp:27-28`).  This environment has no network, so tests
and benchmarks generate procedural pairs: a smooth random texture warped by a
piecewise-smooth disparity field, with left-edge occlusion handled by
replicate sampling.  ``bad-2.0`` against the returned ground truth is the
accuracy metric (BASELINE.md).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth_noise(rng: np.random.Generator, h: int, w: int, scale: int) -> np.ndarray:
    """Random field bilinearly upsampled from a coarse grid -> smooth texture."""
    gh, gw = max(2, h // scale + 2), max(2, w // scale + 2)
    grid = rng.standard_normal((gh, gw))
    ys = np.linspace(0, gh - 1.001, h)
    xs = np.linspace(0, gw - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    v = (
        grid[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
        + grid[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
        + grid[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
        + grid[np.ix_(y0 + 1, x0 + 1)] * fy * fx
    )
    return v


def make_pair(
    height: int = 96,
    width: int = 128,
    max_disp: int = 16,
    seed: int = 0,
    color: bool = False,
    feature_scale: int = 24,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Build (left, right, gt_disp).

    ``left[i, j]`` views the scene point that appears at ``right[i, j - d]``
    (the standard rectified geometry assumed throughout the reference, e.g.
    `SAD/Sad.h:130`).  Disparity is integer-valued and piecewise smooth with
    a foreground box, so WTA pipelines can recover it near-exactly.

    ``feature_scale``: pixel size of the disparity field's smooth features.
    The default 24 keeps every historical BASELINE.md row comparable, but
    note its slope consequence (measured round 5): the ramp's amplitude is
    ``0.45 * max_disp`` over fixed 24-px features, so local |grad GT|
    scales with ``max_disp`` — at D=256, 24% of pixels exceed 1 d/px,
    which no local window matcher resolves within the fixed bad-2.0
    threshold (the measured ~0.4 floor at 4K is a property of this pair).
    Real high-resolution scenes have sub-pixel disparity gradients; pass
    ``feature_scale=24 * max_disp // 60`` (slope-capped at the D=60
    calibration level) for a REPRESENTATIVE high-D evaluation pair.
    """
    rng = np.random.default_rng(seed)
    # Texture must be busy enough for window matching: mix several scales.
    tex = (
        _smooth_noise(rng, height, width + max_disp, 4) * 0.6
        + _smooth_noise(rng, height, width + max_disp, 9) * 0.3
        + rng.standard_normal((height, width + max_disp)) * 0.08
    )
    tex = (tex - tex.min()) / (tex.max() - tex.min() + 1e-9)

    # Piecewise-smooth disparity: smooth ramp + a foreground rectangle.
    base = _smooth_noise(rng, height, width, feature_scale)
    base = (base - base.min()) / (base.max() - base.min() + 1e-9)
    disp = 2.0 + base * (max_disp * 0.45)
    y0, y1 = height // 4, height * 3 // 4
    x0, x1 = width // 3, width * 2 // 3
    disp[y0:y1, x0:x1] = max_disp * 0.75
    disp = np.clip(np.round(disp), 1, max_disp - 2).astype(np.int32)

    cols = np.arange(width)
    # left[i, j] = tex[i, j + max_disp]; right is built by scattering each
    # left pixel to column j - d (so right[i, j - d] == left[i, j]); columns
    # never hit by a scatter (occlusions / left edge) keep background texture.
    left = tex[:, max_disp : max_disp + width]
    right = tex[:, :width].copy()
    rows = np.arange(height)[:, None].repeat(width, 1)
    tgt = cols[None, :] - disp
    valid = tgt >= 0
    right[rows[valid], tgt[valid]] = left[valid]

    def _to_u8(x):
        return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)

    left_u8, right_u8 = _to_u8(left), _to_u8(right)
    if color:
        def _colorize(g):
            g = g.astype(np.float32)
            return np.clip(
                np.stack([g, 0.8 * g + 20.0, 0.9 * g + 10.0], axis=-1), 0, 255
            ).astype(np.uint8)

        return _colorize(left_u8), _colorize(right_u8), disp.astype(np.float32)
    return left_u8, right_u8, disp.astype(np.float32)


def bad_pixel_rate(
    disp: np.ndarray, gt: np.ndarray, thresh: float = 2.0, valid: np.ndarray = None
) -> float:
    """Fraction of evaluated pixels with |disp - gt| > thresh (bad-2.0).

    Non-finite disparities count as bad; pixels outside the caller's
    ``valid`` mask (e.g. occluded ground truth) are excluded from both the
    numerator and the denominator.
    """
    disp = np.asarray(disp, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    with np.errstate(invalid="ignore"):
        bad = ~np.isfinite(disp) | (np.abs(disp - gt) > thresh)
    if valid is not None:
        if not valid.any():
            return 0.0
        bad = bad[valid]
    return float(bad.mean())
