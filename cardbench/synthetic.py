"""Synthetic rectified stereo pairs with ground truth, made from a seed.

The benchmark's own copy of the measured package's ``utils.synthetic``
generator: the same seed gives the same bytes.  A smooth random texture is
warped by a piecewise-smooth integer disparity field with a foreground
box; columns no left pixel reaches keep background texture.
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
    feature_scale: int = 24,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(left, right, gt_disp)``: ``left[i, j]`` views the scene point at
    ``right[i, j - d]``.  The disparity ramp spans ``0.45 * max_disp`` over
    features of ``feature_scale`` pixels; ``24 * max_disp // 60`` keeps the
    slope of the D=60 calibration at a higher ``max_disp``."""
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

    return _to_u8(left), _to_u8(right), disp.astype(np.float32)
