"""Standalone image filters (torch counterpart of
``stereo_match_traditional_tpu.ops.filters``).

The reference's dormant bilateral filter: `bilateralfiter`
(`ASW/ASW.h:260-327`, driven by the uncompiled `ASW/TeddyBilateral.cpp`) and
the 1/3-channel variants of `ASW/BiliteralFilter.h:49-242`.  The reference
stores float weights into uchar masks and normalizes after rounding
(`ASW.h:296-300`); this is the intended bilateral, as in the JAX package:
a per-channel range weight ``exp(-dI^2 / 2 sigma_c^2)`` times the spatial
Gaussian, normalized per channel.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops.volume import _space_mask, replicate_pad


def bilateral_filter(
    img: torch.Tensor,
    radius: int = 12,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
) -> torch.Tensor:
    """Edge-preserving bilateral smoothing, grey ``[H, W]`` or colour
    ``[H, W, C]``, float32 out (callers quantize for display; the reference
    clamps to 255 and casts, `ASW.h:318-323`).

    Replicate-padded borders (`copyMakeBorder(BORDER_REPLICATE)`,
    `ASW.h:267`); each channel weighted on its own
    (`BiliteralFilter.h:146-238`).  Plain PyTorch on every device: a loop
    over the ``(2 radius + 1)^2`` window offsets, each the JAX package's
    ``lax.scan`` step.
    """
    squeeze = img.dim() == 2
    x = img.to(torch.float32)
    if squeeze:
        x = x[..., None]
    h, w, _ = x.shape
    side = 2 * radius + 1
    xp = replicate_pad(x.movedim(-1, 0), radius)            # [C, Hp, Wp]
    space = _space_mask(radius, space_sigma, x.device).tolist()
    inv2sc = 1.0 / (2.0 * color_sigma * color_sigma)
    center = xp[:, radius : radius + h, radius : radius + w]
    num = torch.zeros_like(center)
    den = torch.zeros_like(center)
    for dy in range(side):
        for dx in range(side):
            sh = xp[:, dy : dy + h, dx : dx + w]
            wgt = torch.exp(-((sh - center) ** 2) * inv2sc) * space[dy][dx]
            num += wgt * sh
            den += wgt
    out = (num / torch.clamp(den, min=1e-20)).movedim(0, -1)
    return out[..., 0] if squeeze else out
