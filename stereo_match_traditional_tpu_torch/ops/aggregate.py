"""Cost aggregation (torch counterpart of
``stereo_match_traditional_tpu.ops.aggregate``): cross arms and the
arm-rectangle mean.

Arm growth is a leading-ones count over a stack of ``max_length`` shifted
threshold predicates; the rectangle mean is a summed-area table (two
cumsums) plus four corner picks per pixel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_match_traditional_tpu_torch.config import CrossArmConfig

# The JAX package's rect_mean_aggregate layouts; each runs the port's one layout
RECT_LAYOUTS = ("auto", "dmajor", "pixel_major")


class Arms(NamedTuple):
    """Per-pixel cross-arm lengths, int32 [H, W] each."""

    left: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor


def _max_channel_diff(a: torch.Tensor, b: torch.Tensor, color: bool) -> torch.Tensor:
    d = torch.abs(a.to(torch.float32) - b.to(torch.float32))
    if color:
        d = d.amax(dim=-1)
    return d


def _directional_shifts(img: torch.Tensor, n: int, axis: int, sign: int) -> torch.Tensor:
    """``values[o-1, i, j(, c)]`` = img shifted by ``o*sign`` along ``axis``,
    edge-clamped."""
    size = img.shape[axis]
    offs = torch.arange(1, n + 1, device=img.device)
    idx = (torch.arange(size, device=img.device)[None, :] + sign * offs[:, None]).clamp_(0, size - 1)
    out = img.index_select(axis, idx.reshape(-1))
    out = out.reshape(img.shape[:axis] + (n, size) + img.shape[axis + 1:])
    return out.movedim(axis, 0)


def _arm_one_direction(img: torch.Tensor, cfg: CrossArmConfig, axis: int, sign: int) -> torch.Tensor:
    """Arm length along one direction (`CrossArm.cpp:147-260`).

    Offset o is accepted iff in bounds and the max channel difference to
    the *centre* pixel is <= tao(o), tao1 for o <= sec_length else tao2.
    The arm is the number of leading accepted offsets, capped at
    max_length; a threshold failure at o=1 still gives arm 1 when the
    pixel is >= 2 pixels from the border (`CrossArm.cpp:186-196`).
    """
    n = cfg.max_length
    size = img.shape[axis]
    pos = torch.arange(size, device=img.device)
    offs = torch.arange(1, n + 1, device=img.device)
    tgt = pos[None, :] + sign * offs[:, None]                  # [n, size]
    shape = [n, 1, 1]
    shape[axis + 1] = size
    inb = ((tgt >= 0) & (tgt <= size - 1)).reshape(shape)

    diff = _max_channel_diff(_directional_shifts(img, n, axis, sign), img[None],
                             color=img.dim() == 3)
    tao = torch.where(offs <= cfg.sec_length, float(cfg.tao1), float(cfg.tao2))
    tao = tao.to(torch.float32).reshape(n, 1, 1)
    ok = inb & (diff <= tao)
    leading = ok.to(torch.int32).cumprod(dim=0).sum(dim=0, dtype=torch.int32)

    # min-1 rule: the first offset failed the threshold (not the border)
    # and the pixel is at least 2 from the border in this direction
    fail1 = inb[0] & (diff[0] > tao[0])
    border_ok = pos >= 2 if sign < 0 else pos <= size - 3
    shape2 = [1, 1]
    shape2[axis] = size
    min1 = (leading == 0) & fail1 & border_ok.reshape(shape2)
    return torch.where(min1, 1, leading).to(torch.int32)


def cross_arms(img: torch.Tensor, cfg: CrossArmConfig) -> Arms:
    """All four arms of one image, gray ``[H, W]`` or colour ``[H, W, 3]``
    (`CrossArm.cpp:147-598`, with the ``col=_row`` right-arm bug at
    `CrossArm.cpp:265` fixed as the JAX package does)."""
    return Arms(
        left=_arm_one_direction(img, cfg, 1, -1),
        right=_arm_one_direction(img, cfg, 1, +1),
        up=_arm_one_direction(img, cfg, 0, -1),
        down=_arm_one_direction(img, cfg, 0, +1),
    )


def _sat(x: torch.Tensor) -> torch.Tensor:
    """Summed-area table in float64 with a zero border, ``S[..., i, j] =
    sum x[..., :i, :j]``; columns first, then rows.

    float64, where the JAX package sums in float32: a float32 SAT of a
    Teddy slice reaches ~3e5 (ulp 0.03) and of a 720p slice ~2e6 (ulp
    0.125), and the rectangle sums are differences of such entries.  In
    float64 the AD-Census costs (0 or >= 1 - exp(-1/30), so no bit below
    2^-28) sum exactly below 2^25, so the sums are exact, equal on the CPU
    and the card whatever the summation order, and a rectangle's mean is
    the same for two disparities whose costs agree on it (the clamp
    triangle), where a float32 SAT breaks such ties by rounding.
    """
    c = x.to(torch.float64).cumsum(dim=-1).cumsum(dim=-2)
    return torch.nn.functional.pad(c, (1, 0, 1, 0))


def _rect_sums(vol: torch.Tensor, i0, i1, j0, j1) -> torch.Tensor:
    """Inclusive rectangle sums of every d-slice of ``vol`` [D, H, W] with
    ``[H, W]`` bounds shared across the disparity axis: four corner picks
    from the SAT, combined in the JAX package's order, rounded to
    ``vol``'s dtype."""
    d, h, w = vol.shape
    sat = _sat(vol)
    wp = sat.shape[-1]
    flat = sat.reshape(d, -1)

    def g(ii, jj):
        return flat.index_select(1, (ii * wp + jj).reshape(-1))

    out = g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
    return out.reshape(d, h, w).to(vol.dtype)


def rect_mean_aggregate(
    vol: torch.Tensor,
    arms: Arms,
    inclusive: bool = True,
    max_span: Optional[int] = None,
    layout: str = "auto",
) -> torch.Tensor:
    """Per-pixel arm-rectangle mean over each disparity slice of ``vol``
    [D, H, W].

    ``inclusive=True`` is the active `AggregationVertical`
    (`CrossArm.cpp:60-102`, bounds -L..R x -up..down inclusive);
    ``inclusive=False`` the dormant exclusive-upper `Aggregation`
    (`CrossArm.cpp:104-145`).  Where an exclusive rectangle is empty the
    centre cost is kept (the reference divides 0/0 there).

    ``max_span`` and ``layout`` take the JAX package's positions and values
    so that its call sites copy across.  There they choose how the TPU
    gathers (a row-chunked gather source bounded by ``max_span``; the
    ``'dmajor'`` or ``'pixel_major'`` SAT layout): the TPU layouts are not
    ported (ROADMAP.md, North star), so every ``layout`` runs the port's one
    layout and ``max_span`` changes nothing.  An unknown ``layout`` raises
    ``ValueError``.
    """
    if layout not in RECT_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {RECT_LAYOUTS}")
    h, w = vol.shape[-2:]
    ii = torch.arange(h, device=vol.device, dtype=torch.int64)[:, None]
    jj = torch.arange(w, device=vol.device, dtype=torch.int64)[None, :]
    up, down, left, right = (a.to(torch.int64) for a in (arms.up, arms.down, arms.left, arms.right))
    if inclusive:
        i0, i1 = ii - up, ii + down
        j0, j1 = jj - left, jj + right
        count = (up + down + 1) * (left + right + 1)
    else:
        i0, i1 = ii - up, ii + down - 1
        j0, j1 = jj - left, jj + right - 1
        count = (up + down) * (left + right)
    total = _rect_sums(
        vol, i0.clamp(0, h - 1), i1.clamp(0, h - 1), j0.clamp(0, w - 1), j1.clamp(0, w - 1)
    )
    mean = total / count.clamp(min=1).to(vol.dtype)
    return torch.where(count > 0, mean, vol)
