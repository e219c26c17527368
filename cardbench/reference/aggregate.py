"""Cross arms and cost aggregation in plain PyTorch: the reference's arms and
arm-rectangle mean (`AD-CensusV1/CrossArm.cpp:60-260`) and the canonical
CrossAggregator's arms and two-pass cross aggregation
(`CBLSM/cross_aggregator.cpp:76-394`).

Sums run in float64 and are rounded once to the volume's dtype, so a
volume given in a lower precision is aggregated in that precision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Arms(NamedTuple):
    """Arm lengths of each pixel, int32 ``[H, W]`` each."""

    left: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor


def _shifts(img: torch.Tensor, n: int, axis: int, sign: int) -> torch.Tensor:
    """``out[o - 1]`` = ``img`` shifted by ``o * sign`` along ``axis``, edge-clamped."""
    size = img.shape[axis]
    offs = torch.arange(1, n + 1, device=img.device)
    idx = (torch.arange(size, device=img.device)[None, :] + sign * offs[:, None]).clamp_(0, size - 1)
    out = img.index_select(axis, idx.reshape(-1))
    return out.reshape(img.shape[:axis] + (n, size) + img.shape[axis + 1:]).movedim(axis, 0)


def _in_bounds(size: int, n: int, axis: int, sign: int, device):
    """``(pos, offs, inb)``: positions along ``axis``, offsets 1..n, and
    whether each offset's pixel lies in the image, shaped to broadcast
    against ``[n, H, W]``."""
    pos = torch.arange(size, device=device)
    offs = torch.arange(1, n + 1, device=device)
    tgt = pos[None, :] + sign * offs[:, None]
    shape = [n, 1, 1]
    shape[axis + 1] = size
    return pos, offs, ((tgt >= 0) & (tgt <= size - 1)).reshape(shape)


def _arm(img: torch.Tensor, tao1: float, tao2: float, max_length: int, sec_length: int,
         axis: int, sign: int) -> torch.Tensor:
    """One direction's arm (`CrossArm.cpp:147-260`): the number of leading
    offsets whose pixel is in the image and within ``tao1`` (``tao2`` beyond
    ``sec_length``) of the centre, at most ``max_length``; a failed first
    offset still gives 1 at two pixels or more from the border
    (`CrossArm.cpp:186-196`)."""
    n = max_length
    size = img.shape[axis]
    pos, offs, inb = _in_bounds(size, n, axis, sign, img.device)
    diff = torch.abs(_shifts(img, n, axis, sign).to(torch.float32) - img[None].to(torch.float32))
    tao = torch.where(offs <= sec_length, float(tao1), float(tao2)).to(torch.float32)
    tao = tao.reshape(n, 1, 1)
    ok = inb & (diff <= tao)
    leading = ok.to(torch.int32).cumprod(dim=0).sum(dim=0, dtype=torch.int32)
    fail1 = inb[0] & (diff[0] > tao[0])
    border_ok = pos >= 2 if sign < 0 else pos <= size - 3
    shape2 = [1, 1]
    shape2[axis] = size
    min1 = (leading == 0) & fail1 & border_ok.reshape(shape2)
    return torch.where(min1, 1, leading).to(torch.int32)


def cross_arms(img: torch.Tensor, arms: dict) -> Arms:
    """The four arms of a grey ``[H, W]`` image; ``arms`` holds ``tao1``,
    ``tao2``, ``max_length`` and ``sec_length``."""
    args = (arms["tao1"], arms["tao2"], arms["max_length"], arms["sec_length"])
    return Arms(left=_arm(img, *args, 1, -1), right=_arm(img, *args, 1, +1),
                up=_arm(img, *args, 0, -1), down=_arm(img, *args, 0, +1))


def _canonical_arm(img: torch.Tensor, p: dict, axis: int, sign: int) -> torch.Tensor:
    """One direction's canonical arm (`cross_aggregator.cpp:135-269`): an
    offset extends the arm iff its pixel is in the image, within ``cross_t1``
    of the centre and of the previous offset's pixel, and within
    ``cross_t2`` of the centre beyond ``cross_l2``; at most
    ``min(cross_l1, 255)``."""
    n = min(p["cross_l1"], 255)
    _, offs, inb = _in_bounds(img.shape[axis], n, axis, sign, img.device)
    shifts = _shifts(img, n, axis, sign).to(torch.float32)
    centre = img[None].to(torch.float32)
    d_center = torch.abs(shifts - centre)
    d_prev = torch.abs(shifts - torch.cat([centre, shifts[:-1]]))
    ok = (d_center < p["cross_t1"]) & inb
    ok[1:] &= d_prev[1:] < p["cross_t1"]
    beyond_l2 = (offs > p["cross_l2"]).reshape(n, 1, 1)
    ok &= ~beyond_l2 | (d_center < p["cross_t2"])
    return ok.to(torch.int32).cumprod(dim=0).sum(dim=0, dtype=torch.int32)


def canonical_cross_arms(img: torch.Tensor, p: dict) -> Arms:
    """The four canonical arms of a grey ``[H, W]`` image (``p``: the
    configuration's ``cross_params``)."""
    return Arms(left=_canonical_arm(img, p, 1, -1), right=_canonical_arm(img, p, 1, +1),
                up=_canonical_arm(img, p, 0, -1), down=_canonical_arm(img, p, 0, +1))


def rect_mean(vol: torch.Tensor, arms: Arms) -> torch.Tensor:
    """The mean of each d-slice of ``vol`` over each pixel's inclusive arm
    rectangle ``-left..right x -up..down`` (`CrossArm.cpp:60-102`): a
    float64 summed-area table, four corner picks, rounded to ``vol``'s
    dtype, divided by the pixel count."""
    d, h, w = vol.shape
    ii = torch.arange(h, device=vol.device)[:, None]
    jj = torch.arange(w, device=vol.device)[None, :]
    up, down, left, right = (a.to(torch.int64) for a in (arms.up, arms.down, arms.left, arms.right))
    i0, i1 = (ii - up).clamp(0, h - 1), (ii + down).clamp(0, h - 1)
    j0, j1 = (jj - left).clamp(0, w - 1), (jj + right).clamp(0, w - 1)
    count = (up + down + 1) * (left + right + 1)
    sat = torch.nn.functional.pad(vol.to(torch.float64).cumsum(-1).cumsum(-2), (1, 0, 1, 0))
    wp = w + 1
    flat = sat.reshape(d, -1)

    def g(a, b):
        return flat.index_select(1, (a * wp + b).reshape(-1))

    total = g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
    total = total.reshape(d, h, w).to(vol.dtype)
    return total / count.clamp(min=1).to(vol.dtype)


def _span_sum(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum x[lo <= t < hi]`` along ``dim`` (-1 or -2) with ``[H, W]``
    bounds: a float64 (floating ``x``) or exact integer prefix sum and two
    picks, rounded to ``x``'s dtype once."""
    acc = torch.float64 if x.is_floating_point() else x.dtype
    h, w = x.shape[-2:]
    pad = (1, 0) if dim == -1 else (0, 0, 1, 0)
    cs = torch.nn.functional.pad(x.cumsum(dim=dim, dtype=acc), pad)
    flat = cs.reshape(*cs.shape[:-2], -1)
    if dim == -1:
        base = torch.arange(h, device=x.device)[:, None] * (w + 1)
    else:
        base = torch.arange(w, device=x.device)[None, :]
        lo, hi = lo * w, hi * w
    out = (flat.index_select(-1, (base + hi).reshape(-1))
           - flat.index_select(-1, (base + lo).reshape(-1)))
    return out.reshape(x.shape).to(x.dtype)


def hsum(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``sum_{t=-left..right} x[..., i, j + t]``, clipped to the image."""
    w = x.shape[-1]
    jj = torch.arange(w, device=x.device)[None, :]
    return _span_sum(x, (jj - left.to(torch.int64)).clamp(0, w),
                     (jj + right.to(torch.int64) + 1).clamp(0, w), -1)


def vsum(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``sum_{t=-up..down} x[..., i + t, j]``, clipped to the image."""
    h = x.shape[-2]
    ii = torch.arange(h, device=x.device)[:, None]
    return _span_sum(x, (ii - up.to(torch.int64)).clamp(0, h),
                     (ii + down.to(torch.int64) + 1).clamp(0, h), -2)


def cross_aggregate(vol: torch.Tensor, arms: Arms, num_iters: int) -> torch.Tensor:
    """``num_iters`` iterations of the two-pass cross aggregation
    (`cross_aggregator.cpp:89-118, 271-394`): a horizontal then a vertical
    span sum over the arms, divided by the support's pixel count, the pass
    order flipped each iteration."""
    ones = torch.ones(vol.shape[-2:], dtype=vol.dtype, device=vol.device)
    sup_h_first = vsum(hsum(ones, arms.left, arms.right), arms.up, arms.down)
    sup_v_first = hsum(vsum(ones, arms.up, arms.down), arms.left, arms.right)
    out = vol
    for k in range(num_iters):
        if k % 2 == 0:
            out = vsum(hsum(out, arms.left, arms.right), arms.up, arms.down) / sup_h_first
        else:
            out = hsum(vsum(out, arms.up, arms.down), arms.left, arms.right) / sup_v_first
    return out
