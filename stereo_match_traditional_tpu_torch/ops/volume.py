"""Cost-volume construction (torch counterpart of
``stereo_match_traditional_tpu.ops.volume``).

Volumes are dense ``[D, H, W]`` float32 tensors, the JAX package's layout,
so the two are compared like for like.

Border semantics: the reference copies the previous-d cost when the match
column underflows (`SAD/Sad.h:125-128`, `AD-Census.h:88-92`), which equals
evaluating the cost at the last valid disparity ``min(d, j)`` (or
``min(d, W-1-j)`` for right-view volumes) — :func:`border_fill`.
"""

from __future__ import annotations

import torch


def _clamped_range(start: int, stop: int, size: int, device) -> torch.Tensor:
    return torch.arange(start, stop, device=device).clamp_(0, size - 1)


def replicate_pad(img: torch.Tensor, pad_r: int, pad_c: int = None) -> torch.Tensor:
    """`copyMakeBorder(BORDER_REPLICATE)` on the last two axes."""
    if pad_c is None:
        pad_c = pad_r
    h, w = img.shape[-2:]
    rows = _clamped_range(-pad_r, h + pad_r, h, img.device)
    cols = _clamped_range(-pad_c, w + pad_c, w, img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def shifted_stack(
    img: torch.Tensor, disp_range: int, view: str = "left", d_offset: int = 0
) -> torch.Tensor:
    """Stack of horizontally shifted copies ``S[d, ..., i, j]``.

    view='left':  ``S[d, i, j] = img[i, max(j - d, 0)]`` (`SAD/Sad.h:130`).
    view='right': ``S[d, i, j] = img[i, min(j + d, W-1)]`` (`SAD/Sad.h:173`).
    ``d_offset`` starts the disparity block at ``d_offset``.
    """
    w = img.shape[-1]
    cols = torch.arange(w, device=img.device)[None, :]
    ds = torch.arange(disp_range, device=img.device)[:, None] + d_offset
    if view == "left":
        idx = (cols - ds).clamp_(0, w - 1)  # [D, W]
    elif view == "right":
        idx = (cols + ds).clamp_(0, w - 1)
    else:
        raise ValueError(view)
    # img [..., H, W] indexed on the last axis by [D, W] -> [..., H, D, W]
    return img[..., idx].movedim(-2, 0)


def border_fill(vol: torch.Tensor, view: str = "left") -> torch.Tensor:
    """Replace the invalid triangle with the last-valid-d cost:
    ``out[d, i, j] = vol[min(d, j), i, j]`` for the left view and
    ``min(d, W-1-j)`` for the right view (`ASW/ASW.h:371`,
    `AD-Census.h:88-92`)."""
    d, h, w = vol.shape
    if min(d - 1, w) <= 0:
        return vol
    cols = torch.arange(w, device=vol.device)[None, :]
    dd = torch.arange(d, device=vol.device)[:, None]
    lim = cols if view == "left" else (w - 1 - cols)
    eff = torch.minimum(dd, lim)  # [D, W], always in [0, D)
    return torch.gather(vol, 0, eff[:, None, :].expand(d, h, w))


def right_volume_from_left(vol_left: torch.Tensor) -> torch.Tensor:
    """Right-view volume by the exact shift identity
    ``costR(q, d) = costL(q + d, d)`` (`ASW/ASW.h:382-431`), with the
    ``q + d > W - 1`` triangle filled by :func:`border_fill` ``('right')``."""
    d, h, w = vol_left.shape
    cols = torch.arange(w, device=vol_left.device)[None, :]
    ds = torch.arange(d, device=vol_left.device)[:, None]
    idx = torch.clamp(cols + ds, max=w - 1)  # [D, W]
    shifted = torch.gather(vol_left, 2, idx[:, None, :].expand(d, h, w))
    return border_fill(shifted, "right")


# ---------------------------------------------------------------------------
# ASW (adaptive support weight) cost
# ---------------------------------------------------------------------------


def _space_mask(radius: int, space_sigma: float, device) -> torch.Tensor:
    """Gaussian proximity mask over the support window (`ASW/ASW.h:16-35`;
    never normalized)."""
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    return torch.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2.0 * space_sigma**2))


def asw_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    view: str = "left",
) -> torch.Tensor:
    """Adaptive-support-weight cost volume (`ASW/ASW.h:210-257,329-431`).

    cost(p, d) = sum_o wL(p,o) * wR(p-d,o) * e(p,o,d) / sum_o wL*wR with
    w(p,o) = exp(-|I(p)-I(p+o)|^2 / 2 sigma_c^2) * exp(-|o|^2 / 2 sigma_s^2)
    and e = min(|L(p+o) - R(p+o-d)|, T).

    The plain version of the CUDA kernel (`ops.kernels.asw_cuda`): a loop
    over the (2R+1)^2 window offsets, R = win_size + 1, doing the JAX
    reference's ``lax.scan`` step math in the same order on [D, H, W]
    tensors.
    """
    if view == "right":
        return asw_volume_right(
            left, right, disp_range, win_size, space_sigma, color_sigma, truncation
        )
    radius = win_size + 1
    lf = left.to(torch.float32)
    rf = right.to(torch.float32)
    h, w = lf.shape
    side = 2 * radius + 1
    space = _space_mask(radius, space_sigma, lf.device).tolist()

    lp = replicate_pad(lf, radius)
    rp = replicate_pad(rf, radius)
    # A[d] = min(|L - R(. - d)|, T) on padded images; the shift stack clamps
    # at the left edge but those entries are overwritten by border_fill.
    err = torch.clamp(torch.abs(lp[None] - shifted_stack(rp, disp_range, "left")),
                      max=truncation)  # [D, Hp, Wp]
    l_c = lp[radius : radius + h, radius : radius + w]
    r_c = rp[radius : radius + h, radius : radius + w]
    inv = 2.0 * color_sigma**2

    num = torch.zeros((disp_range, h, w), dtype=torch.float32, device=lf.device)
    den = torch.zeros_like(num)
    for dy in range(side):
        for dx in range(side):
            sp = space[dy][dx]
            l_sh = lp[dy : dy + h, dx : dx + w]
            r_sh = rp[dy : dy + h, dx : dx + w]
            w_l = torch.exp(-((l_sh - l_c) ** 2) / inv) * sp
            w_r = torch.exp(-((r_sh - r_c) ** 2) / inv) * sp
            # wR evaluated at p - d: the weight map shifted by d
            wlr = w_l[None] * shifted_stack(w_r, disp_range, "left")
            num += wlr * err[:, dy : dy + h, dx : dx + w]
            den += wlr
    vol = num / torch.clamp(den, min=1e-20)
    return border_fill(vol, "left")


def asw_volume_right(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
) -> torch.Tensor:
    """Right-view ASW volume (`ASW/ASW.h:382-431`) by mirror symmetry: the
    left-view problem on horizontally flipped images with the roles
    swapped."""
    vol = asw_volume(
        torch.flip(right, [1]), torch.flip(left, [1]), disp_range, win_size,
        space_sigma, color_sigma, truncation, "left",
    )
    return torch.flip(vol, [2])
