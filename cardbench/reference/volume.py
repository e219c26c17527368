"""The fused AD-Census cost volume of both views (`AD-Census.h:75-318`), in
plain PyTorch.

Volumes are dense ``[D, H, W]``.  The reference copies the previous-d cost
where the match column leaves the image, which for a pixelwise cost equals
reading the clamped column: ``S[d, i, j] = img[i, max(j - d, 0)]`` for the
left view and ``img[i, min(j + d, W - 1)]`` for the right one.
"""

from __future__ import annotations

import torch


def shifted_stack(img: torch.Tensor, disp_range: int, view: str = "left") -> torch.Tensor:
    """``S[d, ..., i, j]``: ``img`` shifted by ``d`` columns, edge-clamped."""
    w = img.shape[-1]
    cols = torch.arange(w, device=img.device)[None, :]
    ds = torch.arange(disp_range, device=img.device)[:, None]
    if view == "left":
        idx = (cols - ds).clamp_(0, w - 1)
    elif view == "right":
        idx = (cols + ds).clamp_(0, w - 1)
    else:
        raise ValueError(view)
    return img[..., idx].movedim(-2, 0)


def census_transform(img: torch.Tensor, rows: int = 9, cols: int = 7) -> torch.Tensor:
    """The census signature of each pixel as one int64 (`AD-Census.h:166-192`):
    for each offset of the ``rows x cols`` window in row-major order, shift
    left once and gain a 1 iff the centre is greater than the neighbour and
    the neighbour lies inside the image."""
    if rows * cols > 63:
        raise ValueError(f"census window {rows}x{cols} needs more than 63 bits")
    x = img.to(torch.float32)
    h, w = x.shape
    sig = torch.zeros((h, w), dtype=torch.int64, device=x.device)
    for r in range(-(rows // 2), rows // 2 + 1):
        ri = torch.arange(h, device=x.device) + r
        r_in = (ri >= 0) & (ri < h)
        xr = x.index_select(0, ri % h)
        for c in range(-(cols // 2), cols // 2 + 1):
            ci = torch.arange(w, device=x.device) + c
            inb = r_in[:, None] & ((ci >= 0) & (ci < w))[None, :]
            bit = (x > xr.index_select(1, ci.clamp(0, w - 1))) & inb
            sig = (sig << 1) | bit.to(torch.int64)
    return sig


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 (SWAR)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def ad_census_volume(left, right, disp_range: int, sigma_c: float, sigma_s: float,
                     rows: int, cols: int, view: str) -> torch.Tensor:
    """``(1 - exp(-AD / sigma_c)) + (1 - exp(-Hamming / sigma_s))``, float32
    (`AD-Census.h:271-318`).  The census signatures are computed once and
    read at the clamped match column."""
    lf, rf = left.to(torch.float32), right.to(torch.float32)
    cl, cr = census_transform(left, rows, cols), census_transform(right, rows, cols)
    if view == "left":
        ad = torch.abs(lf[None] - shifted_stack(rf, disp_range, "left"))
        ham = cl[None] ^ shifted_stack(cr, disp_range, "left")
    else:
        ad = torch.abs(shifted_stack(lf, disp_range, "right") - rf[None])
        ham = shifted_stack(cl, disp_range, "right") ^ cr[None]
    cen = popcount64(ham).to(torch.float32)
    return (1.0 - torch.exp(-ad / sigma_c)) + (1.0 - torch.exp(-cen / sigma_s))
