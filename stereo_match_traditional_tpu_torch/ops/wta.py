"""Disparity selection (torch counterpart of
``stereo_match_traditional_tpu.ops.wta``): plain WTA and the SAD
uniqueness WTA.  Ties resolve to the first (lowest-d) extremum, as in every
reference C++ loop; ``torch.argmin`` and ``torch.argmax`` both return the
first extremum."""

from __future__ import annotations

import torch


def wta(vol: torch.Tensor, mode: str = "min") -> torch.Tensor:
    """Plain winner-take-all over the disparity axis (dim 0), as float32.

    mode='min': `ASW.h:193-208`; mode='max': NCC similarity argmax.
    """
    if mode == "min":
        return torch.argmin(vol, dim=0).to(torch.float32)
    return torch.argmax(vol, dim=0).to(torch.float32)


def optimal_disparity(
    vol: torch.Tensor,
    uniqueness_eps: float = 0.01,
    subpixel: bool = False,
    exclude_d0: bool = True,
) -> torch.Tensor:
    """WTA with the uniqueness test and optional parabola refinement
    (`SAD/Sad.h:40-85`, `CBLSM/CBLSM.h:249-294`):

    * the argmin scan starts at d=1 (`Sad.h:46`), so d=0 never wins;
      ``exclude_d0=False`` scans from d=0;
    * ``secMin`` is seeded with cost[0] and takes the minimum over every
      cost ``!=`` the best cost (`Sad.h:44,55-64`); ``secMin - min <= eps``
      rejects the pixel to 0 (`Sad.h:66-69`);
    * a best disparity at either end of the range is rejected (`Sad.h:71-74`);
    * the parabola offset ``(c1-c2) / (2*max(1, c1+c2-2*min))`` is kept only
      when ``subpixel`` (the reference computes and discards it, `Sad.h:84`).

    Every per-pixel pick is a masked reduction, as in the JAX package.
    """
    d = vol.shape[0]
    scan = vol[1:] if exclude_d0 else vol
    best = torch.argmin(scan, dim=0) + (1 if exclude_d0 else 0)
    minval = torch.amin(scan, dim=0)
    inf = float("inf")
    sec = torch.amin(torch.where(vol != minval[None], vol, inf), dim=0)
    sec = torch.minimum(vol[0], sec)
    reject = (sec - minval <= uniqueness_eps) | (best == 0) | (best == d - 1)

    dd = torch.arange(d, device=vol.device)[:, None, None]
    c1 = torch.amin(torch.where(dd == (best - 1)[None], vol, inf), dim=0)
    c2 = torch.amin(torch.where(dd == (best + 1)[None], vol, inf), dim=0)
    # best +- 1 leaves the range only where the pixel is rejected already
    denom = torch.clamp(c1 + c2 - 2.0 * minval, min=1.0)
    refined = best.to(torch.float32) + (c1 - c2) / (2.0 * denom)
    out = refined if subpixel else best.to(torch.float32)
    return torch.where(reject, 0.0, out)
