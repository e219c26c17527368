"""Disparity selection (torch counterpart of
``stereo_match_traditional_tpu.ops.wta``).  Ties resolve to the first
(lowest-d) extremum, as in every reference C++ loop; ``torch.argmin`` and
``torch.argmax`` both return the first extremum."""

from __future__ import annotations

import torch


def wta(vol: torch.Tensor, mode: str = "min") -> torch.Tensor:
    """Plain winner-take-all over the disparity axis (dim 0), as float32.

    mode='min': `ASW.h:193-208`; mode='max': NCC similarity argmax.
    """
    if mode == "min":
        return torch.argmin(vol, dim=0).to(torch.float32)
    return torch.argmax(vol, dim=0).to(torch.float32)
