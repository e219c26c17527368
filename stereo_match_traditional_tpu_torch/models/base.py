"""Shared pipeline result container (torch counterpart of
``stereo_match_traditional_tpu.models.base``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class StereoResult(NamedTuple):
    disp_left: torch.Tensor
    disp_right: Optional[torch.Tensor] = None
    disp_final: Optional[torch.Tensor] = None
    occlusion: Optional[torch.Tensor] = None
    mismatch: Optional[torch.Tensor] = None
