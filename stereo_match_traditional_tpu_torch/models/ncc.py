"""NCC window-matching pipeline (`NCC/NCC_main.cpp:8-60`), torch
counterpart of ``stereo_match_traditional_tpu.models.ncc``."""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import NCCConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import wta
from stereo_match_traditional_tpu_torch.ops.kernels import ncc_volume_cuda
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def ncc_pipeline(
    left, right, cfg: NCCConfig = NCCConfig(), return_stages: bool = False
) -> StereoResult:
    """21x21 NCC similarity volume -> argmax WTA (`NCC/NCC.h:69-95`); pixels
    outside the reference's loop range (`NCC.h:72-75`) keep 0 disparity
    (`Mat::zeros`, `NCC_main.cpp:20`).

    The volume is the CUDA kernel for CUDA tensors and its plain version for
    CPU tensors.  ``variant='shifted'`` (`NCC.h:117-272`) is not ported.
    """
    if cfg.variant == "shifted":
        raise NotImplementedError(
            "NCCConfig(variant='shifted') (ncc_shifted_depth) is not ported yet "
            "(ROADMAP.md Queue 1 item 7, dormant variants)"
        )
    if cfg.variant != "window":
        raise ValueError(f"unknown NCC variant {cfg.variant!r}; expected 'window' or 'shifted'")
    if return_stages:
        raise NotImplementedError(
            "return_stages=True is not ported yet (ROADMAP.md Queue 1 item 8, "
            "surfaces: return_stages + checkpoint)"
        )
    with stage_scope("cost_volume"):
        vol, interior = ncc_volume_cuda(
            left, right, cfg.disp_range, cfg.win_size, cfg.invalid_mode, cfg.eps
        )
    with stage_scope("wta"):
        disp = torch.where(interior, wta.wta(vol, "max"), 0.0)
    return StereoResult(disp)
