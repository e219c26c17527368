"""NCC window-matching pipeline (`NCC/NCC_main.cpp:8-60`), torch
counterpart of ``stereo_match_traditional_tpu.models.ncc``."""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import NCCConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import volume, wta
from stereo_match_traditional_tpu_torch.ops.kernels import ncc_volume_cuda
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def ncc_finish(vol_l, cfg: NCCConfig, interior=None) -> StereoResult:
    """The argmax WTA of the similarity volume, 0 outside ``interior`` (the
    reference's loop range, built from the volume's shape when not given):
    the end of :func:`ncc_pipeline`, where `registry.finish_from_volumes`
    re-enters."""
    if interior is None:
        h, w = vol_l.shape[1:]
        interior = volume.ncc_interior_mask(h, w, cfg.win_size, device=vol_l.device)
    with stage_scope("wta"):
        return StereoResult(torch.where(interior, wta.wta(vol_l, "max"), 0.0))


def ncc_pipeline(
    left, right, cfg: NCCConfig = NCCConfig(), return_stages: bool = False
) -> StereoResult:
    """21x21 NCC similarity volume -> argmax WTA (`NCC/NCC.h:69-95`); pixels
    outside the reference's loop range (`NCC.h:72-75`) keep 0 disparity
    (`Mat::zeros`, `NCC_main.cpp:20`).

    The volume is the CUDA kernel for CUDA tensors and its plain version for
    CPU tensors.  ``return_stages=True`` returns ``(result, {"cost_left":
    volume})``.

    ``variant='shifted'`` runs the dormant whole-image shifted NCC
    (`NCC.h:117-272`, disabled at `NCC_main.cpp:24`), plain PyTorch on every
    device, whose output is the display-scaled depth ``best_offset *
    alt_depth_scale``; with ``return_stages`` it gives ``(result, {})``.
    """
    if cfg.variant == "shifted":
        with stage_scope("cost_volume"):
            depth = volume.ncc_shifted_depth(
                left, right, cfg.alt_max_offset, cfg.alt_kernel, "left",
                cfg.alt_add_constant, cfg.alt_depth_scale,
            )
        result = StereoResult(depth)
        return (result, {}) if return_stages else result
    if cfg.variant != "window":
        raise ValueError(f"unknown NCC variant {cfg.variant!r}; expected 'window' or 'shifted'")
    with stage_scope("cost_volume"):
        vol, interior = ncc_volume_cuda(
            left, right, cfg.disp_range, cfg.win_size, cfg.invalid_mode, cfg.eps
        )
    result = ncc_finish(vol, cfg, interior)
    if return_stages:
        return result, {"cost_left": vol}
    return result
