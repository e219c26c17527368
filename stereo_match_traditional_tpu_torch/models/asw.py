"""Adaptive-support-weight pipeline (`ASW/ASWeight.cpp:7-98`), torch
counterpart of ``stereo_match_traditional_tpu.models.asw``."""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import ASWConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import post, volume, wta
from stereo_match_traditional_tpu_torch.ops.kernels import asw_volume_cuda
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def _minmax_u8(x: torch.Tensor) -> torch.Tensor:
    """`cv::normalize(0,255,NORM_MINMAX)` + u8 convert (`ASWeight.cpp:69-72`),
    kept float; ``torch.round`` rounds half to even like ``jnp.round``."""
    lo = torch.min(x)
    hi = torch.max(x)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), 0.0)
    return torch.round((x - lo) * scale)


def asw_post(disp_l: torch.Tensor, disp_r: torch.Tensor, cfg: ASWConfig) -> torch.Tensor:
    """Active ASW post chain (`ASWeight.cpp:66-78`): LR check writing 0
    (`ASW.h:108-145`) -> min-max scale to u8 (`ASWeight.cpp:69`) ->
    `filterSpeckles(0, 40, 2)` -> `medianBlur(5)` -> `FillImageNew` ->
    `medianBlur(3)`."""
    lr = post.lr_check_simple(disp_l, disp_r, cfg.lr_gate, invalid_value=0.0)
    d = _minmax_u8(lr.disp)
    # OpenCV filterSpeckles removes blobs of size <= maxSpeckleSize (40)
    # using 4-connectivity; remove_speckles kills size < min_area, hence +1.
    d = post.remove_speckles(
        d, cfg.speckle_diff, cfg.speckle_area + 1, invalid_value=0.0,
        connectivity=4,
    )
    d = post.median_filter(d, cfg.median_first, border="replicate")
    d = post.fill_image_new(d)
    return post.median_filter(d, cfg.median_second, border="replicate")


def asw_finish(vol_l, vol_r, cfg: ASWConfig) -> StereoResult:
    """Dual WTA and :func:`asw_post`: the end of :func:`asw_pipeline`, where
    `registry.finish_from_volumes` re-enters."""
    with stage_scope("wta"):
        disp_l = wta.wta(vol_l, "min")
        disp_r = wta.wta(vol_r, "min")
    disp_final = None
    if cfg.run_post:
        with stage_scope("post"):
            disp_final = asw_post(disp_l, disp_r, cfg)
    return StereoResult(disp_l, disp_r, disp_final)


def asw_pipeline(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: ASWConfig = ASWConfig(),
    left_lab=None,
    right_lab=None,
    return_stages: bool = False,
) -> StereoResult:
    """Active reference path (`ASWeight.cpp:60-78`): 25x25 bilateral-weight
    truncated-AD volume (left; right by the shift identity) -> dual WTA ->
    :func:`asw_post`.

    ``cfg.use_pallas`` None or True takes the CUDA kernel
    (`ops.kernels.asw_volume_cuda`, which runs the plain version for CPU
    tensors); False takes the plain ``ops.volume.asw_volume``.

    The dormant variants run in plain PyTorch on every device:
    ``variant='lab'``, the Yoon-Kweon Lab-weight volume
    (``volume.asw_lab_volume``, `ASW/ASW.h:49-175`), weighted from the
    ``left_lab`` / ``right_lab`` images (`ASWeight.cpp:33-34`
    cvtColor(CV_BGR2Lab); see ``utils.io.rgb_to_lab_u8``); and
    ``approx='grid'``, the bilateral-grid approximation
    (``volume.asw_volume_approx_grid``).  Either takes its right view from
    ``volume.right_volume_from_left`` (the Lab cost's truncation commutes
    with the shift) and ends in :func:`asw_finish`.
    ``return_stages=True`` returns ``(result, {"cost_left", "cost_right"})``.
    """
    kw = dict(
        disp_range=cfg.disp_range,
        win_size=cfg.win_size,
        space_sigma=cfg.space_sigma,
        color_sigma=cfg.color_sigma,
        truncation=cfg.truncation,
    )
    if cfg.variant == "lab":
        if cfg.approx != "none":
            raise ValueError("approx='grid' is implemented for the active "
                             "bilateral variant, not variant='lab'")
        if left_lab is None or right_lab is None:
            raise ValueError("variant='lab' needs left_lab/right_lab images")
    elif cfg.approx not in ("none", "grid"):
        raise ValueError(f"unknown ASW approx {cfg.approx!r}; expected 'none' or 'grid'")
    with stage_scope("cost_volume"):
        if cfg.variant == "lab":
            vol_l = volume.asw_lab_volume(
                left, right, left_lab, right_lab, faithful_lut=cfg.lab_faithful_lut, **kw
            )
        elif cfg.approx == "grid":
            vol_l = volume.asw_volume_approx_grid(left, right, bins=cfg.approx_bins, **kw)
        elif cfg.use_pallas is False:
            vol_l = volume.asw_volume(left, right, **kw)
        else:
            vol_l = asw_volume_cuda(left, right, view="left", **kw)
        # Right view (`ASW/ASW.h:382-431`) by costR(q,d) = costL(q+d,d).
        vol_r = volume.right_volume_from_left(vol_l)
    result = asw_finish(vol_l, vol_r, cfg)
    if return_stages:
        return result, {"cost_left": vol_l, "cost_right": vol_r}
    return result
