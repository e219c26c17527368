"""SAD block-matching pipeline (`SAD/SADmain.cpp:24-99`), torch counterpart
of ``stereo_match_traditional_tpu.models.sad``."""

from __future__ import annotations

from stereo_match_traditional_tpu_torch.config import SADConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import post, volume, wta
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def sad_post(disp_l, disp_r, cfg: SADConfig):
    """Dormant SAD post chain (`SADmain.cpp:68-79`): LR cross-check with
    occlusion/mismatch classes (`Sad.h:184-222`) -> speckle removal that
    never seeds at disparity 0 (`Sad.h:251-315`) -> 8-direction hole fill
    (`Sad.h:317-400`) -> truncate-border median 3 (`Sad.h:224-249`).
    Returns ``(disp, occlusion, mismatch)``."""
    lr = post.lr_check_simple(disp_l, disp_r, cfg.lr_gate, post.INVALID)
    d = post.remove_speckles(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, invalid_value=post.INVALID,
        background=0.0,
    )
    d = post.fill_holes_8dir(
        d, lr.occlusion, lr.mismatch, post.INVALID, max_search=cfg.fill_max_search
    )
    return post.median_filter(d, 3, border="truncate"), lr.occlusion, lr.mismatch


def sad_finish(vol_l, vol_r, cfg: SADConfig) -> StereoResult:
    """The uniqueness WTA of ``vol_l``, the plain-argmin map of ``vol_r``
    where it was computed (else None) and :func:`sad_post`: the end of
    :func:`sad_pipeline`, where `registry.finish_from_volumes` re-enters."""
    with stage_scope("wta"):
        disp_l = wta.optimal_disparity(vol_l, cfg.uniqueness_eps, cfg.subpixel)
        disp_r = None if vol_r is None else wta.wta(vol_r, "min")
    disp_final = occl = mism = None
    if cfg.run_post:
        with stage_scope("post"):
            disp_final, occl, mism = sad_post(disp_l, disp_r, cfg)
    return StereoResult(disp_l, disp_r, disp_final, occl, mism)


def sad_pipeline(
    left, right, cfg: SADConfig = SADConfig(), return_stages: bool = False
) -> StereoResult:
    """Active path: 9x9 SAD volume -> uniqueness WTA, left map only
    (`SADmain.cpp:66`).  ``compute_right`` / ``run_post`` enable the dormant
    stages (`SADmain.cpp:67-79`): the right volume with a plain-argmin map
    (`Sad.h:141-182,22-38`) and :func:`sad_post`.

    The cost volumes are the CUDA kernel for CUDA tensors and its plain
    version for CPU tensors.  ``return_stages=True`` returns ``(result,
    stages)`` with ``cost_left``, and ``cost_right`` where it was computed.
    """
    d, win = cfg.max_disparity, cfg.winsize
    with stage_scope("cost_volume"):
        vol_l = volume.sad_volume(left, right, d, win, "left")
    vol_r = None
    if cfg.compute_right or cfg.run_post:
        with stage_scope("cost_volume_right"):
            vol_r = volume.sad_volume(left, right, d, win, "right")
    result = sad_finish(vol_l, vol_r, cfg)
    if return_stages:
        stages = {"cost_left": vol_l}
        if vol_r is not None:
            stages["cost_right"] = vol_r
        return result, stages
    return result
