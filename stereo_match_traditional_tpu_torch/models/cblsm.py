"""Cross-based local stereo matching pipeline (`CBLSM/CBLSM.cpp:13-213`),
torch counterpart of ``stereo_match_traditional_tpu.models.cblsm``."""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import CBLSMConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
from stereo_match_traditional_tpu_torch.ops.kernels.ad_census_cuda import ad_volumes_cuda
from stereo_match_traditional_tpu_torch.ops.kernels.window_cost_cuda import sad_volume_cuda
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def cblsm_post(disp_l, disp_r, cfg: CBLSMConfig):
    """Dormant CBLSM post chain (`CBLSM.cpp:160-162`): LR consistency ->
    RemoveSpeckles -> truncate median.  Returns ``(disp, occlusion,
    mismatch)``."""
    lr = post.lr_check_consistency(disp_l, disp_r, cfg.lr_gate, post.INVALID)
    dmap = post.remove_speckles(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, invalid_value=post.INVALID
    )
    dmap = post.median_filter(dmap, cfg.median_size, border="truncate")
    return dmap, lr.occlusion, lr.mismatch


def cblsm_finish(vol_l, vol_r, cfg: CBLSMConfig) -> StereoResult:
    """Plain WTA per aggregated volume and :func:`cblsm_post`: the end of
    :func:`cblsm_pipeline`, where `registry.finish_from_volumes` re-enters."""
    with stage_scope("wta"):
        disp_l = wta.wta(vol_l, "min")
        disp_r = wta.wta(vol_r, "min")
    disp_final = occl = mism = None
    if cfg.run_post:
        with stage_scope("post"):
            disp_final, occl, mism = cblsm_post(disp_l, disp_r, cfg)
    return StereoResult(disp_l, disp_r, disp_final, occl, mism)


def _check_config(cfg: CBLSMConfig) -> None:
    if cfg.cost not in ("ad", "sad_mean", "sad_mean_v4", "local_mean"):
        raise ValueError(
            f"unknown cost {cfg.cost!r}; expected 'ad', 'sad_mean', 'sad_mean_v4' or "
            "'local_mean'"
        )
    if cfg.aggregation not in ("rect_mean", "rect_mean_v4", "cross_two_pass", "none"):
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; expected 'rect_mean', "
            "'rect_mean_v4', 'cross_two_pass' or 'none'"
        )


def _cost_volumes(left, right, cfg: CBLSMConfig, arms_l, arms_r):
    """Both views' cost volumes of ``cfg.cost``."""
    d = cfg.disp_range
    if cfg.cost == "ad":
        return ad_volumes_cuda(left, right, d)
    if cfg.cost in ("sad_mean", "sad_mean_v4"):
        # dormant ComputeDispLeft/Right (`CBLSM.h:409-489`), the window mean;
        # sad_mean_v4 is ComputeDispV4 (`CBLSM.h:494-532`), the minimum-channel
        # colour SAD of [H, W, 3] images
        cm = cfg.cost == "sad_mean_v4"
        return tuple(sad_volume_cuda(left, right, d, cfg.win_size, view, True, cm)
                     for view in ("left", "right"))
    # dormant on-the-fly aggregated cost (`CBLSM.h:969-1085`); the right view
    # is the left-view problem on the mirrored pair
    lf, rf = torch.flip(left, [1]), torch.flip(right, [1])
    vol_r = aggregate.local_mean_cost(
        rf, lf, aggregate.cross_arms(rf, cfg.arms), aggregate.cross_arms(lf, cfg.arms), d)
    return aggregate.local_mean_cost(left, right, arms_l, arms_r, d), torch.flip(vol_r, [2])


def cblsm_pipeline(
    left, right, cfg: CBLSMConfig = CBLSMConfig(), return_stages: bool = False
) -> StereoResult:
    """Active path (`CBLSM.cpp:64-153`): four arms per image on the raw gray
    images -> AD cost volumes L+R (`CBLSM.h:327-381`) -> ``agg_passes``
    rectangle-mean passes per volume (`costAggregationV5`,
    `CBLSM.cpp:146-150`) -> plain WTA (`CBLSM.h:383-407`).  With
    ``second_pass_left_arms`` (the committed quirk, `CBLSM.cpp:150`) every
    pass after the first aggregates both volumes with the left arms, as one
    stacked ``[2D, H, W]`` pass.  ``aggregation='cross_two_pass'`` (the
    vendored CrossAggregator, `CBLSM.cpp:138-143`, commented out there)
    aggregates each volume with the canonical arms of its gray image and
    ``cfg.cross_params`` instead.  ``run_post`` runs :func:`cblsm_post`.

    The dormant variants: ``cost='sad_mean'`` and ``'sad_mean_v4'`` (the
    window-mean SAD, the latter of ``[H, W, 3]`` images by its minimum
    channel; the CUDA SAD kernel, one launch a view, for CUDA tensors),
    ``'local_mean'`` (``aggregate.local_mean_cost``), and
    ``aggregation='rect_mean_v4'`` (the disparity-conditioned support of
    ``aggregate.cblsm_arm_volumes`` and ``rect_mean_aggregate_volume``,
    `CBLSM.cpp:108-111`, `CBLSM.h:1128-1176`); all but the SAD kernel are
    plain PyTorch on every device.

    The AD volumes are the AD part of the CUDA AD-Census kernel, both views
    in one launch, for CUDA tensors and its plain version for CPU tensors.
    ``return_stages=True`` returns ``(result, stages)`` with ``cost_left``,
    ``cost_right``, ``aggregated_left`` and ``aggregated_right``.
    """
    _check_config(cfg)
    d = cfg.disp_range
    arms_l = arms_r = None
    if cfg.cost == "local_mean" or cfg.aggregation in ("rect_mean", "rect_mean_v4"):
        with stage_scope("arms"):
            arms_l = aggregate.cross_arms(left, cfg.arms)
            arms_r = aggregate.cross_arms(right, cfg.arms)
    with stage_scope("cost_volume"):
        vol_l, vol_r = _cost_volumes(left, right, cfg, arms_l, arms_r)
    agg_l, agg_r = vol_l, vol_r

    if cfg.aggregation == "rect_mean":
        with stage_scope("aggregate"):
            agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l)
            agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r)
            for _ in range(cfg.agg_passes - 1):
                if cfg.second_pass_left_arms:
                    both = aggregate.rect_mean_aggregate(torch.cat([agg_l, agg_r]), arms_l)
                    agg_l, agg_r = both[:d], both[d:]
                else:
                    agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l)
                    agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r)
    elif cfg.aggregation == "rect_mean_v4":
        with stage_scope("aggregate"):
            support = aggregate.cblsm_arm_volumes(arms_l, arms_r, d, max_steps=cfg.arms.max_length)
            agg_l = aggregate.rect_mean_aggregate_volume(agg_l, *support)
            agg_r = aggregate.rect_mean_aggregate_volume(agg_r, *support)
    elif cfg.aggregation == "cross_two_pass":
        cp = cfg.cross_params
        with stage_scope("arms"):
            arms_l = aggregate.canonical_cross_arms(left, cp)
            arms_r = aggregate.canonical_cross_arms(right, cp)
        with stage_scope("aggregate"):
            agg_l = aggregate.cross_aggregate(agg_l, arms_l, cp.num_iters)
            agg_r = aggregate.cross_aggregate(agg_r, arms_r, cp.num_iters)

    result = cblsm_finish(agg_l, agg_r, cfg)
    if return_stages:
        return result, {"cost_left": vol_l, "cost_right": vol_r,
                        "aggregated_left": agg_l, "aggregated_right": agg_r}
    return result
