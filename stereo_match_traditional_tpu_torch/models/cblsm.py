"""Cross-based local stereo matching pipeline (`CBLSM/CBLSM.cpp:13-213`),
torch counterpart of ``stereo_match_traditional_tpu.models.cblsm``."""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import CBLSMConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
from stereo_match_traditional_tpu_torch.ops.kernels.ad_census_cuda import ad_volumes_cuda
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


def _check_config(cfg: CBLSMConfig, return_stages: bool) -> None:
    if cfg.cost in ("sad_mean", "sad_mean_v4", "local_mean"):
        raise NotImplementedError(
            f"CBLSMConfig(cost={cfg.cost!r}) is not ported yet "
            "(ROADMAP.md Queue 1 item 7, dormant variants)"
        )
    if cfg.cost != "ad":
        raise ValueError(
            f"unknown cost {cfg.cost!r}; expected 'ad', 'sad_mean', 'sad_mean_v4' or "
            "'local_mean'"
        )
    if cfg.aggregation == "rect_mean_v4":
        raise NotImplementedError(
            "CBLSMConfig(aggregation='rect_mean_v4') is not ported yet "
            "(ROADMAP.md Queue 1 item 7, dormant variants)"
        )
    if cfg.aggregation == "cross_two_pass":
        raise NotImplementedError(
            "CBLSMConfig(aggregation='cross_two_pass') is not ported yet "
            "(ROADMAP.md Queue 1 item 6, canonical family)"
        )
    if cfg.aggregation not in ("rect_mean", "none"):
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; expected 'rect_mean', "
            "'rect_mean_v4', 'cross_two_pass' or 'none'"
        )
    if return_stages:
        raise NotImplementedError(
            "return_stages=True is not ported yet (ROADMAP.md Queue 1 item 8, "
            "surfaces: return_stages + checkpoint)"
        )


def cblsm_pipeline(
    left, right, cfg: CBLSMConfig = CBLSMConfig(), return_stages: bool = False
) -> StereoResult:
    """Active path (`CBLSM.cpp:64-153`): four arms per image on the raw gray
    images -> AD cost volumes L+R (`CBLSM.h:327-381`) -> ``agg_passes``
    rectangle-mean passes per volume (`costAggregationV5`,
    `CBLSM.cpp:146-150`) -> plain WTA (`CBLSM.h:383-407`).  With
    ``second_pass_left_arms`` (the committed quirk, `CBLSM.cpp:150`) every
    pass after the first aggregates both volumes with the left arms, as one
    stacked ``[2D, H, W]`` pass.  ``run_post`` runs :func:`cblsm_post`.

    The AD volumes are the AD part of the CUDA AD-Census kernel, both views
    in one launch, for CUDA tensors and its plain version for CPU tensors.
    """
    _check_config(cfg, return_stages)
    d = cfg.disp_range
    with stage_scope("cost_volume"):
        agg_l, agg_r = ad_volumes_cuda(left, right, d)

    if cfg.aggregation == "rect_mean":
        with stage_scope("arms"):
            arms_l = aggregate.cross_arms(left, cfg.arms)
            arms_r = aggregate.cross_arms(right, cfg.arms)
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

    with stage_scope("wta"):
        disp_l = wta.wta(agg_l, "min")
        disp_r = wta.wta(agg_r, "min")

    disp_final = occl = mism = None
    if cfg.run_post:
        with stage_scope("post"):
            disp_final, occl, mism = cblsm_post(disp_l, disp_r, cfg)
    return StereoResult(disp_l, disp_r, disp_final, occl, mism)
