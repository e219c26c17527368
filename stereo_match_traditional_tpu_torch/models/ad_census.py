"""Flagship AD-Census pipeline (`AD-CensusV1/main.cpp:13-121`), torch
counterpart of ``stereo_match_traditional_tpu.models.ad_census``."""

from __future__ import annotations

from stereo_match_traditional_tpu_torch.config import ADCensusConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_volumes_cuda,
    scanline_optimize_cuda,
)
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def ad_census_post(disp_l, disp_r, cfg: ADCensusConfig):
    """Dormant AD-Census post chain (`main.cpp:91-94`): LeftRightConsistency
    -> RemoveSpeckles -> 8-direction FillTheHole -> MedianFilter.  Returns
    ``(disp, occlusion, mismatch)``."""
    lr = post.lr_check_consistency(disp_l, disp_r, cfg.lr_gate, post.INVALID)
    dmap = post.remove_speckles(
        lr.disp, cfg.speckle_diff, cfg.speckle_area, invalid_value=post.INVALID
    )
    dmap = post.fill_holes_8dir(
        dmap, lr.occlusion, lr.mismatch, post.INVALID, max_search=cfg.disp_range
    )
    dmap = post.median_filter(dmap, cfg.median_size, border="truncate")
    return dmap, lr.occlusion, lr.mismatch


def ad_census_pipeline(
    left,
    right,
    cfg: ADCensusConfig = ADCensusConfig(),
    left_color=None,
    right_color=None,
    return_stages: bool = False,
) -> StereoResult:
    """Active path (`main.cpp:58-84`): fused AD+Census volumes L+R -> cross
    arms per image -> vertical-first rectangle-mean aggregation
    (``cfg.agg_iters`` passes; ``aggregation='none'`` skips it) -> WTA per
    volume.  Dormant stages: ``cfg.scanline``, the 4-path scanline of the
    aggregated left volume (`main.cpp:86-89`); ``cfg.run_post``, the post
    chain of :func:`ad_census_post` (`main.cpp:91-94`).

    The cost volumes (both views in one launch) and the scanline are CUDA
    kernels for CUDA tensors and their plain versions for CPU tensors.

    ``left_color`` / ``right_color`` take the reference's position; as in
    the JAX package, only ``aggregation='cross_two_pass'`` reads them (its
    arms come from the colour images), so the ported aggregations ignore
    them.
    """
    if cfg.aggregation == "cross_two_pass":
        raise NotImplementedError(
            "ADCensusConfig(aggregation='cross_two_pass') and its canonical "
            "scanline and post are not ported yet (ROADMAP.md Queue 1 item 6, "
            "canonical family)"
        )
    if cfg.aggregation not in ("rect_mean", "none"):
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; "
            "expected 'rect_mean', 'cross_two_pass' or 'none'"
        )
    if return_stages:
        raise NotImplementedError(
            "return_stages=True is not ported yet (ROADMAP.md Queue 1 item 8, "
            "surfaces: return_stages + checkpoint)"
        )
    d = cfg.disp_range
    kw = dict(sigma_c=cfg.sigma_c, sigma_s=cfg.sigma_s,
              census_rows=cfg.census_rows, census_cols=cfg.census_cols)
    with stage_scope("cost_volume"):
        vol_l, vol_r = ad_census_volumes_cuda(left, right, d, **kw)

    agg_l, agg_r = vol_l, vol_r
    if cfg.aggregation == "rect_mean":
        with stage_scope("aggregate"):
            arms_l = aggregate.cross_arms(left, cfg.arms)
            arms_r = aggregate.cross_arms(right, cfg.arms)
            for _ in range(cfg.agg_iters):
                agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l)
                agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r)

    if cfg.scanline is not None:
        with stage_scope("scanline"):
            agg_l = scanline_optimize_cuda(agg_l, left, cfg.scanline)

    with stage_scope("wta"):
        disp_l = wta.wta(agg_l, "min")
        disp_r = wta.wta(agg_r, "min")

    disp_final = occl = mism = None
    if cfg.run_post:
        with stage_scope("post"):
            disp_final, occl, mism = ad_census_post(disp_l, disp_r, cfg)
    return StereoResult(disp_l, disp_r, disp_final, occl, mism)
