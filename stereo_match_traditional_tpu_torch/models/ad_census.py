"""Flagship AD-Census pipeline (`AD-CensusV1/main.cpp:13-121`), torch
counterpart of ``stereo_match_traditional_tpu.models.ad_census``."""

from __future__ import annotations

from stereo_match_traditional_tpu_torch.config import ADCensusConfig
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_volumes_cuda,
    scanline_optimize_canonical_cuda,
    scanline_optimize_cuda,
)
from stereo_match_traditional_tpu_torch.utils.profiling import count, stage_scope


def ad_census_post(disp_l, disp_r, cfg: ADCensusConfig):
    """Dormant AD-Census post chain (`main.cpp:91-94`): LeftRightConsistency
    -> RemoveSpeckles -> 8-direction FillTheHole -> MedianFilter, in the
    ranges ``stereo/lr_check``, ``speckle``, ``fill`` and ``median``.
    Returns ``(disp, occlusion, mismatch)``."""
    with stage_scope("lr_check"):
        lr = post.lr_check_consistency(disp_l, disp_r, cfg.lr_gate, post.INVALID)
    with stage_scope("speckle"):
        dmap = post.remove_speckles(
            lr.disp, cfg.speckle_diff, cfg.speckle_area, invalid_value=post.INVALID
        )
    with stage_scope("fill"):
        dmap = post.fill_holes_8dir(
            dmap, lr.occlusion, lr.mismatch, post.INVALID, max_search=cfg.disp_range
        )
    with stage_scope("median"):
        dmap = post.median_filter(dmap, cfg.median_size, border="truncate")
    return dmap, lr.occlusion, lr.mismatch


def ad_census_finish(vol_l, vol_r, cfg: ADCensusConfig, arms_left=None) -> StereoResult:
    """WTA per aggregated volume and the post chain, :func:`ad_census_post`
    or, for ``cross_two_pass``, :func:`ad_census_post_canonical` voting over
    ``arms_left`` (the left image's arms): the end of
    :func:`ad_census_pipeline`, where `registry.finish_from_volumes`
    re-enters."""
    with stage_scope("wta"):
        disp_l = wta.wta(vol_l, "min")
        disp_r = wta.wta(vol_r, "min")
    disp_final = occl = mism = None
    if cfg.run_post:
        with stage_scope("post"):
            if cfg.aggregation == "cross_two_pass":
                disp_final, occl, mism = ad_census_post_canonical(
                    disp_l, disp_r, vol_l, arms_left, cfg,
                    irv_d_chunk=irv_auto_d_chunk(*disp_l.shape, cfg.disp_range))
            else:
                disp_final, occl, mism = ad_census_post(disp_l, disp_r, cfg)
    return StereoResult(disp_l, disp_r, disp_final, occl, mism)


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

    ``aggregation='cross_two_pass'`` is the canonical AD-Census family (the
    vendored ``ADCensusOption``, `CBLSM/adcensus_types.h:45-75`, with
    ``cfg.cross_params``): canonical arms, from ``left_color`` /
    ``right_color`` when given (the only aggregation that reads them) ->
    the two-pass cross aggregation -> with ``cfg.scanline``, the
    tso-scheduled canonical scanline of both volumes (``so_p1``, ``so_p2``,
    ``so_tso``) -> WTA -> with ``cfg.run_post``,
    :func:`ad_census_post_canonical`.

    The cost volumes (both views in one launch) and both scanlines are CUDA
    kernels for CUDA tensors and their plain versions for CPU tensors.

    The rect-mean family's ``stereo/aggregate`` range holds ``stereo/arms``
    and ``stereo/rect_mean``, and each call counts its volume's D·H·W in
    ``ad_census.volume_elements`` (``utils.profiling``).

    ``return_stages=True`` returns ``(result, stages)``: ``cost_left``,
    ``cost_right``, ``aggregated_left`` and ``aggregated_right`` (the
    scanline's output where it runs: a ``[D, H, W]`` view of rows padded to
    4 columns on the card), and for ``cross_two_pass`` the left arm maps
    ``arms_left_{left,right,up,down}``, the JAX package's names.
    """
    if cfg.aggregation not in ("rect_mean", "cross_two_pass", "none"):
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; "
            "expected 'rect_mean', 'cross_two_pass' or 'none'"
        )
    d = cfg.disp_range
    kw = dict(sigma_c=cfg.sigma_c, sigma_s=cfg.sigma_s,
              census_rows=cfg.census_rows, census_cols=cfg.census_cols)
    with stage_scope("cost_volume"):
        vol_l, vol_r = ad_census_volumes_cuda(left, right, d, **kw)

    canonical = cfg.aggregation == "cross_two_pass"
    cp = cfg.cross_params
    agg_l, agg_r = vol_l, vol_r
    if cfg.aggregation == "rect_mean":
        count("ad_census.volume_elements", vol_l.numel())
        with stage_scope("aggregate"):
            with stage_scope("arms"):
                arms_l = aggregate.cross_arms(left, cfg.arms)
                arms_r = aggregate.cross_arms(right, cfg.arms)
            with stage_scope("rect_mean"):
                for _ in range(cfg.agg_iters):
                    agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l,
                                                          max_span=cfg.arms.max_length)
                    agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r,
                                                          max_span=cfg.arms.max_length)
    elif canonical:
        with stage_scope("arms"):
            arms_l = aggregate.canonical_cross_arms(
                left if left_color is None else left_color, cp)
            arms_r = aggregate.canonical_cross_arms(
                right if right_color is None else right_color, cp)
        with stage_scope("aggregate"):
            agg_l = aggregate.cross_aggregate(vol_l, arms_l, cp.num_iters, span_cap=cp.cross_l1)
            agg_r = aggregate.cross_aggregate(vol_r, arms_r, cp.num_iters, span_cap=cp.cross_l1)

    if cfg.scanline is not None:
        with stage_scope("scanline"):
            if canonical:
                agg_l = scanline_optimize_canonical_cuda(
                    agg_l, left, right, cp.so_p1, cp.so_p2, cp.so_tso, "left")
                agg_r = scanline_optimize_canonical_cuda(
                    agg_r, left, right, cp.so_p1, cp.so_p2, cp.so_tso, "right")
            else:
                agg_l = scanline_optimize_cuda(agg_l, left, cfg.scanline)

    result = ad_census_finish(agg_l, agg_r, cfg, arms_l if canonical else None)
    if return_stages:
        stages = {"cost_left": vol_l, "cost_right": vol_r,
                  "aggregated_left": agg_l, "aggregated_right": agg_r}
        if canonical:
            # the canonical post re-enters from saved stages only with the
            # left arm maps it votes over (`registry.finish_from_volumes`)
            for k in ("left", "right", "up", "down"):
                stages[f"arms_left_{k}"] = getattr(arms_l, k)
        return result, stages
    return result


def irv_auto_d_chunk(h: int, w: int, disp_range: int, budget_bytes: float = 256e6):
    """``d_chunk`` for :func:`post.iterative_region_voting` at an [h, w]
    map, the JAX package's rule as it is: ``None`` (the monolithic
    ``[D, H, W]`` histogram) up to 512 MB of one-hots, else the power of two
    at or below ``budget_bytes`` worth of slices, at least 8 and at most
    ``disp_range // 2``.  Chunking is exact, so any rule gives the same
    bits; keeping the reference's rule keeps the port's chunks equal to the
    reference's at every shape."""
    if disp_range * h * w * 4 <= 512e6:
        return None
    raw = max(8, min(int(budget_bytes / (h * w * 4)), disp_range // 2))
    return 1 << (raw.bit_length() - 1)


def ad_census_post_canonical(disp_l, disp_r, agg_l, arms_l, cfg: ADCensusConfig,
                             irv_d_chunk=None):
    """Canonical post chain of ``aggregation='cross_two_pass'``: LR check at
    ``lrcheck_thres`` -> iterative region voting -> discontinuity adjustment
    on ``agg_l`` -> truncate median, each stage but the median gated by its
    ``do_*`` flag (`adcensus_types.h:72-75`).  Returns ``(disp, occlusion,
    mismatch)``; the two masks are None without the LR check.
    ``irv_d_chunk`` bounds the voting histogram's memory (exact)."""
    cp = cfg.cross_params
    d = disp_l
    occl = mism = None
    if cp.do_lr_check:
        with stage_scope("lr_check"):
            lr = post.lr_check_consistency(disp_l, disp_r, cp.lrcheck_thres, post.INVALID)
        d, occl, mism = lr.disp, lr.occlusion, lr.mismatch
    if cp.do_filling:
        with stage_scope("region_voting"):
            d = post.iterative_region_voting(
                d, arms_l, cfg.disp_range, cp.irv_ts, cp.irv_th,
                invalid_value=post.INVALID, d_chunk=irv_d_chunk)
    if cp.do_discontinuity_adjustment:
        with stage_scope("discontinuity_adjustment"):
            d = post.discontinuity_adjustment(d, agg_l, post.INVALID)
    with stage_scope("median"):
        d = post.median_filter(d, cfg.median_size, border="truncate")
    return d, occl, mism
