"""Row-band cores of the executors (torch counterpart of the parts of
``stereo_match_traditional_tpu.parallel.tiled`` that the streamed executor
runs).

A band is a run of image rows extended by a halo sized to the pipeline's
exact receptive field (:func:`receptive_field_rows`).  Each core computes a
pipeline's cost, aggregation and WTA on one halo-extended band, with the
band's global row position handed to every op that tests "inside the
image" (``row_offset`` / ``global_rows``), so that the band's own rows equal
the whole image's; it returns the band's ``[T, W]`` maps.  The post chains
(:data:`_POST`) run on the gathered maps.

The tiled executor itself, which spreads the bands over devices
(``tiled_pipeline``, ``run_tiled``, the ``(tile, disp)`` mesh runners and
the sharded scanline), comes in a later slice (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.models.ad_census import ad_census_post
from stereo_match_traditional_tpu_torch.models.asw import asw_post
from stereo_match_traditional_tpu_torch.models.cblsm import cblsm_post
from stereo_match_traditional_tpu_torch.models.sad import sad_post
from stereo_match_traditional_tpu_torch.ops import aggregate, volume, wta
from stereo_match_traditional_tpu_torch.ops.kernels.ad_census_cuda import (
    ad_census_volume_cuda,
    ad_census_volumes_cuda,
    ad_volumes_cuda,
)
from stereo_match_traditional_tpu_torch.ops.kernels.asw_cuda import asw_volume_cuda
from stereo_match_traditional_tpu_torch.ops.kernels.window_cost_cuda import (
    ncc_volume_cuda,
    sad_volume_cuda,
)
from stereo_match_traditional_tpu_torch.parallel.halo import crop_row_halo


def receptive_field_rows(name: str, cfg) -> int:
    """The rows of halo a band needs on each side so that its own rows are
    computed exactly as in the whole image.  The scanline needs none: the
    streamed executor carries its vertical paths across bands."""
    if name == "sad":
        return cfg.winsize + 1                      # window radius, Sad.h:109
    if name == "ncc":
        if cfg.variant == "shifted":
            return cfg.alt_kernel                   # 11x11 window, NCC.h:122
        return cfg.win_size                         # window radius, NCC.h:15
    if name == "asw":
        return cfg.win_size + 1                     # support radius, ASW.h:333
    if name == "ad_census":
        census_rf = cfg.census_rows // 2            # 4 rows, AD-Census.h:167
        if cfg.aggregation == "rect_mean":
            return cfg.arms.max_length * cfg.agg_iters + census_rf
        if cfg.aggregation == "cross_two_pass":
            return cfg.cross_params.cross_l1 * cfg.cross_params.num_iters + census_rf
        return census_rf
    if name == "cblsm":
        cost_rf = {
            "ad": 0,                                # no row reach
            "sad_mean": cfg.win_size + 1,           # window radius
            "sad_mean_v4": cfg.win_size + 1,
            "local_mean": cfg.arms.max_length,      # arm-region mean
        }[cfg.cost]
        agg_rf = {
            "rect_mean": cfg.arms.max_length * cfg.agg_passes,
            "rect_mean_v4": cfg.arms.max_length,    # single V4 application
            "cross_two_pass": cfg.cross_params.cross_l1 * cfg.cross_params.num_iters,
            "none": 0,
        }[cfg.aggregation]
        return cost_rf + agg_rf
    raise KeyError(name)


# ---------------------------------------------------------------------------
# per-pipeline band cores: (left_ext, right_ext, cfg, ro_ext, rows, halo,
# axis_name, aux) -> dict of [T, W] maps
# ---------------------------------------------------------------------------


def _single_device(axis_name) -> None:
    if axis_name is not None:
        raise NotImplementedError(
            "band cores over a device axis belong to the tiled executor, which is "
            "not ported yet (ROADMAP.md Queue 1 item 9)"
        )


def _sad_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
    _single_device(axis_name)
    vol_l = sad_volume_cuda(le, re, cfg.max_disparity, cfg.winsize, "left")
    out = {
        "disp_left": crop_row_halo(
            wta.optimal_disparity(vol_l, cfg.uniqueness_eps, cfg.subpixel), halo, 0
        )
    }
    if cfg.compute_right or cfg.run_post:
        vol_r = sad_volume_cuda(le, re, cfg.max_disparity, cfg.winsize, "right")
        out["disp_right"] = crop_row_halo(wta.wta(vol_r, "min"), halo, 0)
    return out


def _ncc_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
    _single_device(axis_name)
    if cfg.variant == "shifted":
        depth = volume.ncc_shifted_depth(
            le, re, cfg.alt_max_offset, cfg.alt_kernel, "left",
            cfg.alt_add_constant, cfg.alt_depth_scale,
            row_offset=ro_ext, global_rows=rows,
        )
        return {"disp_left": crop_row_halo(depth, halo, 0)}
    vol, interior = ncc_volume_cuda(
        le, re, cfg.disp_range, cfg.win_size, cfg.invalid_mode, cfg.eps,
        row_offset=ro_ext, global_rows=rows,
    )
    disp = torch.where(interior, wta.wta(vol, "max"), 0.0)
    return {"disp_left": crop_row_halo(disp, halo, 0)}


def _asw_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
    _single_device(axis_name)
    kw = dict(
        disp_range=cfg.disp_range,
        win_size=cfg.win_size,
        space_sigma=cfg.space_sigma,
        color_sigma=cfg.color_sigma,
        truncation=cfg.truncation,
    )
    if cfg.variant == "lab":
        # the Lab pair arrives as halo-extended aux bands
        if len(aux) != 2:
            raise ValueError(
                "asw variant='lab' under a row executor needs the Lab pair as aux "
                "inputs: streamed_pipeline(...)(left, right, left_lab, right_lab)"
            )
        vol_l = volume.asw_lab_volume(
            le, re, aux[0], aux[1], faithful_lut=cfg.lab_faithful_lut, **kw
        )
    elif cfg.approx == "grid":
        # the truncated-Gaussian row blur knows the image's borders, so the
        # radius-row halo is exact
        vol_l = volume.asw_volume_approx_grid(
            le, re, bins=cfg.approx_bins, row_offset=ro_ext, global_rows=rows, **kw
        )
    elif cfg.use_pallas is False:
        vol_l = volume.asw_volume(le, re, **kw)
    else:
        # the CUDA kernel where the JAX package calls its Pallas kernel
        vol_l = asw_volume_cuda(le, re, view="left", **kw)
    # the exact shift identity costR(q, d) = costL(q + d, d) is row-local
    vol_r = volume.right_volume_from_left(vol_l)
    return {
        "disp_left": crop_row_halo(wta.wta(vol_l, "min"), halo, 0),
        "disp_right": crop_row_halo(wta.wta(vol_r, "min"), halo, 0),
    }


def _ad_census_band_volumes(le, re, cfg, ro_ext, rows, left_only=False):
    """Aggregated AD-Census volumes ``(agg_l, agg_r)`` of one halo-extended
    band, each ``[D, T + 2*halo, W]`` (uncropped): both views' costs from
    one launch of the cost kernel, arms and aggregation per view.
    ``left_only`` builds the left view alone (``agg_r`` is None)."""
    d = cfg.disp_range
    kw = dict(sigma_c=cfg.sigma_c, sigma_s=cfg.sigma_s, census_rows=cfg.census_rows,
              census_cols=cfg.census_cols, row_offset=ro_ext, global_rows=rows)
    if left_only:
        vols = (ad_census_volume_cuda(le, re, d, view="left", **kw), None)
    else:
        vols = ad_census_volumes_cuda(le, re, d, **kw)
    out = []
    for vol, img in zip(vols, (le, re)):
        if vol is None:
            out.append(None)
        elif cfg.aggregation == "rect_mean":
            arms = aggregate.cross_arms(img, cfg.arms, ro_ext, rows)
            for _ in range(cfg.agg_iters):
                vol = aggregate.rect_mean_aggregate(vol, arms, max_span=cfg.arms.max_length)
            out.append(vol)
        elif cfg.aggregation == "cross_two_pass":
            cp = cfg.cross_params
            arms = aggregate.canonical_cross_arms(img, cp, ro_ext, rows)
            out.append(aggregate.cross_aggregate(vol, arms, cp.num_iters, span_cap=cp.cross_l1))
        else:
            out.append(vol)
    return tuple(out)


def _ad_census_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
    if cfg.scanline is not None:
        raise NotImplementedError(
            "the scanline over row tiles (the sharded scanline) belongs to the tiled "
            "executor, which is not ported yet (ROADMAP.md Queue 1 item 9); the "
            "streamed executor carries the scanline across bands itself"
        )
    _single_device(axis_name)
    agg_l, agg_r = _ad_census_band_volumes(le, re, cfg, ro_ext, rows)
    return {
        "disp_left": wta.wta(crop_row_halo(agg_l, halo, 1), "min"),
        "disp_right": wta.wta(crop_row_halo(agg_r, halo, 1), "min"),
    }


def _cblsm_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
    """Every CBLSM cost and aggregation of ``models.cblsm`` on a
    halo-extended band; the arm rules and window sums read global rows."""
    _single_device(axis_name)
    d = cfg.disp_range
    arms_l = aggregate.cross_arms(le, cfg.arms, ro_ext, rows)
    arms_r = aggregate.cross_arms(re, cfg.arms, ro_ext, rows)

    if cfg.cost == "ad":
        vol_l, vol_r = ad_volumes_cuda(le, re, d)
    elif cfg.cost in ("sad_mean", "sad_mean_v4"):
        cm = cfg.cost == "sad_mean_v4"
        vol_l, vol_r = (sad_volume_cuda(le, re, d, cfg.win_size, view, True, cm)
                        for view in ("left", "right"))
    elif cfg.cost == "local_mean":
        vol_l = aggregate.local_mean_cost(le, re, arms_l, arms_r, d)
        # the mirrored right view flips the columns only: the same rows
        lf, rf = torch.flip(le, [1]), torch.flip(re, [1])
        vol_r = torch.flip(aggregate.local_mean_cost(
            rf, lf, aggregate.cross_arms(rf, cfg.arms, ro_ext, rows),
            aggregate.cross_arms(lf, cfg.arms, ro_ext, rows), d,
        ), [2])
    else:
        raise ValueError(f"unknown cost {cfg.cost!r}")

    if cfg.aggregation == "rect_mean":
        span = cfg.arms.max_length
        agg_l = aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=span)
        agg_r = aggregate.rect_mean_aggregate(vol_r, arms_r, max_span=span)
        for _ in range(cfg.agg_passes - 1):
            if cfg.second_pass_left_arms:
                both = aggregate.rect_mean_aggregate(torch.cat([agg_l, agg_r]), arms_l,
                                                     max_span=span)
                agg_l, agg_r = both[:d], both[d:]
            else:
                agg_l = aggregate.rect_mean_aggregate(agg_l, arms_l, max_span=span)
                agg_r = aggregate.rect_mean_aggregate(agg_r, arms_r, max_span=span)
    elif cfg.aggregation == "rect_mean_v4":
        support = aggregate.cblsm_arm_volumes(arms_l, arms_r, d, max_steps=cfg.arms.max_length)
        agg_l = aggregate.rect_mean_aggregate_volume(vol_l, *support)
        agg_r = aggregate.rect_mean_aggregate_volume(vol_r, *support)
    elif cfg.aggregation == "cross_two_pass":
        cp = cfg.cross_params
        c_arms_l = aggregate.canonical_cross_arms(le, cp, ro_ext, rows)
        c_arms_r = aggregate.canonical_cross_arms(re, cp, ro_ext, rows)
        agg_l = aggregate.cross_aggregate(vol_l, c_arms_l, cp.num_iters, span_cap=cp.cross_l1)
        agg_r = aggregate.cross_aggregate(vol_r, c_arms_r, cp.num_iters, span_cap=cp.cross_l1)
    elif cfg.aggregation == "none":
        agg_l, agg_r = vol_l, vol_r
    else:
        raise ValueError(f"unknown aggregation {cfg.aggregation!r}")
    return {
        "disp_left": crop_row_halo(wta.wta(agg_l, "min"), halo, 0),
        "disp_right": crop_row_halo(wta.wta(agg_r, "min"), halo, 0),
    }


_TILE_CORES = {
    "sad": _sad_tile,
    "ncc": _ncc_tile,
    "asw": _asw_tile,
    "ad_census": _ad_census_tile,
    "cblsm": _cblsm_tile,
}

_POST = {
    "sad": lambda dl, dr, cfg: sad_post(dl, dr, cfg),
    "asw": lambda dl, dr, cfg: (asw_post(dl, dr, cfg), None, None),
    "ad_census": lambda dl, dr, cfg: ad_census_post(dl, dr, cfg),
    "cblsm": lambda dl, dr, cfg: cblsm_post(dl, dr, cfg),
}


def _check_tiled_support(name: str, cfg) -> None:
    """Reject unknown config variants with the direct pipelines' errors."""
    if name == "ncc" and cfg.variant not in ("window", "shifted"):
        raise ValueError(f"unknown ncc variant {cfg.variant!r}")
    elif name == "asw" and cfg.variant not in ("bilateral", "lab"):
        raise ValueError(f"unknown asw variant {cfg.variant!r}")
    elif name == "asw" and getattr(cfg, "approx", "none") not in ("none", "grid"):
        raise ValueError(
            f"unknown ASW approx {cfg.approx!r}; expected 'none' or 'grid'"
        )
    elif (
        name == "asw"
        and cfg.variant == "lab"
        and getattr(cfg, "approx", "none") != "none"
    ):
        raise ValueError("approx='grid' is implemented for the active "
                         "bilateral variant, not variant='lab'")
    elif name == "ad_census" and cfg.aggregation not in (
        "rect_mean", "cross_two_pass", "none"
    ):
        raise ValueError(
            f"unknown aggregation {cfg.aggregation!r}; "
            "expected 'rect_mean', 'cross_two_pass' or 'none'"
        )
