"""Tile-data-parallel execution over devices (torch counterpart of
``stereo_match_traditional_tpu.parallel.tiled``), and the row-band cores it
shares with the streamed executor.

A band is a run of image rows extended by a halo sized to the pipeline's
exact receptive field (:func:`receptive_field_rows`).  Each core computes a
pipeline's cost, aggregation and WTA on one halo-extended band, with the
band's global row position handed to every op that tests "inside the
image" (``row_offset`` / ``global_rows``), so that the band's own rows equal
the whole image's; it returns the band's ``[T, W]`` maps.

:func:`tiled_pipeline` spreads the bands over the ranks of a mesh axis, one
process a device (SPMD over ``torch.distributed``): every rank takes the
whole pair, pads its rows (edge replication) to a multiple of the ranks,
cuts its own tile, extends it by the halo of its neighbours
(``parallel.halo.add_row_halo``), runs the core (the scanline sharded by
``parallel.scan_carry``) and gathers the maps, so that every rank returns
the whole ``StereoResult``.  The post chains run on the gathered maps
(:data:`_POST`), or row-sharded (``shard_post=True``, ``parallel.post_shard``).
Stage ranges (``utils.profiling.stage_scope``): ``stereo/halo``,
``stereo/band_volumes`` and ``stereo/wta`` (ad_census), the sharded
scanline's, ``stereo/gather`` and ``stereo/post``.

The ``(tile, disp)`` runners (:func:`ad_census_tile_disp`,
:func:`ncc_tile_disp`) also shard the disparities: each rank builds its
slice of the volume (the cost kernels' ``d_offset``) and the WTA combines
over the ``disp`` axis (``parallel.wta_shard``).

A tiled run equals the direct run up to the ties that a tile's own prefix
sums break differently, and the sharded scanline's sums keep the direct
kernel's order.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.models.ad_census import (
    ad_census_post,
    ad_census_post_canonical,
    irv_auto_d_chunk,
)
from stereo_match_traditional_tpu_torch.models.asw import asw_post
from stereo_match_traditional_tpu_torch.models.cblsm import cblsm_post
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.models.sad import sad_post
from stereo_match_traditional_tpu_torch.ops import aggregate, post, volume, wta
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
from stereo_match_traditional_tpu_torch.parallel import comm
from stereo_match_traditional_tpu_torch.parallel.halo import add_row_halo, crop_row_halo
from stereo_match_traditional_tpu_torch.parallel.mesh import MeshAxis, axis_size
from stereo_match_traditional_tpu_torch.parallel.scan_carry import (
    scanline_canonical_sharded,
    scanline_optimize_sharded,
)
from stereo_match_traditional_tpu_torch.parallel.wta_shard import wta_sharded
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def receptive_field_rows(name: str, cfg) -> int:
    """The rows of halo a band needs on each side so that its own rows are
    computed exactly as in the whole image.  The scanline needs none: the
    streamed executor carries its vertical paths across bands, and the tiled
    one reshards to whole columns (``parallel.scan_carry``)."""
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
# axis_name, aux) -> dict of [T, W] maps; axis_name is the tile axis (a
# MeshAxis) on the tiled executor, None on the streamed one
# ---------------------------------------------------------------------------


def _sad_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
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
                "inputs: tiled_pipeline(...)(left, right, left_lab, right_lab), the "
                "same for streamed_pipeline"
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
    with stage_scope("band_volumes"):
        agg_l, agg_r = _ad_census_band_volumes(le, re, cfg, ro_ext, rows)
    agg_l = crop_row_halo(agg_l, halo, 1)
    agg_r = crop_row_halo(agg_r, halo, 1)
    canonical = cfg.aggregation == "cross_two_pass"
    if cfg.scanline is not None:
        if axis_name is None:
            raise ValueError("the scanline of a band core runs over a tile axis (the tiled "
                             "executor); the streamed executor runs its own band sweeps")
        left_tile = crop_row_halo(le, halo, 0)
        if canonical:
            # the tso-scheduled scanline on both volumes, as the direct pipeline
            right_tile = crop_row_halo(re, halo, 0)
            cp = cfg.cross_params
            agg_l = scanline_canonical_sharded(agg_l, left_tile, right_tile, cp.so_p1,
                                               cp.so_p2, cp.so_tso, "left", axis_name, rows)
            agg_r = scanline_canonical_sharded(agg_r, right_tile, left_tile, cp.so_p1,
                                               cp.so_p2, cp.so_tso, "right", axis_name, rows)
        else:
            agg_l = scanline_optimize_sharded(agg_l, left_tile, cfg.scanline, axis_name, rows)
    with stage_scope("wta"):
        out = {"disp_left": wta.wta(agg_l, "min"), "disp_right": wta.wta(agg_r, "min")}
    if canonical and cfg.run_post and cfg.cross_params.do_discontinuity_adjustment:
        # the canonical post's discontinuity adjustment is row-local but reads
        # the tile's aggregated left volume: handed out, [D, T, W]
        out["agg_left"] = agg_l
    return out


def _cblsm_tile(le, re, cfg, ro_ext, rows, halo, axis_name=None, aux=()):
    """Every CBLSM cost and aggregation of ``models.cblsm`` on a
    halo-extended band; the arm rules and window sums read global rows."""
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


def _post_sharded(name: str):
    """The row-sharded post chain of ``name`` (``parallel.post_shard``), or
    None; imported here, where it runs, as the JAX package does."""
    from stereo_match_traditional_tpu_torch.parallel import post_shard

    return {
        "ad_census": post_shard.ad_census_post_sharded,
        "cblsm": post_shard.cblsm_post_sharded,
        "asw": post_shard.asw_post_sharded,
        "sad": post_shard.sad_post_sharded,
    }.get(name)


def _canonical_post_rows(disp_l, disp_r, left, cfg, adjust, budget_bytes=256e6):
    """The canonical post on the gathered maps: LR check at
    ``lrcheck_thres`` -> iterative region voting over arms computed once
    from the whole left image -> the discontinuity adjustment by
    ``adjust(disp)``, which reads the aggregated left volume where an
    executor keeps it (tiles or bands) -> median, each gated as in
    ``models.ad_census.ad_census_post_canonical``.  The voting histogram is
    chunked within ``budget_bytes`` (exact)."""
    cp = cfg.cross_params
    arms_l = aggregate.canonical_cross_arms(left, cp)
    h, w = disp_l.shape
    dc = irv_auto_d_chunk(h, w, cfg.disp_range, budget_bytes=budget_bytes)
    if not cp.do_discontinuity_adjustment:
        return ad_census_post_canonical(disp_l, disp_r, None, arms_l, cfg, irv_d_chunk=dc)
    d = disp_l
    occl = mism = None
    if cp.do_lr_check:
        lr = post.lr_check_consistency(disp_l, disp_r, cp.lrcheck_thres, post.INVALID)
        d, occl, mism = lr.disp, lr.occlusion, lr.mismatch
    if cp.do_filling:
        d = post.iterative_region_voting(
            d, arms_l, cfg.disp_range, cp.irv_ts, cp.irv_th,
            invalid_value=post.INVALID, d_chunk=dc,
        )
    d = adjust(d)
    d = post.median_filter(d, cfg.median_size, border="truncate")
    return d, occl, mism


def _band_rows(x: torch.Tensor, start: int, stop: int, h: int) -> torch.Tensor:
    """Rows ``start .. stop - 1`` of ``x`` by global row, clamped into the
    image (edge replication beyond it): a band or tile of an image padded to
    whole tiles."""
    idx = torch.arange(start, stop, device=x.device).clamp_(0, h - 1)
    return x.index_select(0, idx)


def _gather_rows(x: torch.Tensor, axis) -> torch.Tensor:
    """Every rank's ``[T, ...]`` tile along ``axis``, joined in row order."""
    got = comm.all_gather(x, axis)
    return got.reshape(-1, *got.shape[2:])


def tiled_pipeline(name: str, cfg, mesh, axis_name: str = "tile", shard_post: bool = False):
    """``(left, right, *aux) -> StereoResult`` running ``name``
    tile-data-parallel over the ``axis_name`` axis of ``mesh`` (a
    ``DeviceMesh``, ``parallel.mesh.make_mesh``): every rank of the axis
    calls it with the whole pair and returns the whole result.

    Rows are padded (edge replication) to a multiple of the ranks; rank
    ``i`` computes rows ``i * t ..`` with exact halos (the first extended
    row is global row ``i * t - halo``).  ``aux``: extra images tiled like
    the pair (asw ``variant='lab'``: ``left_lab``, ``right_lab``).  Post
    runs on the gathered maps, or with ``shard_post=True`` row-sharded
    (``parallel.post_shard``: exact, the same float operations a pixel),
    for the ``ad_census``, ``cblsm``, ``asw`` and ``sad`` (with a
    ``fill_max_search`` cap) chains; the canonical post runs on the gathered
    maps, its discontinuity adjustment on each rank's tile of the
    aggregated volume."""
    _check_tiled_support(name, cfg)
    core = _TILE_CORES[name]
    halo = receptive_field_rows(name, cfg)
    axis_size(mesh, axis_name)          # raises for a missing axis before any collective
    canonical = name == "ad_census" and getattr(cfg, "aggregation", "") == "cross_two_pass"
    post_fn = _post_sharded(name) if shard_post else None
    sad_unbounded = name == "sad" and getattr(cfg, "fill_max_search", None) is None
    if shard_post and (post_fn is None or canonical or sad_unbounded):
        if sad_unbounded:
            raise NotImplementedError(
                "shard_post for SAD needs SADConfig(fill_max_search=...): "
                "the faithful unbounded hole-fill rays (`Sad.h:365`) have "
                "no exact row-halo'd form; opt into a ray cap (exact at "
                "that cap) or use the gathered default"
            )
        raise NotImplementedError(
            "shard_post is implemented for the legacy ad_census/cblsm/asw/"
            f"sad chains, not {'canonical ad_census' if canonical else repr(name)}"
            " (the canonical region voting's 5x-arm reach has no exact "
            "row-halo'd form; use the gathered default)"
        )

    def run(left, right, *aux):
        axis = MeshAxis(mesh, axis_name)
        n, idx = axis.size, axis.index
        h = left.shape[0]
        t = -(-h // n)
        r0 = idx * t
        with stage_scope("halo"):
            le, re, *ae = [add_row_halo(_band_rows(x, r0, r0 + t, h), halo, axis)
                           for x in (left, right, *aux)]
        out = core(le, re, cfg, r0 - halo, h, halo, axis, tuple(ae))
        del le, re, ae
        agg_tile = out.pop("agg_left", None)
        if post_fn is not None and getattr(cfg, "run_post", False):
            with stage_scope("post"):
                dmap, occl, mism = post_fn(out["disp_left"], out["disp_right"], cfg, axis,
                                           row_offset=r0, global_rows=h)
            out.update(disp_final=dmap, occlusion=occl, mismatch=mism)
        with stage_scope("gather"):
            maps = {k: _gather_rows(v, axis)[:h] for k, v in out.items() if v is not None}
        disp_l, disp_r = maps["disp_left"], maps.get("disp_right")
        disp_final, occl, mism = (maps.get(k) for k in ("disp_final", "occlusion", "mismatch"))
        if "disp_final" not in maps and getattr(cfg, "run_post", False) and name in _POST:
            def adjust(d):
                da = post.discontinuity_adjustment(_band_rows(d, r0, r0 + t, h), agg_tile,
                                                   post.INVALID)
                return _gather_rows(da, axis)[:h]

            with stage_scope("post"):
                if canonical:
                    disp_final, occl, mism = _canonical_post_rows(disp_l, disp_r, left, cfg,
                                                                  adjust)
                else:
                    disp_final, occl, mism = _POST[name](disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


_TILED_CACHE = {}


def run_tiled(
    name: str,
    left,
    right,
    cfg=None,
    mesh=None,
    axis_name: str = "tile",
    shard_post: bool = False,
    aux=(),
) -> StereoResult:
    """One call of :func:`tiled_pipeline` on every rank of the mesh.

    ``mesh=None`` builds a one-axis mesh over the whole world
    (``parallel.mesh.make_mesh``; a process started alone is a world of
    one).  The runner is cached per (name, cfg, mesh, axis, shard_post).
    Tensors keep their device (pass CPU tensors to run on the CPU);
    anything else goes to the card."""
    from stereo_match_traditional_tpu_torch.models.registry import _tensor, get_pipeline

    if cfg is None:
        cfg = get_pipeline(name)[1]()
    if mesh is None:
        from stereo_match_traditional_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(axis_names=(axis_name,))
    key = (name, cfg, mesh, axis_name, shard_post)
    fn = _TILED_CACHE.get(key)
    if fn is None:
        fn = _TILED_CACHE[key] = tiled_pipeline(name, cfg, mesh, axis_name,
                                                shard_post=shard_post)
    return fn(_tensor(left), _tensor(right), *(_tensor(a) for a in aux))


# ---------------------------------------------------------------------------
# the (tile, disp) runners: rows data-parallel, disparities sharded
# ---------------------------------------------------------------------------


def _tile_disp_scaffold(mesh, tile_axis, disp_axis, halo, disp_range, body):
    """The ``(tile, disp)`` scaffolding of the runners below: rows padded
    to whole tiles, the halo exchange over ``tile_axis``, the local
    disparity slice (rounded up where the ranks do not divide
    ``disp_range``), the gather of the maps.

    ``body(le, re, ro_ext, rows, d_off, pad_mask, disp)`` gets the
    halo-extended tile, the slice's first global disparity, the mask of its
    padded slots (global d >= disp_range, ``[d_local, 1, 1]``), which it
    must mask so that the two-stage WTA never picks them, and the disp axis;
    it returns a dict of ``[T, W]`` maps, the same on every rank of the
    disp axis.  Returns ``(run_maps, d_local)``: ``run_maps(left, right)``
    gives the dict of whole maps."""
    axis_size(mesh, tile_axis)
    n_d = axis_size(mesh, disp_axis)
    if n_d > disp_range:
        raise ValueError(f"disp axis ({n_d}) larger than disp_range ({disp_range})")
    d_local = -(-disp_range // n_d)

    def run_maps(left, right):
        ta, da = MeshAxis(mesh, tile_axis), MeshAxis(mesh, disp_axis)
        h = left.shape[0]
        t = -(-h // ta.size)
        r0 = ta.index * t
        d_off = da.index * d_local
        le, re = (add_row_halo(_band_rows(x, r0, r0 + t, h), halo, ta) for x in (left, right))
        slots = torch.arange(d_off, d_off + d_local, device=left.device)
        maps = body(le, re, r0 - halo, h, d_off, (slots >= disp_range)[:, None, None], da)
        return {k: _gather_rows(v, ta)[:h] for k, v in maps.items()}

    return run_maps, d_local


def ad_census_tile_disp(cfg, mesh, tile_axis: str = "tile", disp_axis: str = "disp"):
    """AD-Census over a 2-D mesh: rows sharded over ``tile_axis`` (halo
    exchange) and the disparity range over ``disp_axis``: each rank builds
    its slice of both views' volumes in one launch (the cost kernel's
    ``d_offset``: the clamped column gather makes every slice computable on
    its own), aggregates it (rectangle means are per disparity) and the WTA
    combines with a two-stage MIN reduce (``parallel.wta_shard``).  The
    post chain runs on the gathered maps.

    The scanline couples d +- 1 across the sharded axis and is not
    supported here: keep ``cfg.scanline=None`` or use
    :func:`tiled_pipeline`."""
    if cfg.scanline is not None:
        raise NotImplementedError(
            "ad_census_tile_disp does not implement scanline optimization "
            "(the SGM recurrence couples d±1 across the sharded axis); use "
            "tiled_pipeline with a 1-D tile mesh"
        )
    if cfg.aggregation != "rect_mean":
        raise NotImplementedError(
            f"ad_census_tile_disp implements aggregation='rect_mean' only "
            f"(got {cfg.aggregation!r}); use tiled_pipeline"
        )
    halo = receptive_field_rows("ad_census", cfg)

    def body(le, re, ro_ext, rows, d_off, pad_mask, disp):
        vols = ad_census_volumes_cuda(
            le, re, pad_mask.shape[0], cfg.sigma_c, cfg.sigma_s, cfg.census_rows,
            cfg.census_cols, row_offset=ro_ext, global_rows=rows, d_offset=d_off)
        out = {}
        for key, vol, img in zip(("disp_left", "disp_right"), vols, (le, re)):
            arms = aggregate.cross_arms(img, cfg.arms, ro_ext, rows)
            for _ in range(cfg.agg_iters):
                vol = aggregate.rect_mean_aggregate(vol, arms, max_span=cfg.arms.max_length)
            vol = torch.where(pad_mask, float("inf"), crop_row_halo(vol, halo, 1))
            out[key] = wta_sharded(vol, disp, "min")
        return out

    run_maps, _ = _tile_disp_scaffold(mesh, tile_axis, disp_axis, halo, cfg.disp_range, body)

    def run(left, right):
        maps = run_maps(left, right)
        disp_l, disp_r = maps["disp_left"], maps["disp_right"]
        disp_final = occl = mism = None
        if cfg.run_post:
            disp_final, occl, mism = ad_census_post(disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def ncc_tile_disp(cfg, mesh, tile_axis: str = "tile", disp_axis: str = "disp"):
    """NCC over a 2-D ``(tile, disp)`` mesh: rows sharded over ``tile_axis``
    with a ``win_size`` halo; each rank builds its slice of the correlation
    volume (``ncc_volume_f32``'s ``d_offset``) and a two-stage argmax
    (``wta_sharded`` 'max') combines over ``disp_axis``.  Ranges that the
    ranks do not divide round the slice up and mask the padded slots to
    -inf.  NCC's reference main runs D=200 (`NCC/NCC_main.cpp:18`), the
    pipeline that most wants its disparities sharded."""
    _check_tiled_support("ncc", cfg)
    if cfg.variant != "window":
        raise NotImplementedError(
            f"ncc_tile_disp implements variant='window' only (got "
            f"{cfg.variant!r}: the shifted variant's per-offset argmax "
            "tracker is not a disparity-sharded reduction); use "
            "tiled_pipeline"
        )
    halo = receptive_field_rows("ncc", cfg)

    def body(le, re, ro_ext, rows, d_off, pad_mask, disp):
        vol, interior = ncc_volume_cuda(
            le, re, pad_mask.shape[0], cfg.win_size, cfg.invalid_mode, cfg.eps,
            row_offset=ro_ext, global_rows=rows, d_offset=d_off)
        vol = torch.where(pad_mask, float("-inf"), crop_row_halo(vol, halo, 1))
        best = wta_sharded(vol, disp, "max")
        return {"disp_left": torch.where(crop_row_halo(interior, halo, 0), best, 0.0)}

    run_maps, _ = _tile_disp_scaffold(mesh, tile_axis, disp_axis, halo, cfg.disp_range, body)

    def run(left, right):
        return StereoResult(run_maps(left, right)["disp_left"])

    return run
