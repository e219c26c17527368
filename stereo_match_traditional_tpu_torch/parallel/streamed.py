"""Single-card streaming over row bands (torch counterpart of
``stereo_match_traditional_tpu.parallel.streamed``).

A dense ``[D, H, W]`` volume caps the image size on one card: at
2160x3840, D=256 one volume is 8.5 GB, and the port's float64 prefix sums
(rect mean, cross aggregation) hold twice that while they run.  This
executor runs a pipeline's cost, aggregation and WTA band by band: the row
cores of :mod:`parallel.tiled` on bands of ``row_tile`` rows extended by the
exact halo of ``receptive_field_rows``, one band after the other in a Python
loop, each band's volumes freed before the next band starts.  The post
chains run on the gathered ``[H, W]`` maps.

The 4-path scanline streams too.  Its horizontal passes are row-local, and a
vertical pass carries exactly ``(last aggregated row [D, W], its min [W])``
from one band to the next.  Two sweeps over the bands: the first, from the
last band up, re-derives each band's aggregated left volume and runs the
bottom-up pass to collect each band's incoming carry (only those ``[D, W]``
rows are kept); the second, from the top, re-derives both views' volumes,
runs both horizontal passes (one launch of a band entry, each row a whole
path) and both vertical continuations with the banded pass kernels
(``ops.kernels.scanline_banded_cuda``), sums the four and takes the WTA.  The aggregation is computed twice a band: memory traded for
operations.  A zero carry is the exact path seed, and the bottom-up pass
restarts at the image's true last row (rows beyond it pad the last band), so
the vertical chains equal the whole-image passes bit for bit.

The canonical family (cross_two_pass with the tso-scheduled scanline on both
views) streams the same way, with two carries a sweep and eight band passes
a band, summed as ``(lr + rl) + (ud + du)`` then ``* 0.25`` as the
whole-image pass does.  Its post runs on the gathered maps; the optional
discontinuity adjustment, which reads the aggregated left volume, is a third
band sweep.

Equality with the direct path: exact for SAD; elsewhere up to argmin ties
that the band's own prefix sums break differently (JAX's envelope).

Stage ranges (``utils.profiling.stage_scope``): ``stereo/band_cores`` (a
band's cost, aggregation and WTA, no scanline; for ad_census it holds the
core's own ``stereo/band_volumes`` and ``stereo/wta``), ``stereo/band_volumes`` (a
band's aggregated volumes), ``stereo/scales`` (the canonical penalty
scales), ``stereo/banded_passes``, ``stereo/sum_wta`` and ``stereo/post``.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.models.registry import _tensor, get_pipeline
from stereo_match_traditional_tpu_torch.ops import post, wta
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_banded_cuda import (
    canonical_horizontal_passes_banded_cuda,
    canonical_pass_banded_cuda,
    directional_pass_banded_cuda,
    horizontal_passes_banded_cuda,
)
from stereo_match_traditional_tpu_torch.ops.scanline import canonical_scale
from stereo_match_traditional_tpu_torch.ops.volume import shifted_stack
from stereo_match_traditional_tpu_torch.parallel.halo import crop_row_halo
from stereo_match_traditional_tpu_torch.parallel.tiled import (
    _POST,
    _TILE_CORES,
    _ad_census_band_volumes,
    _band_rows,
    _canonical_post_rows,
    _check_tiled_support,
    receptive_field_rows,
)
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope

# Live bytes of a band at its peak, in float32 [D, W] rows (volume rows) per
# band row with its halo: torch.cuda.max_memory_allocated at 720x1280, D=128
# on an NVIDIA H100 80GB HBM3 measured 11.35 (active), 11.47 (legacy FULL)
# and 13.20 (canonical FULL), the same at bands of 96 and 192 rows
# (PERF.md section 5); rounded up, and held against each run by
# chip_smoke.py phase 21.
_LIVE_VOLUME_ROWS = {"active": 12.0, "full": 12.0, "canonical": 14.0}
# The share of the card's memory the bands may take.  The rest is for the
# caching allocator's fragments: a band's float64 prefix sums of slightly
# different shapes left 20 GB reserved but unusable beside 49 GB allocated
# at 4K/D=256, where a band at 0.85 then failed to allocate (PERF.md §6).
_BUDGET = 0.7


def _memory_bytes(device) -> float:
    """Memory of ``device``: the card's total memory, or half the host's
    physical memory for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return float(torch.cuda.get_device_properties(device).total_memory)
    return 0.5 * float(os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def _mode(name: str, cfg) -> str:
    """The live-set class of a configuration: ``canonical`` and ``full``
    are ad_census with the scanline, canonical or legacy; ``active`` is
    everything else."""
    if name == "ad_census" and getattr(cfg, "scanline", None) is not None:
        return "canonical" if cfg.aggregation == "cross_two_pass" else "full"
    return "active"


def auto_row_tile(name: str, cfg, h: int, w: int, memory_bytes=None) -> int:
    """The largest band of rows whose live set fits the card: bigger bands
    recompute fewer halo rows, so the best band is the largest that fits.

    A band of ``t`` rows and its halos holds ``(t + 2 * halo)`` band rows,
    each ``_LIVE_VOLUME_ROWS[mode]`` float32 ``[D, W]`` rows at its peak
    (measured on the card); the bands may take ``_BUDGET`` of
    ``memory_bytes`` (default: the current CUDA device's memory, or half the
    host's without one).  Rounded down to a multiple of 8; raises below 16
    rows; at most ``h``."""
    d = getattr(cfg, "disp_range", getattr(cfg, "max_disparity", 1))
    halo = receptive_field_rows(name, cfg)
    if memory_bytes is None:
        memory_bytes = _memory_bytes("cuda" if torch.cuda.is_available() else "cpu")
    row_bytes = d * w * 4.0
    band_rows = _BUDGET * memory_bytes / (_LIVE_VOLUME_ROWS[_mode(name, cfg)] * row_bytes)
    t = int((band_rows - 2 * halo) // 8 * 8)
    if t < 16:
        raise ValueError(
            f"auto row_tile found no band for {name!r} at [{h}, {w}] D={d} (halo "
            f"{halo}, ~{row_bytes / 1e6:.0f} MB a volume row) in "
            f"{memory_bytes / 2**30:.1f} GiB: the workload does not stream on one "
            "device; shard it over devices (the tiled executor)"
        )
    return min(t, h)


def _next_band(device) -> None:
    """Where the caching allocator holds more than a tenth of the card's
    memory in blocks that the last band freed, return them to the card, so
    that the next band's volumes are cut from whole segments, not from the
    last band's fragments.  (Below that, as at Teddy's size, releasing and
    allocating anew costs more than the bands' own work.)"""
    if device.type == "cuda":
        idle = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        if idle > 0.1 * _memory_bytes(device):
            torch.cuda.empty_cache()


def _tile_of(row_tile, name, cfg, left) -> int:
    h, w = left.shape[:2]
    return row_tile or auto_row_tile(name, cfg, h, w, _memory_bytes(left.device))


def streamed_pipeline(name: str, cfg, row_tile=None):
    """``(left, right, *aux) -> StereoResult`` running ``name`` over
    sequential bands of ``row_tile`` rows plus exact halos.  ``aux``: extra
    images banded like the pair (asw ``variant='lab'``: ``left_lab``,
    ``right_lab``).  ``row_tile=None`` sizes the band by
    :func:`auto_row_tile`.

    Peak memory is about one band's volumes and their temporaries instead of
    the whole image's."""
    _check_tiled_support(name, cfg)
    canonical = name == "ad_census" and cfg.aggregation == "cross_two_pass"
    if getattr(cfg, "scanline", None) is not None:
        if name != "ad_census":
            raise NotImplementedError(
                f"streamed scanline is implemented for ad_census, not {name!r}"
            )
        if canonical:
            return _ad_census_canonical_streamed(cfg, row_tile)
        return _ad_census_scanline_streamed(cfg, row_tile)
    core = _TILE_CORES[name]
    halo = receptive_field_rows(name, cfg)

    def run(left, right, *aux):
        h = left.shape[0]
        t = _tile_of(row_tile, name, cfg, left)
        maps = {}
        for b0 in range(0, h, t):
            _next_band(left.device)
            band = [_band_rows(x, b0 - halo, b0 + t + halo, h) for x in (left, right, *aux)]
            with stage_scope("band_cores"):
                tiles = core(band[0], band[1], cfg, b0 - halo, h, halo, None, tuple(band[2:]))
            for k, v in tiles.items():
                maps.setdefault(k, []).append(v)
            del band, tiles
        disp_l = torch.cat(maps["disp_left"])[:h]
        disp_r = torch.cat(maps["disp_right"])[:h] if "disp_right" in maps else None

        disp_final = occl = mism = None
        if getattr(cfg, "run_post", False) and name in _POST:
            with stage_scope("post"):
                if canonical:
                    disp_final, occl, mism = _canonical_post_streamed(
                        disp_l, disp_r, left, right, cfg, t
                    )
                else:
                    disp_final, occl, mism = _POST[name](disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def streamed_canonical_staged(cfg, row_tile=None):
    """The canonical executor in two stages: the streamed cross_two_pass +
    tso scanline + dual WTA (``streamed_pipeline`` with the post off), then
    the canonical post on the produced maps (:func:`_canonical_post_streamed`).
    The same operations as ``streamed_pipeline(cfg)`` with ``run_post``, in
    the same order; the split is the re-entry point (the maps are the
    checkpoint between the two)."""
    if getattr(cfg, "aggregation", "") != "cross_two_pass" or cfg.scanline is None:
        raise ValueError(
            "streamed_canonical_staged is the canonical (cross_two_pass + "
            "scanline) executor; use streamed_pipeline for other configs"
        )
    maps = streamed_pipeline("ad_census", dataclasses.replace(cfg, run_post=False), row_tile)

    def run(left, right):
        res = maps(left, right)
        t = _tile_of(row_tile, "ad_census", cfg, left)
        with stage_scope("post"):
            fin, occl, mism = _canonical_post_streamed(res.disp_left, res.disp_right, left,
                                                       right, cfg, t)
        return StereoResult(res.disp_left, res.disp_right, fin, occl, mism)

    return run


def _canonical_post_streamed(disp_l, disp_r, left, right, cfg, row_tile):
    """The canonical post on the gathered maps (``tiled._canonical_post_rows``),
    its optional discontinuity adjustment a band sweep
    (:func:`_discontinuity_adjustment_streamed`).  The voting histogram is
    chunked over disparities within a quarter of the device's memory
    (exact)."""
    return _canonical_post_rows(
        disp_l, disp_r, left, cfg,
        lambda d: _discontinuity_adjustment_streamed(d, left, right, cfg, row_tile),
        budget_bytes=0.25 * _memory_bytes(disp_l.device))


def _discontinuity_adjustment_streamed(dmap, left, right, cfg, row_tile):
    """``post.discontinuity_adjustment`` band by band: it is row-local (a
    pixel reads its own aggregated costs at its own and its horizontal
    neighbours' disparities), so each band re-derives its aggregated left
    volume and adjusts its rows; the whole-image volume never exists."""
    if left.dim() != 2 or right.dim() != 2:
        raise ValueError(
            "streamed discontinuity adjustment takes grayscale [H, W] "
            f"inputs (got {left.dim()}-D); see _ad_census_canonical_streamed"
        )
    halo = receptive_field_rows("ad_census", cfg)
    t = row_tile
    h = dmap.shape[0]
    bands = []
    for b0 in range(0, h, t):
        _next_band(dmap.device)
        le = _band_rows(left, b0 - halo, b0 + t + halo, h)
        re = _band_rows(right, b0 - halo, b0 + t + halo, h)
        with stage_scope("band_volumes"):
            agg_l, _ = _ad_census_band_volumes(le, re, cfg, b0 - halo, h, left_only=True)
        db = _band_rows(dmap, b0, b0 + t, h)
        bands.append(post.discontinuity_adjustment(db, crop_row_halo(agg_l, halo, 1),
                                                   post.INVALID))
        del agg_l
    return torch.cat(bands)[:h]


def _zero_carry(d: int, m: int, like: torch.Tensor):
    return (torch.zeros((d, m), dtype=torch.float32, device=like.device),
            torch.zeros((m,), dtype=torch.float32, device=like.device))


def _reset_row(h: int, b0: int, t: int):
    """The band row where the bottom-up path starts (the image's last row),
    when it lies in the band ``b0 .. b0 + t - 1``, else None."""
    r = h - 1 - b0
    return r if 0 <= r < t else None


def _ad_census_canonical_streamed(cfg, row_tile):
    """Canonical AD-Census (cross_two_pass + the tso-scheduled scanline on
    both volumes + the canonical post) over sequential row bands: the
    canonical twin of :func:`_ad_census_scanline_streamed`.

    Each band's vertical penalty scales come from
    ``ops.scanline.canonical_scale`` on its grey rows with a one-row halo and
    the band's slice of the match image's shifted stack.  A scale is
    symmetric in its two neighbours, so one volume of scales between
    consecutive rows serves both vertical passes.  The horizontal passes
    take the band's grey rows and compute their own scales (the band
    entry's edge bits)."""
    cp = cfg.cross_params
    p1, p2, tso = cp.so_p1, cp.so_p2, float(cp.so_tso)
    halo = receptive_field_rows("ad_census", cfg)
    d = cfg.disp_range

    def run(left, right):
        if left.dim() != 2 or right.dim() != 2:
            raise ValueError(
                "the canonical streamed executor takes grayscale [H, W] "
                f"inputs (got {left.dim()}-D); colour guidance is not "
                "plumbed through the band sweeps: convert with "
                "utils.io.rgb_to_gray_u8 or use the direct executor"
            )
        h, w = left.shape
        t = _tile_of(row_tile, "ad_census", cfg, left)
        starts = list(range(0, h, t))
        grey = (left.to(torch.float32), right.to(torch.float32))

        def band_aggs(b0):
            """Both views' aggregated volumes of the band, [D, t, W]."""
            le = _band_rows(left, b0 - halo, b0 + t + halo, h)
            re = _band_rows(right, b0 - halo, b0 + t + halo, h)
            with stage_scope("band_volumes"):
                return [crop_row_halo(a, halo, 1)
                        for a in _ad_census_band_volumes(le, re, cfg, b0 - halo, h)]

        def scales(b0, v):
            """View ``v``'s scales between consecutive rows b0 - 1 .. b0 + t,
            [t + 1, D, W]."""
            view = ("left", "right")[v]
            base, match = grey if v == 0 else grey[::-1]
            with stage_scope("scales"):
                g = _band_rows(base, b0 - 1, b0 + t + 1, h)                   # [t + 2, W]
                g2 = shifted_stack(_band_rows(match, b0 - 1, b0 + t + 1, h), d, view)
                g2 = g2.permute(1, 0, 2)                                      # [t + 2, D, W]
                return canonical_scale(g[1:], g[:-1], g2[1:], g2[:-1], tso)

        zero = _zero_carry(d, w, left)
        # sweep 1, from the last band up: chain both views' bottom-up passes,
        # keeping each band's incoming carries
        up_in = [None] * len(starts)
        carry = [zero, zero]
        for i in reversed(range(len(starts))):
            _next_band(left.device)
            b0 = starts[i]
            up_in[i] = tuple(carry)
            aggs = band_aggs(b0)
            for v in (0, 1):
                vert = scales(b0, v)
                with stage_scope("banded_passes"):
                    _, carry[v] = canonical_pass_banded_cuda(
                        aggs[v].permute(1, 0, 2), vert[1:], carry[v], _reset_row(h, b0, t),
                        p1, p2, reverse=True, store=False)
                aggs[v] = vert = None
        # sweep 2, from the top: both horizontal passes and both vertical
        # continuations per view, averaged, then the WTA of each view
        carry = [zero, zero]
        disps = ([], [])
        for i, b0 in enumerate(starts):
            _next_band(left.device)
            aggs = band_aggs(b0)
            rows = [_band_rows(x, b0, b0 + t, h) for x in (left, right)]      # [t, W] each
            for v in (0, 1):
                agg, aggs[v] = aggs[v], None
                vert = scales(b0, v)
                cv = agg.permute(1, 0, 2)                                     # [t, D, W]
                with stage_scope("banded_passes"):
                    ud, carry[v] = canonical_pass_banded_cuda(cv, vert[:-1], carry[v], None,
                                                              p1, p2)
                    du, _ = canonical_pass_banded_cuda(cv, vert[1:], up_in[i][v],
                                                       _reset_row(h, b0, t), p1, p2,
                                                       reverse=True)
                    vert = cv = None
                    lr, rl = canonical_horizontal_passes_banded_cuda(
                        agg, rows[v], rows[1 - v], p1, p2, tso, v == 1)
                    agg = None
                with stage_scope("sum_wta"):
                    ud += du
                    du = None
                    total = lr                                                # [D, t, W]
                    total += rl
                    rl = None
                    total += ud.permute(1, 0, 2)
                    ud = None
                    total *= 0.25
                    disps[v].append(wta.wta(total, "min"))
                    total = lr = None
        disp_l = torch.cat(disps[0])[:h]
        disp_r = torch.cat(disps[1])[:h]
        disp_final = occl = mism = None
        if cfg.run_post:
            with stage_scope("post"):
                disp_final, occl, mism = _canonical_post_streamed(disp_l, disp_r, left, right,
                                                                  cfg, t)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def _ad_census_scanline_streamed(cfg, row_tile):
    """AD-Census with the legacy 4-path scanline (`ScanlineOptimizer.h:104-253`
    semantics, both vertical quirk flags), the WTA and the optional post,
    over sequential row bands: see the module docstring for the two sweeps.
    Beyond one band's working set only the ``[D, W]`` carries of the band
    boundaries and the ``[H, W]`` maps exist."""
    sl = cfg.scanline
    p1, p2_init = sl.effective_penalties(cfg.disp_range)
    vert_dm1 = not sl.faithful_vertical_l2
    vert_first = sl.faithful_vertical_p2
    halo = receptive_field_rows("ad_census", cfg)
    d = cfg.disp_range

    def run(left, right):
        h, w = left.shape[:2]
        t = _tile_of(row_tile, "ad_census", cfg, left)
        starts = list(range(0, h, t))
        grey = left.to(torch.float32)
        p2_t = torch.tensor(p2_init, dtype=torch.float32, device=left.device)

        def p2_of(g, g_ref):
            # a true division, as the whole-image pass takes it
            return torch.clamp(torch.div(p2_t, torch.abs(g - g_ref) + 1.0), min=p1)

        def band_parts(b0, left_only=False):
            """Aggregated volumes [D, t, W] and the band's grey rows with
            the row above and below each."""
            le = _band_rows(left, b0 - halo, b0 + t + halo, h)
            re = _band_rows(right, b0 - halo, b0 + t + halo, h)
            with stage_scope("band_volumes"):
                agg_l, agg_r = _ad_census_band_volumes(le, re, cfg, b0 - halo, h, left_only)
            agg_l = crop_row_halo(agg_l, halo, 1)
            agg_r = None if agg_r is None else crop_row_halo(agg_r, halo, 1)
            g3 = _band_rows(grey, b0 - 1, b0 + t + 1, h)                      # [t + 2, W]
            return agg_l, agg_r, g3[1:-1], g3[:-2], g3[2:]

        def up_p2(g, gn):
            # the bottom-up path's neighbour is the row below, or its first
            # row, the image's last, under the faithful_vertical_p2 quirk
            return p2_of(g, grey[h - 1][None] if vert_first else gn)

        zero = _zero_carry(d, w, left)
        # sweep 1, from the last band up: the bottom-up pass's carries
        up_in = [None] * len(starts)
        carry = zero
        for i in reversed(range(len(starts))):
            _next_band(left.device)
            b0 = starts[i]
            up_in[i] = carry
            agg_l, _, g, _, gn = band_parts(b0, left_only=True)
            with stage_scope("banded_passes"):
                _, carry = directional_pass_banded_cuda(
                    agg_l.permute(1, 0, 2), up_p2(g, gn), carry, _reset_row(h, b0, t), p1,
                    vert_dm1, reverse=True, store=False)
            del agg_l
        # sweep 2, from the top: lr + rl + ud + du, in the JAX package's
        # order, then the WTA of both views
        carry = zero
        dls, drs = [], []
        for i, b0 in enumerate(starts):
            _next_band(left.device)
            agg_l, agg_r, g, gp, gn = band_parts(b0)
            with stage_scope("sum_wta"):
                drs.append(wta.wta(agg_r, "min"))
            del agg_r
            cv = agg_l.permute(1, 0, 2)                                       # [t, D, W]
            with stage_scope("banded_passes"):
                lr, rl = horizontal_passes_banded_cuda(agg_l, g, p1, p2_init)
            with stage_scope("sum_wta"):
                total = lr                                                    # [D, t, W]
                total += rl
                del rl
            with stage_scope("banded_passes"):
                p2_dn = p2_of(g, grey[0][None] if vert_first else gp)
                dn, carry = directional_pass_banded_cuda(cv, p2_dn, carry, None, p1, vert_dm1)
            with stage_scope("sum_wta"):
                total += dn.permute(1, 0, 2)
                del dn
            with stage_scope("banded_passes"):
                up, _ = directional_pass_banded_cuda(cv, up_p2(g, gn), up_in[i],
                                                     _reset_row(h, b0, t), p1, vert_dm1,
                                                     reverse=True)
            del agg_l, cv
            with stage_scope("sum_wta"):
                total += up.permute(1, 0, 2)
                del up
                dls.append(wta.wta(total, "min"))
                del total, lr
        disp_l = torch.cat(dls)[:h]
        disp_r = torch.cat(drs)[:h]
        disp_final = occl = mism = None
        if cfg.run_post:
            with stage_scope("post"):
                disp_final, occl, mism = _POST["ad_census"](disp_l, disp_r, cfg)
        return StereoResult(disp_l, disp_r, disp_final, occl, mism)

    return run


def run_streamed(name: str, left, right, cfg=None, row_tile=None, aux=()) -> StereoResult:
    """One call of :func:`streamed_pipeline`.  ``row_tile=None`` sizes the
    band by :func:`auto_row_tile`.  Tensors keep their device (pass CPU
    tensors to run on the CPU); anything else goes to the card."""
    if cfg is None:
        cfg = get_pipeline(name)[1]()
    return streamed_pipeline(name, cfg, row_tile)(
        _tensor(left), _tensor(right), *(_tensor(a) for a in aux))
