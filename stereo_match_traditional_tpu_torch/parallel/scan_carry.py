"""Sharded 4-path scanline optimization (torch counterpart of
``stereo_match_traditional_tpu.parallel.scan_carry``).

The recurrence (`AD-CensusV1/ScanlineOptimizer.h:130-253`) runs serially
along each row and column.  Under row tiling the two horizontal passes are
row-local: each rank owns whole rows, and both run in one launch of a band
entry (``ops.kernels.scanline_banded_cuda.horizontal_passes_banded_cuda``,
``canonical_horizontal_passes_banded_cuda``) on its tile.  The two vertical
passes would serialize across tiles, so the volume is resharded with one
``all_to_all`` from rows to columns: each rank then owns every row of a
slab of columns, and both vertical passes run over the whole height on it
(``directional_pass_banded_cuda`` / ``canonical_pass_banded_cuda`` from a
zero carry, the exact path seed), before a second ``all_to_all`` brings the
result back to row tiles.  The math is the whole-image pass's: no carry is
approximated, and the sums keep the direct kernel's order,
``(lr + rl) + (ud + du)`` (canonical: ``* 0.25``).

The width is padded to a multiple of the ranks for the reshard; the
vertical passes run on the image's true rows only, so the bottom-up pass
starts at the true last row.

Stage ranges (``utils.profiling.stage_scope``): ``stereo/scanline_horizontal``,
``stereo/scales`` (canonical), ``stereo/reshard`` (both ``all_to_all`` trips
with their copies), ``stereo/scanline_vertical``.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import ScanlineConfig
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_banded_cuda import (
    canonical_horizontal_passes_banded_cuda,
    canonical_pass_banded_cuda,
    directional_pass_banded_cuda,
    horizontal_passes_banded_cuda,
)
from stereo_match_traditional_tpu_torch.ops.scanline import canonical_scale
from stereo_match_traditional_tpu_torch.ops.volume import shifted_stack
from stereo_match_traditional_tpu_torch.parallel import comm
from stereo_match_traditional_tpu_torch.parallel.halo import add_row_halo
from stereo_match_traditional_tpu_torch.utils.profiling import stage_scope


def _to_columns(x: torch.Tensor, axis, true_rows: int) -> torch.Tensor:
    """``x`` [T, C..., W] (rows of this rank's tile, all columns) ->
    [true_rows, C..., Wp / n] (every row of this rank's slab of columns;
    the width zero-padded to a multiple of the ranks)."""
    n = axis.size
    t, w = x.shape[0], x.shape[-1]
    wc = -(-w // n)
    x = torch.nn.functional.pad(x, (0, wc * n - w))
    chunks = x.reshape(*x.shape[:-1], n, wc).movedim(-2, 0)       # [n, T, C..., wc]
    got = comm.all_to_all(chunks.contiguous(), axis)              # chunk k: rank k's rows
    return got.reshape(n * t, *got.shape[2:])[:true_rows]


def _to_rows(x: torch.Tensor, axis, t: int, w: int) -> torch.Tensor:
    """Inverse of :func:`_to_columns`: [true_rows, C..., wc] -> [t, C..., W],
    the padded rows beyond the image zero."""
    n = axis.size
    x = torch.nn.functional.pad(x, (0,) * (2 * (x.dim() - 1)) + (0, n * t - x.shape[0]))
    chunks = x.reshape(n, t, *x.shape[1:])                        # chunk k: rank k's rows
    got = comm.all_to_all(chunks.contiguous(), axis)              # chunk k: columns of rank k
    return got.movedim(0, -2).reshape(*got.shape[1:-1], -1)[..., :w]


def scanline_optimize_sharded(
    cost: torch.Tensor,
    gray: torch.Tensor,
    cfg: ScanlineConfig,
    axis_name,
    true_rows: int = None,
) -> torch.Tensor:
    """The 4-path scanline of ``ops.scanline.scanline_optimize`` on a
    row-sharded volume: ``cost`` is this rank's ``[D, T, W]`` tile (any
    strides, all columns), ``gray`` its ``[T, W]`` rows of the image that
    drives P2, ``axis_name`` the tile axis (a
    :class:`parallel.mesh.MeshAxis`).  ``true_rows`` is the image's row
    count when it was padded to whole tiles (default: all rows of all
    tiles); the padded rows of the result are not the image's.  Returns the
    tile's ``[D, T, W]`` optimized volume."""
    p1, p2 = cfg.effective_penalties(cost.shape[0])
    vert_dm1 = not cfg.faithful_vertical_l2
    d, t, w = cost.shape
    if true_rows is None:
        true_rows = t * axis_name.size

    with stage_scope("scanline_horizontal"):
        lr, rl = horizontal_passes_banded_cuda(cost, gray, p1, p2)
        horiz = lr + rl
        del lr, rl

    with stage_scope("reshard"):
        g = _to_columns(gray.to(torch.float32), axis_name, true_rows)        # [H, wc]
        cv = _to_columns(cost.permute(1, 0, 2), axis_name, true_rows)        # [H, D, wc]
    p2_t = torch.tensor(p2, dtype=torch.float32, device=g.device)

    def p2_of(g_ref):
        # a true division, as the whole-image pass takes it
        return torch.clamp(torch.div(p2_t, torch.abs(g - g_ref) + 1.0), min=p1)

    if cfg.faithful_vertical_p2:
        # ScanLineUpDown keeps the path's first grey value (`ScanlineOptimizer.h:210,232`)
        p2_dn, p2_up = p2_of(g[:1]), p2_of(g[-1:])
    else:
        p2_dn = p2_of(torch.cat([g[:1], g[:-1]]))
        p2_up = p2_of(torch.cat([g[1:], g[-1:]]))
    zero = (cv.new_zeros(cv.shape[1:]), cv.new_zeros(cv.shape[2:]))
    with stage_scope("scanline_vertical"):
        ud, _ = directional_pass_banded_cuda(cv, p2_dn, zero, None, p1, vert_dm1)
        du, _ = directional_pass_banded_cuda(cv, p2_up, zero, None, p1, vert_dm1, reverse=True)
        del cv
        ud += du
        del du
    with stage_scope("reshard"):
        vert = _to_rows(ud, axis_name, t, w)                                 # [T, D, W]
    return horiz + vert.permute(1, 0, 2)


def scanline_canonical_sharded(
    cost: torch.Tensor,
    base: torch.Tensor,
    match: torch.Tensor,
    p1: float,
    p2: float,
    tso: float,
    view: str,
    axis_name,
    true_rows: int = None,
) -> torch.Tensor:
    """The canonical tso-scheduled scanline of
    ``ops.scanline.scanline_optimize_canonical`` on a row-sharded volume
    (the ``cross_two_pass`` family on the tiled executor): ``cost`` is this
    rank's ``[D, T, W]`` tile, ``base`` / ``match`` its ``[T, W]`` rows of
    the view's own grey image and of the other one (left / right for
    ``view='left'``); the rest as :func:`scanline_optimize_sharded`.

    The vertical passes' penalty scales consult the match image at column
    ``x - d`` (``x + d`` for the right view), which lies outside a slab of
    columns, so they are computed row-locally, before the reshard, from the
    tile's rows and the row above it (one row of halo), and resharded with
    the volume: a scale between two rows serves both vertical passes.  This
    takes the place of the JAX package's reshard of the D-deep matched-image
    stack."""
    d, t, w = cost.shape
    if true_rows is None:
        true_rows = t * axis_name.size

    with stage_scope("scanline_horizontal"):
        lr, rl = canonical_horizontal_passes_banded_cuda(cost, base, match, p1, p2, tso,
                                                         view == "right")
        horiz = lr + rl
        del lr, rl

    with stage_scope("scales"):
        # scale(y) between rows y - 1 and y, [T, D, W]; row 0's is unused
        g = add_row_halo(base.to(torch.float32), 1, axis_name)[:-1]            # [T + 1, W]
        m = add_row_halo(match.to(torch.float32), 1, axis_name)[:-1]
        g2 = shifted_stack(m, d, view).permute(1, 0, 2)                        # [T + 1, D, W]
        scale = canonical_scale(g[1:], g[:-1], g2[1:], g2[:-1], tso)
        del g2
    with stage_scope("reshard"):
        sc = _to_columns(scale, axis_name, true_rows)                          # [H, D, wc]
        cv = _to_columns(cost.permute(1, 0, 2), axis_name, true_rows)
        del scale
    zero = (cv.new_zeros(cv.shape[1:]), cv.new_zeros(cv.shape[2:]))
    with stage_scope("scanline_vertical"):
        ud, _ = canonical_pass_banded_cuda(cv, sc, zero, None, p1, p2)
        # the bottom-up step at row y takes the scale between y and y + 1;
        # the last row's (the path's first step) is unused
        du, _ = canonical_pass_banded_cuda(cv, torch.cat([sc[1:], sc[-1:]]), zero, None, p1,
                                           p2, reverse=True)
        del cv, sc
        ud += du
        del du
    with stage_scope("reshard"):
        vert = _to_rows(ud, axis_name, t, w)
    return (horiz + vert.permute(1, 0, 2)) * 0.25
