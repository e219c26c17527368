"""Row-sharded post-processing (torch counterpart of
``stereo_match_traditional_tpu.parallel.post_shard``).

By default the tiled executor runs the post chains on the gathered maps,
every rank the whole chain.  With ``shard_post=True`` each rank runs it on
its own ``[T, W]`` tile:

* LR checks are row-local: direct on the tile.
* Speckle removal is a global connected-components problem.  Each rank
  labels its tile extended by one row of each neighbour, with global flat
  indices as labels, by the sweeps of ``ops.post.remove_speckles`` (hook the
  minimum label across every connected pair, then a pointer jump where the
  label names a pixel of the extended tile) until the tile is at its local
  fixpoint; then the halo rows min-merge with their owners' labels.  A SUM
  of the ranks' change flags ends the loop on every rank together, at the
  global fixpoint, where every component holds its smallest index.
  Component areas are histograms over global labels, summed over the axis.
* Hole filling chains three passes, each reading the previous pass's fills
  up to ``max_search - 1`` rows away, so every pass runs on its own fresh
  ``(max_search - 1)``-row halo with rows beyond the image masked invalid,
  and keeps its exact interior.  Medians run on a radius halo the same way
  (``ops.post.median_filter``'s ``row_offset`` / ``global_rows``).

Every function here is called by every rank of the axis with tiles of one
shape, and runs the same collectives in the same order on each.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereo_match_traditional_tpu_torch.ops import post
from stereo_match_traditional_tpu_torch.ops.post import INVALID
from stereo_match_traditional_tpu_torch.parallel import comm
from stereo_match_traditional_tpu_torch.parallel.halo import _shift_down, _shift_up, add_row_halo


def _edge_from_prev(x_row: torch.Tensor, axis, fill) -> torch.Tensor:
    """The row ``x_row`` of the rank above (rank 0: ``fill``)."""
    return _shift_down(x_row, axis, torch.full_like(x_row, fill))


def _edge_from_next(x_row: torch.Tensor, axis, fill) -> torch.Tensor:
    """The row ``x_row`` of the rank below (the last rank: ``fill``)."""
    return _shift_up(x_row, axis, torch.full_like(x_row, fill))


def _local_fixpoint(labels, src, dst, base, n_ext, big):
    """Sweeps of ``ops.post.remove_speckles`` over the extended tile's
    connected pairs ``(src, dst)`` until nothing changes: every pair takes
    its minimum label, that minimum is hooked onto both old labels where
    they name a pixel of the extended tile (global index ``base`` + flat
    position), and each label jumps once to its pixel's label.  Labels only
    decrease and always name a pixel of their component."""
    while True:
        ls, ld = labels[src], labels[dst]
        m = torch.minimum(ls, ld)
        new = labels.clone()
        new.scatter_reduce_(0, src, m, "amin")
        new.scatter_reduce_(0, dst, m, "amin")
        for old in (ls, ld):
            pos = old - base
            here = (pos >= 0) & (pos < n_ext)
            new.scatter_reduce_(0, pos[here], m[here], "amin")
        pos = new - base
        here = (pos >= 0) & (pos < n_ext) & (new < big)
        new = torch.where(here, new[pos.clamp(0, n_ext - 1)], new)
        if torch.equal(new, labels):
            return labels
        labels = new


def remove_speckles_sharded(
    disp: torch.Tensor,
    diff_insame: float,
    min_speckle_area: int,
    axis_name,
    row_offset,
    global_rows: int,
    invalid_value: float = INVALID,
    background: Optional[float] = None,
    max_iters: Optional[int] = None,
    connectivity: int = 8,
    plain_sweeps: int = 24,
) -> torch.Tensor:
    """Exact sharded ``ops.post.remove_speckles`` of this rank's ``[T, W]``
    tile along ``axis_name`` (a :class:`parallel.mesh.MeshAxis`).

    ``row_offset`` is the tile's first global row; rows at or beyond
    ``global_rows`` (the bottom tile's padding) are invalid, so padded rows
    cannot join components.  ``max_iters`` caps the rounds of exchange
    (None: until the fixpoint, which the loop reaches because labels only
    decrease); every rank leaves the loop in the same round.
    ``plain_sweeps`` takes the JAX package's position: its sweeps start
    pointer-jumping after that many, where every sweep here does."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    t, w = disp.shape
    d = disp.to(torch.float32)
    rows = row_offset + torch.arange(t, device=d.device)
    valid = torch.isfinite(d) & (d != invalid_value) & (rows < global_rows)[:, None]

    # one row of each neighbour, for the connections across tile edges
    d_ext = torch.cat([_edge_from_prev(d[-1:], axis_name, float("nan")), d,
                       _edge_from_next(d[:1], axis_name, float("nan"))])
    v_ext = torch.cat([_edge_from_prev(valid[-1:], axis_name, False), valid,
                       _edge_from_next(valid[:1], axis_name, False)])
    src, dst = post._speckle_edges(d_ext, v_ext, diff_insame, connectivity)

    big = global_rows * w
    base = (row_offset - 1) * w                   # global index of the extended tile's first pixel
    n_ext = (t + 2) * w
    idx_ext = base + torch.arange(n_ext, device=d.device)
    labels = torch.where(v_ext.reshape(-1), idx_ext, big)

    rounds = 0
    while max_iters is None or rounds < max_iters:
        rounds += 1
        start = labels
        labels = _local_fixpoint(labels, src, dst, base, n_ext, big).reshape(t + 2, w)
        # the halo rows take the minimum with their owners' labels
        top = torch.minimum(labels[0], _edge_from_prev(labels[t], axis_name, big))
        bottom = torch.minimum(labels[t + 1], _edge_from_next(labels[1], axis_name, big))
        labels = torch.cat([top[None], labels[1:t + 1], bottom[None]]).reshape(-1)
        changed = torch.tensor([int(not torch.equal(labels, start))], device=d.device)
        if int(comm.all_reduce(changed, "sum", axis_name)) == 0:
            break
    labels = labels.reshape(t + 2, w)[1:t + 1]

    flat = torch.where(valid, labels, big).reshape(-1)

    def per_label(members):
        counts = torch.zeros(big + 1, dtype=torch.int32, device=d.device)
        counts.index_add_(0, flat, members.reshape(-1).to(torch.int32))
        return comm.all_reduce(counts, "sum", axis_name)[flat].reshape(t, w)

    kill = valid & (per_label(valid) < min_speckle_area)
    if background is not None:
        kill &= per_label(valid & (d != background)) > 0
    return torch.where(kill, invalid_value, d)


def _mask_outside_rows(x: torch.Tensor, row_offset, global_rows: int, fill) -> torch.Tensor:
    rows = row_offset + torch.arange(x.shape[0], device=x.device)
    ok = ((rows >= 0) & (rows < global_rows))[:, None]
    return torch.where(ok, x, fill)


def fill_holes_8dir_sharded(
    disp: torch.Tensor,
    occlusion: torch.Tensor,
    mismatch: torch.Tensor,
    axis_name,
    row_offset,
    global_rows: int,
    invalid_value: float = INVALID,
    max_search: int = None,
) -> torch.Tensor:
    """Exact sharded ``ops.post.fill_holes_8dir`` of ``[T, W]`` row tiles.

    Each of the three passes reads the previous pass's fills up to
    ``max_search - 1`` rows away, so every pass runs on a fresh
    ``(max_search - 1)``-row halo and keeps its exact interior: each pass's
    inputs are the whole image's.  Rows beyond the image are invalid, never
    candidates and never filled.  ``max_search=None`` (the SAD chain's
    unbounded rays, `Sad.h:365`) has no halo'd form and raises."""
    if max_search is None:
        raise NotImplementedError(
            "unbounded hole-fill rays (max_search=None) have no exact "
            "row-halo'd form; run the gathered post chain instead"
        )
    t = disp.shape[0]
    max_axis = max(max_search - 1, 0)
    max_diag = int(round(max_axis * 0.70710678))
    halo = max_axis
    ro_ext = row_offset - halo
    inf = float("inf")

    d = torch.where(disp == invalid_value, inf, disp.to(torch.float32))
    # occlusions take the second-smallest candidate, mismatches the median,
    # then any pixel still invalid the median (`PostProcessing.h:172-190`)
    for tgt, second in ((occlusion, True), (mismatch, False), (None, False)):
        d_e = _mask_outside_rows(add_row_halo(d, halo, axis_name), ro_ext, global_rows, inf)
        if tgt is None:
            te = _mask_outside_rows(~torch.isfinite(d_e), ro_ext, global_rows, False)
        else:
            tgt_e = _mask_outside_rows(add_row_halo(tgt, halo, axis_name), ro_ext,
                                       global_rows, False)
            te = tgt_e & ~torch.isfinite(d_e)
        d_e = post._fill_from_candidates(d_e, te, second, max_axis, max_diag)
        d = d_e[halo:halo + t]
    return torch.where(torch.isfinite(d), d, invalid_value)


def _median_sharded(d, size, axis_name, row_offset, global_rows):
    """The truncate-border median of ``size`` on a tile with a radius halo."""
    halo = size // 2
    ro_ext = row_offset - halo
    d_e = _mask_outside_rows(add_row_halo(d, halo, axis_name), ro_ext, global_rows,
                             post.INVALID)
    d_e = post.median_filter(d_e, size, border="truncate", row_offset=ro_ext,
                             global_rows=global_rows)
    return d_e[halo:halo + d.shape[0]]


def ad_census_post_sharded(disp_l, disp_r, cfg, axis_name, row_offset, global_rows: int):
    """``models.ad_census.ad_census_post`` on ``[T, W]`` row tiles: LR
    consistency (row-local) -> sharded speckle removal -> per-pass-halo'd
    8-direction hole fill -> halo'd truncate-border median.  Returns
    ``(disp, occlusion, mismatch)`` tiles."""
    lr = post.lr_check_consistency(disp_l, disp_r, cfg.lr_gate, post.INVALID,
                                   disp_range=cfg.disp_range)
    d = remove_speckles_sharded(lr.disp, cfg.speckle_diff, cfg.speckle_area, axis_name,
                                row_offset, global_rows, invalid_value=post.INVALID)
    d = fill_holes_8dir_sharded(d, lr.occlusion, lr.mismatch, axis_name, row_offset,
                                global_rows, invalid_value=post.INVALID,
                                max_search=cfg.disp_range)
    d = _median_sharded(d, cfg.median_size, axis_name, row_offset, global_rows)
    return d, lr.occlusion, lr.mismatch


def sad_post_sharded(disp_l, disp_r, cfg, axis_name, row_offset, global_rows: int):
    """``models.sad.sad_post`` on ``[T, W]`` row tiles: LR cross-check
    (row-local, `Sad.h:184-222`) -> sharded speckle removal that never seeds
    at disparity 0 (`Sad.h:265`) -> per-pass-halo'd hole fill -> halo'd
    median 3.  Needs ``cfg.fill_max_search``: the reference's rays are
    unbounded (`Sad.h:365`) and have no exact row-halo'd form; with a cap
    the chain is ``sad_post``'s at that cap, bit for bit."""
    if cfg.fill_max_search is None:
        raise NotImplementedError(
            "sad_post_sharded needs SADConfig(fill_max_search=...): the "
            "faithful unbounded hole-fill rays (`Sad.h:365`) have no exact "
            "row-halo'd form; use the gathered default or opt into a cap"
        )
    lr = post.lr_check_simple(disp_l, disp_r, cfg.lr_gate, post.INVALID,
                              disp_range=cfg.max_disparity)
    d = remove_speckles_sharded(lr.disp, cfg.speckle_diff, cfg.speckle_area, axis_name,
                                row_offset, global_rows, invalid_value=post.INVALID,
                                background=0.0)
    d = fill_holes_8dir_sharded(d, lr.occlusion, lr.mismatch, axis_name, row_offset,
                                global_rows, invalid_value=post.INVALID,
                                max_search=cfg.fill_max_search)
    d = _median_sharded(d, 3, axis_name, row_offset, global_rows)
    return d, lr.occlusion, lr.mismatch


def cblsm_post_sharded(disp_l, disp_r, cfg, axis_name, row_offset, global_rows: int):
    """``models.cblsm.cblsm_post`` (LR -> speckles -> median) sharded."""
    lr = post.lr_check_consistency(disp_l, disp_r, cfg.lr_gate, post.INVALID,
                                   disp_range=cfg.disp_range)
    d = remove_speckles_sharded(lr.disp, cfg.speckle_diff, cfg.speckle_area, axis_name,
                                row_offset, global_rows, invalid_value=post.INVALID)
    d = _median_sharded(d, cfg.median_size, axis_name, row_offset, global_rows)
    return d, lr.occlusion, lr.mismatch


def asw_post_sharded(disp_l, disp_r, cfg, axis_name, row_offset, global_rows: int):
    """``models.asw.asw_post`` (`ASWeight.cpp:66-78`) on ``[T, W]`` row
    tiles: LR check writing 0 (row-local) -> the global min-max scale to u8
    (MIN / MAX reduces) -> sharded 4-connectivity speckle filter ->
    medianBlur(5) -> ``FillImageNew`` (row-local) -> medianBlur(3), the
    medians on one halo of both radii (the median 5's output is exact on all
    but the outer 2 halo rows, which the median 3 then does not read).

    OpenCV's BORDER_REPLICATE replicates the current stage's edge row, so
    between the stages every row beyond the image (top halo rows, the bottom
    tile's padding) is re-pointed at the processed global edge row: a stale
    replicate would reach the next median's window."""
    t = disp_l.shape[0]
    lr = post.lr_check_simple(disp_l, disp_r, cfg.lr_gate, invalid_value=0.0,
                              disp_range=cfg.disp_range)

    def replicate_edges(x, first_row):
        rows = first_row + torch.arange(x.shape[0], device=x.device)
        return x.index_select(0, rows.clamp(0, global_rows - 1) - first_row)

    # cv::normalize(0, 255, NORM_MINMAX) over the image's rows only: the
    # bottom tile's padding rows hold values of edge-replicated image rows
    d = lr.disp
    rows = row_offset + torch.arange(t, device=d.device)
    in_image = (rows < global_rows)[:, None]
    lo = comm.all_reduce(torch.amin(torch.where(in_image, d, float("inf"))), "min", axis_name)
    hi = comm.all_reduce(torch.amax(torch.where(in_image, d, float("-inf"))), "max", axis_name)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), 0.0)
    d = torch.round((d - lo) * scale)

    d = remove_speckles_sharded(d, cfg.speckle_diff, cfg.speckle_area + 1, axis_name,
                                row_offset, global_rows, invalid_value=0.0, connectivity=4)
    d = replicate_edges(d, row_offset)

    halo = cfg.median_first // 2 + cfg.median_second // 2
    ro_ext = row_offset - halo
    d_e = add_row_halo(d, halo, axis_name)
    d_e = post.median_filter(d_e, cfg.median_first, border="replicate")
    d_e = replicate_edges(d_e, ro_ext)
    d_e = post.fill_image_new(d_e)
    d_e = post.median_filter(d_e, cfg.median_second, border="replicate")
    return d_e[halo:halo + t], None, None
