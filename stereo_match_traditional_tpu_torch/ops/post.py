"""Post-processing (torch counterpart of
``stereo_match_traditional_tpu.ops.post``): the functions the ASW,
AD-Census (reference and canonical), SAD and CBLSM post chains run, each
bit-exact with its JAX counterpart."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_match_traditional_tpu_torch.ops.aggregate import _hsum, _vsum
from stereo_match_traditional_tpu_torch.ops.volume import INVALID, replicate_pad


class LRResult(NamedTuple):
    disp: torch.Tensor
    occlusion: torch.Tensor  # bool [H, W]
    mismatch: torch.Tensor   # bool [H, W]


def lr_check_simple(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    gate: float = 5.0,
    invalid_value: float = INVALID,
    disp_range: Optional[int] = None,
) -> LRResult:
    """Integer-index LR check (`SAD/Sad.h:184-222`, `ASW/ASW.h:108-145`).

    Compares dL(j) with dR(j - int(dL)); |diff| > gate invalidates the
    pixel, classified as occlusion when dL < dR else mismatch.  The column
    is clamped into the image (the reference reads out of bounds).

    ``disp_range`` is accepted and ignored: in the JAX package it selects a
    banded shift+select for the TPU, which gives the gather's values.
    """
    h, w = disp_left.shape
    dl = disp_left.to(torch.float32)
    drf = disp_right.to(torch.float32)
    jj = torch.arange(w, device=dl.device)[None, :]
    idx = (jj - dl.to(torch.int32)).clamp_(0, w - 1)
    dr = torch.gather(drf, 1, idx)
    bad = torch.abs(dl - dr) > gate
    occl = bad & (dl < dr)
    mism = bad & ~occl
    return LRResult(torch.where(bad, invalid_value, dl), occl, mism)


def lr_check_consistency(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    gate: float = 1.0,
    invalid_value: float = INVALID,
    disp_range: Optional[int] = None,
) -> LRResult:
    """Canonical rounded LR check (`AD-CensusV1/PostProcessing.h:72-135`).

    * pixels already invalid join the mismatch set (:90-93);
    * col_right = int(j - dL + 0.5) (:96); out of range -> invalid+mismatch;
    * |dL - dR| > gate -> invalid; classified via the reprojection
      col_rl = int(col_right + dR + 0.5): occlusion iff dL(col_rl) > dL(j)
      (:110-122), mismatch when col_rl leaves (0, W).

    Column reads are gathers; the JAX package's banded shift+select, which
    its ``disp_range`` selects, gives the same values for WTA maps in
    ``[0, D)``, so ``disp_range`` is accepted and ignored.
    """
    h, w = disp_left.shape
    dl = disp_left.to(torch.float32)
    drf = disp_right.to(torch.float32)
    already_invalid = ~torch.isfinite(dl) | (dl == invalid_value)

    jj = torch.arange(w, device=dl.device, dtype=torch.float32)[None, :]
    col_right = torch.trunc(jj - dl + 0.5).to(torch.int32)
    in_range = (col_right >= 0) & (col_right < w)
    dr = torch.gather(drf, 1, col_right.clamp(0, w - 1).long())
    bad = in_range & (torch.abs(dl - dr) > gate)

    col_rl = torch.trunc(col_right.to(torch.float32) + dr + 0.5).to(torch.int32)
    rl_in = (col_rl > 0) & (col_rl < w)
    disp_l_rl = torch.gather(dl, 1, col_rl.clamp(0, w - 1).long())

    occl = bad & rl_in & (disp_l_rl > dl)
    mism = (bad & ~occl) | ~in_range | already_invalid
    invalid = (bad | ~in_range) & ~already_invalid
    return LRResult(torch.where(invalid, invalid_value, dl), occl & ~already_invalid, mism)


def _speckle_edges(d, valid, diff_insame, connectivity):
    """Flat (p, q) index pairs of every connected neighbor pair: both
    members valid and ``|d(p) - d(q)| <= diff_insame`` (`Sad.h:294`)."""
    h, w = d.shape
    idx = torch.arange(h * w, device=d.device).reshape(h, w)
    dirs = [(0, -1), (-1, 0)]
    if connectivity == 8:
        dirs += [(-1, 1), (-1, -1)]
    src, dst = [], []
    for dy, dx in dirs:
        r0, r1 = max(0, -dy), h - max(0, dy)
        c0, c1 = max(0, -dx), w - max(0, dx)
        p = (slice(r0, r1), slice(c0, c1))
        q = (slice(r0 + dy, r1 + dy), slice(c0 + dx, c1 + dx))
        m = valid[p] & valid[q] & (torch.abs(d[p] - d[q]) <= diff_insame)
        src.append(idx[p][m])
        dst.append(idx[q][m])
    return torch.cat(src), torch.cat(dst)


def speckle_connectivity(d, valid, diff_insame):
    """``(conn_l, conn_u, conn_d1, conn_d2)``: whether each pixel connects to
    its left / up / up-right / up-left neighbour by the speckle rule: both
    valid and ``|d(p) - d(q)| <= diff_insame`` (`Sad.h:294`); a neighbour
    outside the image connects nothing."""
    h, w = d.shape
    dp = torch.nn.functional.pad(d[None], (1, 1, 1, 1), value=float("nan"))[0]
    vp = torch.nn.functional.pad(valid[None], (1, 1, 1, 1), value=False)[0]
    out = []
    for dy, dx in [(0, -1), (-1, 0), (-1, 1), (-1, -1)]:
        nd = dp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        nv = vp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        out.append(valid & nv & (torch.abs(d - nd) <= diff_insame))
    return tuple(out)


def remove_speckles(
    disp: torch.Tensor,
    diff_insame: float = 1.0,
    min_speckle_area: int = 80,
    invalid_value: float = INVALID,
    background: Optional[float] = None,
    max_iters: Optional[int] = None,
    connectivity: int = 8,
    block: Optional[int] = None,
) -> torch.Tensor:
    """Connected-component speckle filter (`SAD/Sad.h:251-315`; OpenCV
    ``filterSpeckles`` with ``connectivity=4``, `ASW/ASWeight.cpp:73`).

    Members are pixels ``!= invalid_value``; neighbors connect when their
    disparities differ by <= ``diff_insame``; components smaller than
    ``min_speckle_area`` become ``invalid_value``.

    ``block`` is the JAX package's two-level block labelling, an exact
    schedule of the same labelling: its labels are the single-level flood's
    at every block size, so this labelling serves every ``block``; 0 raises
    ``ValueError`` as it does there.

    ``background`` is the value the SAD variant skips as a BFS seed
    (`Sad.h:265` skips ``disp == 0``): background pixels join components
    and count toward the area, but a component holding only background
    pixels is never visited and survives.

    Only component areas reach the output, so any exact labelling gives the
    JAX result.  Here: every pixel starts labelled with its own flat index;
    each sweep takes the min label across every connected pair, hooks that
    min onto both old labels, and pointer-jumps once (``label[label]``).
    Labels always name a pixel of their own component and only decrease,
    so the loop stops at the fixpoint, where each component holds one
    label.  The loop checks for the fixpoint on the host once per sweep
    and stops after at most ``max_iters`` sweeps; ``None`` takes the JAX
    package's cap, ``32 + 8 * max(1, (h*w - 1).bit_length())``, which real
    maps (<= 20 sweeps) never reach.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if block == 0:
        raise ValueError("remove_speckles(block=0): a block has at least one row and column")
    h, w = disp.shape
    if max_iters is None:
        max_iters = 32 + 8 * max(1, (h * w - 1).bit_length())
    d = disp.to(torch.float32)
    valid = torch.isfinite(d) & (d != invalid_value)
    src, dst = _speckle_edges(d, valid, diff_insame, connectivity)

    labels = torch.arange(h * w, device=d.device)
    for _ in range(max_iters):
        ls, ld = labels[src], labels[dst]
        m = torch.minimum(ls, ld)
        new = labels.clone()
        for target in (src, dst, ls, ld):
            new.scatter_reduce_(0, target, m, "amin")
        new = new[new]
        if torch.equal(new, labels):
            break
        labels = new

    def per_label(members):
        return torch.bincount(labels[members.reshape(-1)], minlength=h * w)[labels].reshape(h, w)

    kill = valid & (per_label(valid) < min_speckle_area)
    if background is not None:
        kill &= per_label(valid & (d != background)) > 0
    return torch.where(kill, invalid_value, d)


def median_filter(
    x: torch.Tensor,
    size: int,
    border: str = "truncate",
    row_offset: int = 0,
    global_rows: Optional[int] = None,
) -> torch.Tensor:
    """Window median over the ``(2*(size//2)+1)^2`` window.

    ``border='truncate'``, the reference's own median
    (`PostProcessing.h:314-344`): only in-image values take part and the
    median is ``sorted[count // 2]``.  ``border='replicate'``, OpenCV
    ``medianBlur`` (`ASWeight.cpp:74,78`): the middle of the window values
    with replicated edges.

    ``row_offset`` / ``global_rows`` place ``x`` as a halo-extended row tile
    in an image of ``global_rows`` rows (the sharded post,
    ``parallel.post_shard``): a window row is in the image by its global
    row, so the tile's rows get the whole image's truncate-border medians
    where their windows lie in the tile.  Rows of the tile outside the image
    take no part.  The replicate border has no such form: a tile's edge is
    not the image's (the sharded ASW post re-points rows beyond the image
    itself), so it raises ``NotImplementedError`` there.
    """
    radius = size // 2
    side = 2 * radius + 1
    h, w = x.shape
    xf = x.to(torch.float32)
    placed = row_offset != 0 or global_rows is not None
    if global_rows is None:
        global_rows = h
    if border == "replicate" and placed:
        raise NotImplementedError(
            "median_filter(border='replicate') has no row-offset form; run it on "
            "halo-extended tiles and re-point rows beyond the image at the processed "
            "global edge (parallel.post_shard.asw_post_sharded)")
    if border == "replicate":
        xp = replicate_pad(xf, radius)
        stack = torch.stack(
            [xp[dy : dy + h, dx : dx + w] for dy in range(side) for dx in range(side)]
        )
        # odd count: the lower median is the middle element
        return stack.median(dim=0).values
    if border != "truncate":
        raise ValueError(f"unknown border {border!r}; expected 'truncate' or 'replicate'")
    # out-of-image entries are +inf and sort last; the in-image count
    # (inf entries of x included) picks the rank
    ri = torch.arange(h, device=x.device)[:, None] + row_offset
    if placed:
        xf = torch.where((ri >= 0) & (ri < global_rows), xf, float("inf"))
    xp = torch.nn.functional.pad(xf, (radius,) * 4, value=float("inf"))
    stack = torch.stack(
        [xp[dy : dy + h, dx : dx + w] for dy in range(side) for dx in range(side)]
    )
    ci = torch.arange(w, device=x.device)[None, :]
    rows_in = ((ri + radius).clamp(max=global_rows - 1) - (ri - radius).clamp(min=0)
               + 1).clamp(min=0)
    cols_in = (ci + radius).clamp(max=w - 1) - (ci - radius).clamp(min=0) + 1
    pick = ((rows_in * cols_in) // 2).clamp(0, side * side - 1)
    return stack.sort(dim=0).values.gather(0, pick[None]).squeeze(0)


# ---------------------------------------------------------------------------
# nearest-valid fills: FillImageNew (`ASW/ASW.h:434-511`) and 8-direction
# hole filling (`AD-CensusV1/PostProcessing.h:156-248`)
# ---------------------------------------------------------------------------


def _nearest_valid(d: torch.Tensor, valid: torch.Tensor, dim: int, after: bool):
    """(value, steps, found) of the nearest valid pixel strictly before
    (``after=False``) or after each pixel along ``dim``.  Where nothing is
    found the value is +inf and steps is the pixel's own position along
    ``dim``, as in the JAX package's doubling scan."""
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    pos = torch.arange(n, device=d.device).reshape(shape).expand_as(d)
    if after:
        nearest = torch.where(valid, pos, n).flip(dim).cummin(dim).values.flip(dim)
        nearest = torch.cat([nearest.narrow(dim, 1, n - 1), torch.full_like(nearest.narrow(dim, 0, 1), n)], dim)
        found = nearest < n
    else:
        nearest = torch.where(valid, pos, -1).cummax(dim).values
        nearest = torch.cat([torch.full_like(nearest.narrow(dim, 0, 1), -1), nearest.narrow(dim, 0, n - 1)], dim)
        found = nearest >= 0
    value = torch.gather(d, dim, nearest.clamp(0, n - 1))
    steps = torch.where(found, torch.abs(pos - nearest), pos)
    return torch.where(found, value, float("inf")), steps, found


def _shear_anti(x: torch.Tensor, fill) -> torch.Tensor:
    """``sheared[i, k] = x[i, k - i]``: anti-diagonals become columns (pad
    each row by H, flatten, re-view with row stride W + H - 1)."""
    h, w = x.shape
    xp = torch.cat([x, torch.full((h, h), fill, dtype=x.dtype, device=x.device)], dim=1)
    return xp.reshape(-1)[: h * (w + h - 1)].reshape(h, w + h - 1)


def _unshear_anti(s: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`_shear_anti`: ``out[i, j] = s[i, i + j]``."""
    flat = torch.cat([s.reshape(-1), s.new_zeros(h)])
    return flat.reshape(h, w + h)[:, :w]


def fill_image_new(disp: torch.Tensor) -> torch.Tensor:
    """`FillImageNew` (`ASW/ASW.h:434-511`): zero-valued pixels take the
    nearest non-zero value to the left, else the nearest to the right,
    else 0, all read from the pre-fill map."""
    d = disp.to(torch.float32)
    valid = d != 0
    lv, _, lf = _nearest_valid(d, valid, 1, after=False)
    rv, _, rf = _nearest_valid(d, valid, 1, after=True)
    return torch.where(valid, d, torch.where(lf, lv, torch.where(rf, rv, 0.0)))


def fill_image(disp: torch.Tensor) -> torch.Tensor:
    """`FillImage` (`SAD/Sad.h:403-480`): zero-valued pixels take the nearest
    non-zero value to the left, else 0."""
    d = disp.to(torch.float32)
    valid = d != 0
    lv, _, lf = _nearest_valid(d, valid, 1, after=False)
    return torch.where(valid, d, torch.where(lf, lv, 0.0))


def fill_image_second_times(disp: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """`FillImageSecondTimes` (`SAD/Sad.h:483-538`): pixels <= ``threshold``
    search rightward starting at themselves (`Sad.h:510`), so a non-zero
    pixel keeps its value and a zero pixel takes the nearest non-zero value
    to its right, else ``threshold``.  The reference's accumulating stride
    (`Sad.h:513`) is not reproduced, as in the JAX package."""
    d = disp.to(torch.float32)
    rv, _, rf = _nearest_valid(d, d != 0, 1, after=True)
    return torch.where(d == 0, torch.where(rf, rv, threshold), d)


def fill_image_last(disp: torch.Tensor) -> torch.Tensor:
    """`FillImageLast` (`SAD/Sad.h:621-698`, `ASW/ASW.h:514-591`): zero-valued
    pixels take the nearest non-zero value above, else below, else 0."""
    d = disp.to(torch.float32)
    valid = d != 0
    uv, _, uf = _nearest_valid(d, valid, 0, after=False)
    dv, _, df = _nearest_valid(d, valid, 0, after=True)
    return torch.where(valid, d, torch.where(uf, uv, torch.where(df, dv, 0.0)))


def directional_candidates(disp: torch.Tensor, valid: torch.Tensor):
    """First valid disparity along each of the 8 rays from every pixel
    (`SAD/Sad.h:359-378`, `PostProcessing.h:202-220`).

    Returns (values [8, H, W], +inf where the ray found nothing; steps
    [8, H, W] int32, pixel steps along the ray), rays in the JAX package's
    order: E, W, S, N, SE, NW, SW, NE.  Axis rays scan rows and columns;
    diagonal rays shear the image so each diagonal becomes a column, scan
    it, and unshear.
    """
    h, w = disp.shape
    d = disp.to(torch.float32)
    vals, steps = [], []
    for dim, after in ((1, True), (1, False), (0, True), (0, False)):
        v, s, _ = _nearest_valid(d, valid, dim, after)
        vals.append(v)
        steps.append(s)
    for anti in (False, True):
        dd, vv = (d, valid) if anti else (d.flip(1), valid.flip(1))
        ds, vs = _shear_anti(dd, 0.0), _shear_anti(vv, False)
        for after in (True, False):
            v, s, _ = _nearest_valid(ds, vs, 0, after)
            v, s = _unshear_anti(v, h, w), _unshear_anti(s, h, w)
            vals.append(v if anti else v.flip(1))
            steps.append(s if anti else s.flip(1))
    return torch.stack(vals), torch.stack(steps).to(torch.int32)


def _fill_from_candidates(disp, target, second_smallest: bool, max_axis_steps, max_diag_steps):
    """Fill ``target`` pixels from the 8-ray candidates: second-smallest
    for occlusions, median for mismatches (`PostProcessing.h:229-239`).
    Pixels whose rays found nothing keep their value."""
    cand, steps = directional_candidates(disp, torch.isfinite(disp))
    if max_axis_steps is not None:
        limit = torch.tensor([max_axis_steps] * 4 + [max_diag_steps] * 4, device=disp.device)
        cand = torch.where(steps <= limit.reshape(8, 1, 1), cand, float("inf"))
    cand = cand.sort(dim=0).values
    count = torch.isfinite(cand).sum(dim=0)
    if second_smallest:
        pick = (count > 1).long()
    else:
        pick = (count // 2).clamp(0, 7)
    chosen = cand.gather(0, pick[None]).squeeze(0)
    return torch.where(target & (count > 0), chosen, disp)


def fill_holes_8dir(
    disp: torch.Tensor,
    occlusion: torch.Tensor,
    mismatch: torch.Tensor,
    invalid_value: float = INVALID,
    max_search: Optional[int] = None,
) -> torch.Tensor:
    """8-direction hole filling (`AD-CensusV1/PostProcessing.h:156-248`).

    Three passes, each seeing the previous one's fills: occlusions take the
    second-smallest ray candidate, mismatches the median, then any pixel
    still invalid the median.  ``max_search`` caps the rays at
    ``max_search - 1`` axis steps and ``round(0.7071 * that)`` diagonal
    steps (`PostProcessing.h:169`); None leaves them unbounded.
    """
    max_axis = None if max_search is None else max(max_search - 1, 0)
    max_diag = None if max_search is None else int(round(max_axis * 0.70710678))
    d = torch.where(disp == invalid_value, float("inf"), disp.to(torch.float32))
    d = _fill_from_candidates(d, occlusion & ~torch.isfinite(d), True, max_axis, max_diag)
    d = _fill_from_candidates(d, mismatch & ~torch.isfinite(d), False, max_axis, max_diag)
    d = _fill_from_candidates(d, ~torch.isfinite(d), False, max_axis, max_diag)
    return torch.where(torch.isfinite(d), d, invalid_value)


# ---------------------------------------------------------------------------
# canonical AD-Census post components (the vendored `ADCensusOption`'s
# irv_ts / irv_th / do_discontinuity_adjustment, `CBLSM/adcensus_types.h:72-75`)
# ---------------------------------------------------------------------------


def iterative_region_voting(
    disp: torch.Tensor,
    arms,
    disp_range: int,
    ts: float = 20.0,
    th: float = 0.4,
    num_iters: int = 5,
    invalid_value: float = INVALID,
    max_arm: Optional[int] = None,
    d_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Canonical iterative region voting (`irv_ts` / `irv_th`,
    `adcensus_types.h:73`).

    Each iteration every valid pixel votes its rounded disparity into its
    cross support region (a horizontal arm span, then a vertical one, as in
    `aggregate.cross_aggregate`); an invalid pixel takes the plurality
    disparity where the region holds more than ``ts`` votes and the winning
    bin more than ``th`` of them.  Pixels filled in one iteration vote in
    the next.  ``arms`` is an `aggregate.Arms`.

    The votes are integer prefix sums of the one-hot slices, so every count
    is exact; ``d_chunk`` bounds memory to ``d_chunk`` slices at a time, and
    the strict ``>`` running argmax over ascending chunks keeps argmax's
    first-maximum rule, so chunked and monolithic results agree bit for bit.
    ``max_arm`` takes the JAX package's position (a TPU pick strategy there)
    and changes nothing.
    """
    d_chunk = disp_range if d_chunk is None else min(d_chunk, disp_range)

    def bin_votes(dint, ds):
        onehot = (dint[None] == ds[:, None, None]).to(torch.int32)
        return _vsum(_hsum(onehot, arms.left, arms.right), arms.up, arms.down)

    def histogram(dint):
        total = torch.zeros(dint.shape, dtype=torch.int32, device=dint.device)
        bestv = torch.full(dint.shape, -1, dtype=torch.int32, device=dint.device)
        best = torch.zeros(dint.shape, dtype=torch.int64, device=dint.device)
        for c0 in range(0, disp_range, d_chunk):
            ds = torch.arange(c0, c0 + d_chunk, device=dint.device, dtype=torch.float32)
            votes = bin_votes(dint, ds)
            cv, ci = votes.max(dim=0)
            upd = cv > bestv
            total += votes.sum(dim=0, dtype=torch.int32)
            bestv = torch.where(upd, cv, bestv)
            best = torch.where(upd, ci + c0, best)
        return total.to(torch.float32), bestv.to(torch.float32), best

    for _ in range(num_iters):
        valid = disp != invalid_value
        dint = torch.where(valid, torch.round(disp), -1.0)
        total, bestv, best = histogram(dint)
        fill = ~valid & (total > ts) & (bestv > th * total)
        disp = torch.where(fill, best.to(disp.dtype), disp)
    return disp


def discontinuity_adjustment(
    disp: torch.Tensor, cost_vol: torch.Tensor, invalid_value: float = INVALID
) -> torch.Tensor:
    """Canonical discontinuity adjustment (`do_discontinuity_adjustment`,
    `adcensus_types.h:74`; Mei et al. §V-D).

    Where a horizontal neighbour's disparity differs by more than 1, the
    pixel takes whichever of the two neighbours' disparities has the lower
    cost at this pixel in ``cost_vol`` [D, H, W] (the volume the disparities
    were selected from), if lower than its own.  Each cost is one gather
    along d at the clamped, rounded disparity: the value JAX's masked
    minimum picks.
    """
    d_n = cost_vol.shape[0]
    valid = disp != invalid_value
    left_n = torch.cat([disp[:, :1], disp[:, :-1]], dim=1)
    right_n = torch.cat([disp[:, 1:], disp[:, -1:]], dim=1)
    left_ok = valid & (left_n != invalid_value)
    right_ok = valid & (right_n != invalid_value)
    edge = (left_ok & (torch.abs(disp - left_n) > 1.0)) | (
        right_ok & (torch.abs(disp - right_n) > 1.0)
    )

    def cost_at(d, ok):
        idx = torch.round(d).clamp(0, d_n - 1).to(torch.int64)
        c = torch.gather(cost_vol, 0, idx[None]).squeeze(0)
        return torch.where(ok, c, float("inf"))

    c_self = cost_at(disp, valid)
    c_left = cost_at(left_n, left_ok)
    c_right = cost_at(right_n, right_ok)
    best = torch.where(c_left < c_self, left_n, disp)
    best_c = torch.minimum(c_left, c_self)
    best = torch.where(c_right < best_c, right_n, best)
    return torch.where(edge, best, disp)
