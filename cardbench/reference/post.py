"""The post chains of both AD-Census families in plain PyTorch: the LR check
(`AD-CensusV1/PostProcessing.h:72-135`), the speckle filter
(`SAD/Sad.h:251-315`), the 8-direction hole fill
(`PostProcessing.h:156-248`), the truncate-border median
(`PostProcessing.h:314-344`), and the canonical family's iterative region
voting and discontinuity adjustment (`CBLSM/adcensus_types.h:72-75`).

Invalid pixels are +inf.
"""

from __future__ import annotations

import torch

from cardbench.reference.aggregate import hsum, vsum

INVALID = float("inf")


def lr_check(disp_left, disp_right, gate: float):
    """``(disp, occlusion, mismatch)`` of the rounded LR check: the right
    view is read at ``int(j - dL + 0.5)``; ``|dL - dR| > gate`` invalidates
    the pixel, an occlusion where the reprojected left disparity is larger,
    else a mismatch; pixels already invalid or matched out of the image are
    mismatches."""
    h, w = disp_left.shape
    dl = disp_left.to(torch.float32)
    drf = disp_right.to(torch.float32)
    already = ~torch.isfinite(dl) | (dl == INVALID)
    jj = torch.arange(w, device=dl.device, dtype=torch.float32)[None, :]
    col_right = torch.trunc(jj - dl + 0.5).to(torch.int32)
    in_range = (col_right >= 0) & (col_right < w)
    dr = torch.gather(drf, 1, col_right.clamp(0, w - 1).long())
    bad = in_range & (torch.abs(dl - dr) > gate)
    col_rl = torch.trunc(col_right.to(torch.float32) + dr + 0.5).to(torch.int32)
    rl_in = (col_rl > 0) & (col_rl < w)
    dl_rl = torch.gather(dl, 1, col_rl.clamp(0, w - 1).long())
    occl = bad & rl_in & (dl_rl > dl)
    mism = (bad & ~occl) | ~in_range | already
    invalid = (bad | ~in_range) & ~already
    return torch.where(invalid, INVALID, dl), occl & ~already, mism


def remove_speckles(disp, diff: float, min_area: int):
    """Pixels of 8-connected components (neighbours within ``diff`` of each
    other, both valid) smaller than ``min_area`` become invalid.  Labels
    start as each pixel's index; each sweep hooks the smaller label of
    every connected pair onto both and jumps once, to the fixpoint."""
    h, w = disp.shape
    d = disp.to(torch.float32)
    valid = torch.isfinite(d)
    idx = torch.arange(h * w, device=d.device).reshape(h, w)
    src, dst = [], []
    for dy, dx in ((0, -1), (-1, 0), (-1, 1), (-1, -1)):
        r0, r1 = max(0, -dy), h - max(0, dy)
        c0, c1 = max(0, -dx), w - max(0, dx)
        p = (slice(r0, r1), slice(c0, c1))
        q = (slice(r0 + dy, r1 + dy), slice(c0 + dx, c1 + dx))
        m = valid[p] & valid[q] & (torch.abs(d[p] - d[q]) <= diff)
        src.append(idx[p][m])
        dst.append(idx[q][m])
    src, dst = torch.cat(src), torch.cat(dst)
    labels = torch.arange(h * w, device=d.device)
    while True:
        ls, ld = labels[src], labels[dst]
        m = torch.minimum(ls, ld)
        new = labels.clone()
        for target in (src, dst, ls, ld):
            new.scatter_reduce_(0, target, m, "amin")
        new = new[new]
        if torch.equal(new, labels):
            break
        labels = new
    area = torch.bincount(labels[valid.reshape(-1)], minlength=h * w)[labels].reshape(h, w)
    return torch.where(valid & (area < min_area), INVALID, d)


def median_truncate(x, size: int):
    """The median of the in-image values of each ``size x size`` window,
    ``sorted[count // 2]`` (invalid values take part and sort last)."""
    radius = size // 2
    side = 2 * radius + 1
    h, w = x.shape
    xp = torch.nn.functional.pad(x.to(torch.float32), (radius,) * 4, value=float("inf"))
    stack = torch.stack([xp[dy:dy + h, dx:dx + w] for dy in range(side) for dx in range(side)])
    ri = torch.arange(h, device=x.device)[:, None]
    ci = torch.arange(w, device=x.device)[None, :]
    rows_in = (ri + radius).clamp(max=h - 1) - (ri - radius).clamp(min=0) + 1
    cols_in = (ci + radius).clamp(max=w - 1) - (ci - radius).clamp(min=0) + 1
    pick = ((rows_in * cols_in) // 2).clamp(0, side * side - 1)
    return stack.sort(dim=0).values.gather(0, pick[None]).squeeze(0)


def _nearest_valid(d, valid, dim: int, after: bool):
    """``(value, steps)`` of the nearest valid pixel strictly after (or
    before) each pixel along ``dim``: +inf and the pixel's own position
    where there is none."""
    n = d.shape[dim]
    shape = [1] * d.dim()
    shape[dim] = n
    pos = torch.arange(n, device=d.device).reshape(shape).expand_as(d)
    if after:
        near = torch.where(valid, pos, n).flip(dim).cummin(dim).values.flip(dim)
        near = torch.cat([near.narrow(dim, 1, n - 1), torch.full_like(near.narrow(dim, 0, 1), n)], dim)
        found = near < n
    else:
        near = torch.where(valid, pos, -1).cummax(dim).values
        near = torch.cat([torch.full_like(near.narrow(dim, 0, 1), -1), near.narrow(dim, 0, n - 1)], dim)
        found = near >= 0
    value = torch.gather(d, dim, near.clamp(0, n - 1))
    steps = torch.where(found, torch.abs(pos - near), pos)
    return torch.where(found, value, float("inf")), steps


def _shear(x, fill):
    """``out[i, k] = x[i, k - i]``: anti-diagonals become columns."""
    h, w = x.shape
    xp = torch.cat([x, torch.full((h, h), fill, dtype=x.dtype, device=x.device)], dim=1)
    return xp.reshape(-1)[: h * (w + h - 1)].reshape(h, w + h - 1)


def _unshear(s, h: int, w: int):
    """The inverse of :func:`_shear`."""
    flat = torch.cat([s.reshape(-1), s.new_zeros(h)])
    return flat.reshape(h, w + h)[:, :w]


def _ray_candidates(d, valid):
    """The first valid value along each of the 8 rays from every pixel and
    its distance in steps, ``[8, H, W]`` each: E, W, S, N, then the
    diagonals (rows sheared so that a diagonal is a column)."""
    h, w = d.shape
    vals, steps = [], []
    for dim, after in ((1, True), (1, False), (0, True), (0, False)):
        v, s = _nearest_valid(d, valid, dim, after)
        vals.append(v)
        steps.append(s)
    for anti in (False, True):
        dd, vv = (d, valid) if anti else (d.flip(1), valid.flip(1))
        ds, vs = _shear(dd, 0.0), _shear(vv, False)
        for after in (True, False):
            v, s = _nearest_valid(ds, vs, 0, after)
            v, s = _unshear(v, h, w), _unshear(s, h, w)
            vals.append(v if anti else v.flip(1))
            steps.append(s if anti else s.flip(1))
    return torch.stack(vals), torch.stack(steps)


def _fill_pass(d, target, second_smallest: bool, max_axis: int, max_diag: int):
    """Fill ``target`` pixels from their rays' candidates within the caps:
    the second smallest (occlusions) or the median; a pixel whose rays find
    nothing keeps its value."""
    cand, steps = _ray_candidates(d, torch.isfinite(d))
    limit = torch.tensor([max_axis] * 4 + [max_diag] * 4, device=d.device).reshape(8, 1, 1)
    cand = torch.where(steps <= limit, cand, float("inf")).sort(dim=0).values
    count = torch.isfinite(cand).sum(dim=0)
    pick = (count > 1).long() if second_smallest else (count // 2).clamp(0, 7)
    chosen = cand.gather(0, pick[None]).squeeze(0)
    return torch.where(target & (count > 0), chosen, d)


def fill_holes_8dir(disp, occlusion, mismatch, max_search: int):
    """Three passes, each seeing the last one's fills: occlusions take the
    second smallest ray candidate, mismatches the median, then every pixel
    still invalid the median; rays reach ``max_search - 1`` axis steps and
    ``round(0.70710678 * that)`` diagonal steps."""
    max_axis = max(max_search - 1, 0)
    max_diag = int(round(max_axis * 0.70710678))
    d = disp.to(torch.float32)
    d = _fill_pass(d, occlusion & ~torch.isfinite(d), True, max_axis, max_diag)
    d = _fill_pass(d, mismatch & ~torch.isfinite(d), False, max_axis, max_diag)
    return _fill_pass(d, ~torch.isfinite(d), False, max_axis, max_diag)


def region_voting(disp, arms, disp_range: int, ts: float, th: float, num_iters: int = 5):
    """Iterative region voting: each valid pixel votes its rounded
    disparity over its cross region (horizontal spans, then vertical); an
    invalid pixel takes the winning bin where the region holds more than
    ``ts`` votes and the bin more than ``th`` of them; five iterations,
    fills of one voting in the next."""
    for _ in range(num_iters):
        valid = disp != INVALID
        dint = torch.where(valid, torch.round(disp), -1.0)
        ds = torch.arange(disp_range, device=disp.device, dtype=torch.float32)
        onehot = (dint[None] == ds[:, None, None]).to(torch.int32)
        votes = vsum(hsum(onehot, arms.left, arms.right), arms.up, arms.down)
        total = votes.sum(dim=0, dtype=torch.int32).to(torch.float32)
        bestv, best = votes.max(dim=0)
        fill = ~valid & (total > ts) & (bestv.to(torch.float32) > th * total)
        disp = torch.where(fill, best.to(disp.dtype), disp)
    return disp


def discontinuity_adjustment(disp, cost_vol):
    """At a horizontal edge (a valid neighbour more than 1 away) a pixel takes
    whichever neighbour's disparity costs less here, if less than its own."""
    d_n = cost_vol.shape[0]
    valid = disp != INVALID
    left_n = torch.cat([disp[:, :1], disp[:, :-1]], dim=1)
    right_n = torch.cat([disp[:, 1:], disp[:, -1:]], dim=1)
    left_ok = valid & (left_n != INVALID)
    right_ok = valid & (right_n != INVALID)
    edge = (left_ok & (torch.abs(disp - left_n) > 1.0)) | (right_ok & (torch.abs(disp - right_n) > 1.0))

    def cost_at(d, ok):
        i = torch.round(d).clamp(0, d_n - 1).to(torch.int64)
        return torch.where(ok, torch.gather(cost_vol, 0, i[None]).squeeze(0), float("inf"))

    c_self, c_left, c_right = cost_at(disp, valid), cost_at(left_n, left_ok), cost_at(right_n, right_ok)
    best = torch.where(c_left < c_self, left_n, disp)
    best = torch.where(c_right < torch.minimum(c_left, c_self), right_n, best)
    return torch.where(edge, best, disp)
