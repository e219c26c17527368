"""The plain reference of FULL (``aggregation='rect_mean'``) at frames whose
dense volumes do not fit on the card: ``cardbench.reference.ad_census``'s
arithmetic on bands of image rows, the same maps bit for bit.

The dense reference holds float64 summed-area tables of whole volumes
(13.3 GB a view at 1988x2880, D=290) beside several float32 volumes of
6.6 GB.  Here:

* each band of ``band_rows`` image rows takes its cost, arms and
  arm-rectangle mean from a window of rows around it: the rectangle reaches
  ``max_length`` rows beyond the band, and the cost of those rows reads
  the census window's half-height beyond them (``ad_census_volume`` of the
  padded rows, so a census signature near a band's edge is the whole
  image's); the arms of a band's rows come from the image rows within
  ``max_length`` of them, as far as any arm reaches;
* the rectangle sums come from a table of the window's rows whose first
  row is the whole image's table at the window's first row, carried from
  the band above: torch's cumulative sum along a dimension other than the
  last adds in order, so every entry is the dense table's, bit for bit;
* the right view's map is taken band by band; the left view's aggregated
  volume is kept whole for the scanline, whose horizontal passes are
  summed into one volume, whose top-down pass is kept, and whose bottom-up
  pass takes each row's sum ``(lr + rl) + (ud + du)`` and its minimum as
  it goes, so no fifth volume is held;
* the post chain runs on the whole maps, as the dense reference runs it.

Three volumes of the frame are held at once (19.9 GB at 1988x2880, D=290,
float32), and a band's working set (a few GB at 128 rows) beside them.
Departures from the dense reference: one aggregation pass only (the
configurations' ``agg_iters`` 1; more raise), and the rect-mean family
only.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from cardbench.reference import aggregate, post, scanline
from cardbench.reference.volume import ad_census_volume

BAND_ROWS = 128


def _bands(h: int, band_rows: int) -> Iterator[Tuple[int, int]]:
    for r0 in range(0, h, band_rows):
        yield r0, min(r0 + band_rows, h)


def _cost_rows(left, right, cfg: dict, d: int, view: str, w0: int, w1: int, dtype):
    """The ``view``'s cost of image rows ``w0..w1``, from the rows padded by
    the census window's half-height."""
    h = left.shape[0]
    c0, c1 = max(w0 - cfg["census_rows"] // 2, 0), min(w1 + cfg["census_rows"] // 2, h)
    vol = ad_census_volume(left[c0:c1], right[c0:c1], d, cfg["sigma_c"], cfg["sigma_s"],
                           cfg["census_rows"], cfg["census_cols"], view)
    return vol[:, w0 - c0:w1 - c0].to(dtype)


def _arms_rows(img, arms: dict, halo: int, r0: int, r1: int) -> aggregate.Arms:
    """The arms of image rows ``r0..r1``, from the rows within ``halo`` of them."""
    a0, a1 = max(r0 - halo, 0), min(r1 + halo, img.shape[0])
    return aggregate.Arms(*(x[r0 - a0:r1 - a0] for x in aggregate.cross_arms(img[a0:a1], arms)))


def _rect_mean_rows(win, arms: aggregate.Arms, carry, w0: int, r0: int, h: int):
    """``aggregate.rect_mean`` of image rows ``r0..r1`` from ``win``, the cost
    of rows ``w0..w1``, and ``carry``, the column sums of the rows above
    ``w0`` (``[D, W]`` float64).  Returns the mean and the cumulative
    table ``[D, w1 - w0 + 1, W]`` whose row ``k`` is the sum of the rows
    above ``w0 + k``."""
    d, _, w = win.shape
    table = torch.cat([carry[:, None], win.to(torch.float64).cumsum(-1)], 1).cumsum(-2)
    flat = torch.nn.functional.pad(table, (1, 0)).reshape(d, -1)
    ii = torch.arange(r0, r0 + arms.up.shape[0], device=win.device)[:, None]
    jj = torch.arange(w, device=win.device)[None, :]
    up, down, lft, rgt = (a.to(torch.int64) for a in (arms.up, arms.down, arms.left, arms.right))
    i0, i1 = (ii - up).clamp(0, h - 1), (ii + down).clamp(0, h - 1)
    j0, j1 = (jj - lft).clamp(0, w - 1), (jj + rgt).clamp(0, w - 1)
    count = (up + down + 1) * (lft + rgt + 1)

    def g(a, b):
        return flat.index_select(1, ((a - w0) * (w + 1) + b).reshape(-1))

    total = g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
    total = total.reshape(d, *up.shape).to(win.dtype)
    return total / count.clamp(min=1).to(win.dtype), table


def _aggregated_bands(left, right, cfg: dict, d: int, view: str, band_rows: int, dtype):
    """Each band's ``(r0, r1, aggregated volume)`` of the view, top to bottom."""
    h, w = left.shape
    reach = cfg["arms"]["max_length"]
    halo = max(reach, 2)                  # the arms' border test looks two rows out
    img = left if view == "left" else right
    carry = torch.zeros((d, w), dtype=torch.float64, device=left.device)
    for r0, r1 in _bands(h, band_rows):
        w0, w1 = max(r0 - reach, 0), min(r1 + reach, h)
        win = _cost_rows(left, right, cfg, d, view, w0, w1, dtype)
        mean, table = _rect_mean_rows(win, _arms_rows(img, cfg["arms"], halo, r0, r1), carry,
                                      w0, r0, h)
        carry = table[:, max(r1 - reach, 0) - w0].clone()
        del win, table
        yield r0, r1, mean


def _wta(vol: torch.Tensor) -> torch.Tensor:
    """The lowest-cost disparity (the first of equal ones), as float32."""
    return torch.argmin(vol, dim=0).to(torch.float32)


def _pass_steps(cost, grey, axis: int, reverse: bool, p1: float, p2_init: float,
                l2_uses_dm1: bool, p2_from_first: bool):
    """``(t, L[:, t])`` for each step of ``scanline._pass``'s pass, in its
    order and with its arithmetic."""
    n = cost.shape[axis + 1]
    order = range(n - 1, -1, -1) if reverse else range(n)
    p2_t = torch.tensor(p2_init, dtype=torch.float32, device=cost.device)
    prev = prev_min = g_ref = None
    for k, t in enumerate(order):
        c = cost.select(axis + 1, t)
        g = grey.select(axis, t).to(torch.float32)
        if k == 0:
            prev, prev_min, g_ref = c, c.amin(dim=0), g
        else:
            p2 = torch.clamp(torch.div(p2_t, torch.abs(g - g_ref) + 1.0), min=p1)
            prev, prev_min = scanline._step(prev, prev_min, c, p1, p2.to(cost.dtype), l2_uses_dm1)
            if not p2_from_first:
                g_ref = g
        yield t, prev


def _scanline_wta(agg, grey, sc: dict) -> torch.Tensor:
    """``_wta(scanline.scanline_optimize(agg, grey, sc))``, holding two more
    volumes than ``agg``, not five."""
    p1, p2 = scanline.effective_penalties(sc, agg.shape[0])
    dm1 = not sc.get("faithful_vertical_l2", False)
    first = bool(sc.get("faithful_vertical_p2", False))
    horiz = torch.empty_like(agg)
    for t, lr in _pass_steps(agg, grey, 1, False, p1, p2, True, False):
        horiz.select(2, t).copy_(lr)
    for t, rl in _pass_steps(agg, grey, 1, True, p1, p2, True, False):
        horiz.select(2, t).add_(rl)
    ud = torch.empty_like(agg)
    for t, v in _pass_steps(agg, grey, 0, False, p1, p2, dm1, first):
        ud.select(1, t).copy_(v)
    disp = torch.empty(agg.shape[1:], dtype=torch.float32, device=agg.device)
    for t, du in _pass_steps(agg, grey, 0, True, p1, p2, dm1, first):
        disp[t] = _wta(horiz.select(1, t) + (ud.select(1, t) + du))
    return disp


def disparity(left: torch.Tensor, right: torch.Tensor, cfg: dict, disp_range: int,
              dtype: torch.dtype = torch.float32, band_rows: int = BAND_ROWS) -> torch.Tensor:
    """``disp_final`` of the grey uint8 pair ``left``, ``right`` ``[H, W]``
    under ``cfg`` (the configuration's ``ad_census`` fields, the rect-mean
    family), computed in bands of ``band_rows`` image rows: the dense
    reference's map, ``cardbench.reference.ad_census.disparity``."""
    if cfg["aggregation"] != "rect_mean" or cfg["agg_iters"] != 1:
        raise ValueError(f"the banded reference takes one rect_mean pass, got "
                         f"{cfg['aggregation']!r} x {cfg['agg_iters']}")
    d = disp_range
    h, w = left.shape
    disp_r = torch.empty((h, w), dtype=torch.float32, device=left.device)
    for r0, r1, mean in _aggregated_bands(left, right, cfg, d, "right", band_rows, dtype):
        disp_r[r0:r1] = _wta(mean)
    agg = torch.empty((d, h, w), dtype=dtype, device=left.device)
    for r0, r1, mean in _aggregated_bands(left, right, cfg, d, "left", band_rows, dtype):
        agg[:, r0:r1] = mean
    del mean
    if cfg.get("scanline") is not None:
        disp_l = _scanline_wta(agg, left, cfg["scanline"])
    else:
        disp_l = _wta(agg)
    del agg
    if not cfg["run_post"]:
        return disp_l
    disp, occl, mism = post.lr_check(disp_l, disp_r, cfg["lr_gate"])
    disp = post.remove_speckles(disp, cfg["speckle_diff"], cfg["speckle_area"])
    disp = post.fill_holes_8dir(disp, occl, mism, d)
    return post.median_truncate(disp, cfg["median_size"])
