"""4-path scanline (SGM-style) cost optimization (torch counterpart of
``stereo_match_traditional_tpu.ops.scanline``).

The recurrence (`AD-CensusV1/ScanlineOptimizer.h:173-183`):

    L(p, d) = C(p, d) + min(L(p-1, d),
                            L(p-1, d-1) + P1,
                            L(p-1, d+1) + P1,
                            min_d' L(p-1, d') + P2) - min_d' L(p-1, d')
    P2 = max(P1, P2_init / (|I(p) - I(p-1)| + 1))        (:171,232)

with +inf pads at d = -1 and d = D.  ``scanline_optimize`` here is the
plain version of the CUDA kernel (`ops.kernels.scanline_cuda`): a Python
loop over the path steps of each of the four passes, every line of the
perpendicular axis in one ``[D, M]`` step, in the JAX package's float
order, so the two agree bit for bit.

``scanline_optimize_canonical`` is the canonical AD-Census form of the same
recurrence (penalties scaled per step, disparity and line by the colour
differences along the path in both images), the plain version of
`ops.kernels.scanline_canonical_cuda`.

``directional_pass_banded`` and ``canonical_pass_banded`` continue one pass
of either family over a band of path steps from a carry handed over by the
neighbouring band (the streamed executor, ``parallel.streamed``): the plain
versions of `ops.kernels.scanline_banded_cuda`.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import ScanlineConfig
from stereo_match_traditional_tpu_torch.ops.volume import shifted_stack


def _step(prev, prev_min, c, p2_col, p1: float, l2_uses_dm1: bool):
    """One min-plus step on ``[D, M]``; returns ``(out, min_d out)``.
    ``l2_uses_dm1=False`` is the reference's vertical quirk: ``l2`` reads
    ``costLastPath[d+1]`` (`ScanlineOptimizer.h:238`), i.e. ``prev[d]``."""
    inf_row = torch.full_like(prev[:1], float("inf"))
    l1 = prev
    if l2_uses_dm1:
        l2 = torch.cat([inf_row, prev[:-1]]) + p1
    else:
        l2 = prev + p1
    l3 = torch.cat([prev[1:], inf_row]) + p1
    l4 = (prev_min + p2_col)[None]
    out = c + torch.minimum(torch.minimum(l1, l2), torch.minimum(l3, l4)) - prev_min[None]
    return out, out.amin(dim=0)


def _reset_steps(reset) -> set:
    """The steps at which a banded pass restarts its path: from a ``[T]``
    bool tensor, one step index, or None for none."""
    if reset is None:
        return set()
    if isinstance(reset, int):
        return {reset}
    return set(torch.nonzero(reset).flatten().tolist())


def _banded(step, cost, pen, carry, reset):
    """Drive ``step(prev, prev_min, cost[t], pen[t])`` over every step of
    ``cost`` [T, D, M] from ``carry``; the carry is zero where ``reset``
    restarts the path.  Returns (aggregated [T, D, M], outgoing carry)."""
    prev, prev_min = carry
    resets = _reset_steps(reset)
    out = torch.empty_like(cost)
    for t in range(cost.shape[0]):
        if t in resets:
            prev, prev_min = torch.zeros_like(prev), torch.zeros_like(prev_min)
        prev, prev_min = step(prev, prev_min, cost[t], pen[t])
        out[t] = prev
    return out, (prev, prev_min)


def directional_pass_banded(
    cost: torch.Tensor,
    p2: torch.Tensor,
    carry,
    reset,
    p1: float,
    l2_uses_dm1: bool = True,
    unroll: int = 4,
):
    """Band continuation of one directional pass: ``cost`` [T, D, M] (T the
    band's path steps, M the lines), ``p2`` [T, M] the penalty of each step,
    already evaluated against the grey neighbour the step consumes, and
    ``carry`` ``(prev [D, M], prev_min [M])`` from the neighbouring band.  A
    zero carry is the exact path seed: ``min(l1..l4) == prev_min == 0``, so
    the first step gives ``cost`` bit for bit, the value the whole pass
    gives its path's first pixel.  ``reset`` ([T] bool, one step index, or
    None) marks steps where the path restarts mid-band (the image's true
    last row when its rows were padded to whole bands): the carry is zero
    there.  Returns (aggregated [T, D, M], outgoing carry).  ``unroll`` takes
    the JAX package's position; a loop has nothing to unroll.

    The plain version of ``ops.kernels.scanline_banded_cuda.
    directional_pass_banded_cuda``."""

    def step(prev, prev_min, c, p2_col):
        return _step(prev, prev_min, c, p2_col, p1, l2_uses_dm1)

    return _banded(step, cost, p2, carry, reset)


def _directional_pass(
    cost: torch.Tensor,
    gray: torch.Tensor,
    axis: int,
    reverse: bool,
    p1: float,
    p2_init: float,
    l2_uses_dm1: bool = True,
    p2_ref: str = "prev",
) -> torch.Tensor:
    """One directional pass over ``cost`` [D, H, W] along image ``axis``
    (1: rows are the lines, 0: columns are), backwards when ``reverse``.

    ``p2_ref='first'`` is the reference's vertical quirk: ScanLineUpDown
    sets grayLast once at the path start and never updates it
    (`ScanlineOptimizer.h:210,232`), so P2 adapts to |I(p) - I(first)|.
    """
    n = cost.shape[axis + 1]
    order = range(n - 1, -1, -1) if reverse else range(n)
    p2_t = gray.new_tensor(p2_init, dtype=torch.float32)
    out = torch.empty_like(cost)
    prev = prev_min = g_ref = None
    for k, t in enumerate(order):
        c = cost.select(axis + 1, t)                       # [D, M]
        g = gray.select(axis, t).to(torch.float32)         # [M]
        if k == 0:
            prev, prev_min, g_ref = c, c.amin(dim=0), g
        else:
            # a true division, as in the JAX package (``scalar / tensor``
            # in torch multiplies by a reciprocal)
            p2 = torch.clamp(torch.div(p2_t, torch.abs(g - g_ref) + 1.0), min=p1)
            prev, prev_min = _step(prev, prev_min, c, p2, p1, l2_uses_dm1)
            if p2_ref == "prev":
                g_ref = g
        out.select(axis + 1, t).copy_(prev)
    return out


def scanline_optimize(
    cost: torch.Tensor, gray: torch.Tensor, cfg: ScanlineConfig = ScanlineConfig()
) -> torch.Tensor:
    """Sum of the four directional volumes (`ScanlineOptimizer.h:104-128`),
    ``(left-right + right-left) + (up-down + down-up)``.

    cost: [D, H, W]; gray: [H, W] (the left image drives the adaptive P2,
    `AD-CensusV1/main.cpp:88`).
    """
    p1, p2 = cfg.effective_penalties(cost.shape[0])
    vert_dm1 = not cfg.faithful_vertical_l2
    vert_p2 = "first" if cfg.faithful_vertical_p2 else "prev"
    lr = _directional_pass(cost, gray, 1, False, p1, p2)
    rl = _directional_pass(cost, gray, 1, True, p1, p2)
    ud = _directional_pass(cost, gray, 0, False, p1, p2, vert_dm1, vert_p2)
    du = _directional_pass(cost, gray, 0, True, p1, p2, vert_dm1, vert_p2)
    return (lr + rl) + (ud + du)


def canonical_scale(g1_cur, g1_prev, g2_cur, g2_prev, tso: float) -> torch.Tensor:
    """The canonical tso penalty scale per (path step, d, line): from
    D1 = |g1(p) - g1(p-r)| (base image, ``[N, M]``) and
    D2 = |g2(p, d) - g2(p-r, d)| (match image at the match column,
    ``[N, D, M]``), 1.0 where neither reaches ``tso``, 0.25 where one does
    and 0.1 (float32) where both do (Mei et al.; the vendored
    ``ADCensusOption``'s ``so_tso``, `CBLSM/adcensus_types.h:72`)."""
    over1 = (torch.abs(g1_cur - g1_prev) >= tso)[..., None, :]
    over2 = torch.abs(g2_cur - g2_prev) >= tso
    return torch.where(over1 & over2, 0.1, torch.where(over1 | over2, 0.25, 1.0))


def _make_canonical_step(p1_base: float, p2_base: float):
    """The canonical min-plus step ``(prev, prev_min, cost_t, scale_t) ->
    (out, min_d out)`` on ``[D, M]``, with penalties ``p1_base * scale`` and
    ``p2_base * scale`` per (d, line), in the JAX package's float order."""

    def step(prev, prev_min, c, sc):
        p1c = p1_base * sc
        p2c = p2_base * sc
        inf_row = torch.full_like(prev[..., :1, :], float("inf"))
        l1 = prev
        l2 = torch.cat([inf_row, prev[..., :-1, :]], dim=-2) + p1c
        l3 = torch.cat([prev[..., 1:, :], inf_row], dim=-2) + p1c
        l4 = prev_min[..., None, :] + p2c
        out = (c + torch.minimum(torch.minimum(l1, l2), torch.minimum(l3, l4))
               - prev_min[..., None, :])
        return out, out.amin(dim=-2)

    return step


def canonical_pass_banded(
    cost: torch.Tensor,
    scale: torch.Tensor,
    carry,
    reset,
    p1_base: float,
    p2_base: float,
    unroll: int = 4,
):
    """Band continuation of one canonical directional pass, the tso-scheduled
    analogue of :func:`directional_pass_banded`: ``scale`` [T, D, M] is the
    penalty scale of :func:`canonical_scale`, already evaluated against the
    neighbour each step consumes; ``carry``, ``reset`` and the result as
    there (a zero carry is the exact path seed).

    The plain version of ``ops.kernels.scanline_banded_cuda.
    canonical_pass_banded_cuda``."""
    return _banded(_make_canonical_step(p1_base, p2_base), cost, scale, carry, reset)


def _canonical_pass(cost, g1, g2, p1_base: float, p2_base: float, tso: float) -> torch.Tensor:
    """One directional pass with the canonical penalty schedule.

    cost: ``[N, D, M]`` (N the path axis); g1: ``[N, M]`` the base image
    along the path; g2: ``[N, D, M]`` the match image at the match column.
    The first step's neighbour is the pixel itself (its scale is unused).
    """
    scale = canonical_scale(g1, torch.cat([g1[:1], g1[:-1]]),
                            g2, torch.cat([g2[:1], g2[:-1]]), tso)
    step = _make_canonical_step(p1_base, p2_base)
    out = torch.empty_like(cost)
    prev = cost[0]
    prev_min = prev.amin(dim=-2)
    out[0] = prev
    for t in range(1, cost.shape[0]):
        prev, prev_min = step(prev, prev_min, cost[t], scale[t])
        out[t] = prev
    return out


def scanline_optimize_canonical(
    cost: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    p1: float = 1.0,
    p2: float = 3.0,
    tso: float = 15.0,
    view: str = "left",
) -> torch.Tensor:
    """Canonical AD-Census 4-path scanline optimizer of one view's volume
    ``cost`` [D, H, W]: the four directional passes of
    :func:`_canonical_pass`, averaged, ``((lr + rl) + (ud + du)) * 0.25``.

    The base image is the view's own gray image, the match image the other
    one, read at column ``x - d`` (left view) or ``x + d`` (right view),
    clamped to the image, as :func:`volume.shifted_stack` builds it.
    """
    d = cost.shape[0]
    base = (left if view == "left" else right).to(torch.float32)
    match = (right if view == "left" else left).to(torch.float32)
    g2 = shifted_stack(match, d, view)                 # [D, H, W]

    def both_ways(c, g1, g2_):
        fwd = _canonical_pass(c, g1, g2_, p1, p2, tso)
        rev = _canonical_pass(c.flip(0), g1.flip(0), g2_.flip(0), p1, p2, tso)
        return fwd + rev.flip(0)

    horiz = both_ways(cost.permute(2, 0, 1), base.T, g2.permute(2, 0, 1))   # [W, D, H]
    vert = both_ways(cost.permute(1, 0, 2), base, g2.permute(1, 0, 2))      # [H, D, W]
    return (horiz.permute(1, 2, 0) + vert.permute(1, 0, 2)) * 0.25
