"""The 4-path scanline optimisation, in plain PyTorch: a Python loop over the
steps of each path, every line of the perpendicular axis in one ``[D, M]``
step.

The reference's form (`AD-CensusV1/ScanlineOptimizer.h:104-253`):

    L(p, d) = C(p, d) + min(L(p-1, d), L(p-1, d-1) + P1, L(p-1, d+1) + P1,
                            min_d' L(p-1, d') + P2) - min_d' L(p-1, d')
    P2 = max(P1, P2_init / (|I(p) - I(p-1)| + 1))

with +inf beyond the disparity range; the four paths are summed.  The
canonical form (Mei et al.; `CBLSM/adcensus_types.h:72`) scales both
penalties per step, disparity and line by the colour differences along the
path in the view's own image and in the other one at the match column, and
averages the four paths.

Every step runs in the cost's dtype.
"""

from __future__ import annotations

import torch

from cardbench.reference.volume import shifted_stack


def _step(prev, prev_min, c, p1, p2, l2_uses_dm1: bool):
    """One min-plus step on ``[D, M]``; ``p1`` and ``p2`` broadcast against
    it.  Returns ``(out, min over d of out)``."""
    inf_row = torch.full_like(prev[:1], float("inf"))
    l2 = (torch.cat([inf_row, prev[:-1]]) if l2_uses_dm1 else prev) + p1
    l3 = torch.cat([prev[1:], inf_row]) + p1
    l4 = prev_min[None] + p2
    out = c + torch.minimum(torch.minimum(prev, l2), torch.minimum(l3, l4)) - prev_min[None]
    return out, out.amin(dim=0)


def _pass(cost, grey, axis: int, reverse: bool, p1: float, p2_init: float,
          l2_uses_dm1: bool, p2_from_first: bool) -> torch.Tensor:
    """One directional pass of ``cost`` ``[D, H, W]`` along image ``axis``
    (1: the rows are the lines; 0: the columns), backwards when ``reverse``.
    ``p2_from_first`` takes P2 against the path's first pixel (the
    reference's vertical quirk, ``faithful_vertical_p2``)."""
    n = cost.shape[axis + 1]
    order = range(n - 1, -1, -1) if reverse else range(n)
    p2_t = torch.tensor(p2_init, dtype=torch.float32, device=cost.device)
    out = torch.empty_like(cost)
    prev = prev_min = g_ref = None
    for k, t in enumerate(order):
        c = cost.select(axis + 1, t)
        g = grey.select(axis, t).to(torch.float32)
        if k == 0:
            prev, prev_min, g_ref = c, c.amin(dim=0), g
        else:
            # a true division by a tensor, as the pipeline takes it
            p2 = torch.clamp(torch.div(p2_t, torch.abs(g - g_ref) + 1.0), min=p1)
            prev, prev_min = _step(prev, prev_min, c, p1, p2.to(cost.dtype), l2_uses_dm1)
            if not p2_from_first:
                g_ref = g
        out.select(axis + 1, t).copy_(prev)
    return out


def effective_penalties(sc: dict, disp_range: int):
    """``(P1, P2)`` after the configuration's ``penalty_scale`` (None: the
    reference's; ``'auto'``: times ``60 / disp_range``; a number: times it)."""
    scale = sc.get("penalty_scale")
    if scale is None:
        factor = 1.0
    elif scale == "auto":
        factor = 60.0 / float(disp_range)
    else:
        factor = float(scale)
    return sc["p1"] * factor, sc["p2"] * factor


def scanline_optimize(cost: torch.Tensor, grey: torch.Tensor, sc: dict) -> torch.Tensor:
    """``(left-right + right-left) + (up-down + down-up)`` of ``cost``
    ``[D, H, W]``, P2 adapting to ``grey`` (the left image,
    `AD-CensusV1/main.cpp:88`); ``sc`` is the configuration's ``scanline``."""
    p1, p2 = effective_penalties(sc, cost.shape[0])
    dm1 = not sc.get("faithful_vertical_l2", False)
    first = bool(sc.get("faithful_vertical_p2", False))
    lr = _pass(cost, grey, 1, False, p1, p2, True, False)
    rl = _pass(cost, grey, 1, True, p1, p2, True, False)
    ud = _pass(cost, grey, 0, False, p1, p2, dm1, first)
    du = _pass(cost, grey, 0, True, p1, p2, dm1, first)
    return (lr + rl) + (ud + du)


def _canonical_scale(g1_cur, g1_prev, g2_cur, g2_prev, tso: float) -> torch.Tensor:
    """1.0 where neither colour difference reaches ``tso``, 0.25 where one
    does, 0.1 where both do; ``g1`` ``[N, M]``, ``g2`` ``[N, D, M]``."""
    over1 = (torch.abs(g1_cur - g1_prev) >= tso)[..., None, :]
    over2 = torch.abs(g2_cur - g2_prev) >= tso
    return torch.where(over1 & over2, 0.1, torch.where(over1 | over2, 0.25, 1.0))


def _canonical_pass(cost, g1, g2, p1: float, p2: float, tso: float) -> torch.Tensor:
    """One canonical pass along axis 0 of ``cost`` ``[N, D, M]``; ``g1``
    ``[N, M]`` the base image and ``g2`` ``[N, D, M]`` the match image at
    the match column along the path."""
    scale = _canonical_scale(g1, torch.cat([g1[:1], g1[:-1]]),
                             g2, torch.cat([g2[:1], g2[:-1]]), tso).to(cost.dtype)
    out = torch.empty_like(cost)
    prev = cost[0]
    prev_min = prev.amin(dim=-2)
    out[0] = prev
    for t in range(1, cost.shape[0]):
        sc = scale[t]
        prev, prev_min = _step(prev, prev_min, cost[t], p1 * sc, p2 * sc, True)
        out[t] = prev
    return out


def scanline_optimize_canonical(cost, left, right, p1: float, p2: float, tso: float,
                                view: str) -> torch.Tensor:
    """``((lr + rl) + (ud + du)) * 0.25`` of one view's ``cost`` ``[D, H,
    W]``: the base image is the view's own, the match image the other one
    read at column ``x - d`` (left view) or ``x + d`` (right view), clamped."""
    d = cost.shape[0]
    base = (left if view == "left" else right).to(torch.float32)
    match = (right if view == "left" else left).to(torch.float32)
    g2 = shifted_stack(match, d, view)

    def both_ways(c, g1, g2_):
        fwd = _canonical_pass(c, g1, g2_, p1, p2, tso)
        rev = _canonical_pass(c.flip(0), g1.flip(0), g2_.flip(0), p1, p2, tso)
        return fwd + rev.flip(0)

    horiz = both_ways(cost.permute(2, 0, 1), base.T, g2.permute(2, 0, 1))
    vert = both_ways(cost.permute(1, 0, 2), base, g2.permute(1, 0, 2))
    return (horiz.permute(1, 2, 0) + vert.permute(1, 0, 2)) * 0.25
