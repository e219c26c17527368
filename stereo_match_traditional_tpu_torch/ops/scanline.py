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
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import ScanlineConfig


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
