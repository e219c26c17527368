"""Disparity-sharded WTA (torch counterpart of
``stereo_match_traditional_tpu.parallel.wta_shard``).

When the ``[D, H, W]`` cost volume is sharded over its disparity axis, WTA
is a two-stage reduction: a local argmin a shard, then a MIN all-reduce
over the mesh axis.  Ties resolve to the lowest global disparity, as the
strict ``<`` of every reference WTA loop does (`SAD/Sad.h:22-38`,
`AD-Census.h:346-380`, `CBLSM.h:383-407`).
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.parallel import comm

_BIG_IDX = 2**30


def wta_sharded(vol_local: torch.Tensor, axis_name, mode: str = "min") -> torch.Tensor:
    """WTA over a D-sharded volume: ``vol_local`` is this rank's
    ``[D_local, H, W]``, whose disparities start at ``index * D_local``
    along ``axis_name`` (a :class:`parallel.mesh.MeshAxis`).  Returns the
    global argmin (argmax for ``mode='max'``, the NCC similarity case
    `NCC/NCC.h:53-67`) as float32 [H, W], the same on every rank."""
    if mode not in ("min", "max"):
        # ops.wta.wta takes any other string as max: a typo must not invert
        # the winner against the unsharded run
        raise ValueError(f"mode must be 'min' or 'max', got {mode!r}")
    d_local = vol_local.shape[0]
    v = -vol_local if mode == "max" else vol_local
    local_best, local_val = torch.argmin(v, dim=0), torch.amin(v, dim=0)
    global_d = local_best.to(torch.int32) + axis_name.index * d_local
    best_val = comm.all_reduce(local_val, "min", axis_name)
    cand = torch.where(local_val == best_val, global_d, _BIG_IDX)
    return comm.all_reduce(cand, "min", axis_name).to(torch.float32)


def optimal_disparity_sharded(
    vol_local: torch.Tensor,
    axis_name,
    uniqueness_eps: float = 0.01,
    subpixel: bool = False,
    exclude_d0: bool = True,
    disp_range: int = None,
) -> torch.Tensor:
    """Sharded ``ops.wta.optimal_disparity`` (`SAD/Sad.h:40-85`), the same
    bits as the unsharded op.

    Two-stage: the global minimum by a MIN all-reduce (lowest global d on
    ties); the second minimum over every cost ``!=`` the minimum, seeded
    with the global ``cost[0]`` (`Sad.h:44,55-64`), which the shard of d = 0
    contributes; the parabola's d +- 1 costs by owner-masked MIN reduces
    (+inf where a shard does not hold the index).

    ``disp_range``: the true disparity count where it does not divide the
    axis: the padded slots (global d >= disp_range) are +inf here, whatever
    the caller padded them with, so that they neither win nor reach the
    second minimum or the parabola."""
    n, idx = axis_name.size, axis_name.index
    d_local = vol_local.shape[0]
    d_total = disp_range if disp_range is not None else d_local * n
    inf = float("inf")

    ds = torch.arange(d_local, device=vol_local.device)[:, None, None] + idx * d_local
    if d_total < d_local * n:
        vol_local = torch.where(ds >= d_total, inf, vol_local)

    # global argmin, lowest d on ties, global d = 0 excluded if asked
    v = torch.where(ds == 0, inf, vol_local) if exclude_d0 else vol_local
    local_best, local_val = torch.argmin(v, dim=0), torch.amin(v, dim=0)
    gd = local_best.to(torch.int32) + idx * d_local
    minval = comm.all_reduce(local_val, "min", axis_name)
    best = comm.all_reduce(torch.where(local_val == minval, gd, _BIG_IDX), "min", axis_name)

    sec_local = torch.amin(torch.where(vol_local != minval[None], vol_local, inf), dim=0)
    if idx == 0:
        sec_local = torch.minimum(sec_local, vol_local[0])
    sec = comm.all_reduce(sec_local, "min", axis_name)

    reject = (sec - minval <= uniqueness_eps) | (best == 0) | (best == d_total - 1)

    def cost_at(d_global):
        local = (d_global - idx * d_local).clamp(0, d_local - 1).long()
        c = torch.gather(vol_local, 0, local[None])[0]
        owns = (d_global >= idx * d_local) & (d_global < (idx + 1) * d_local)
        return comm.all_reduce(torch.where(owns, c, inf), "min", axis_name)

    c1 = cost_at((best - 1).clamp(0, d_total - 1))
    c2 = cost_at((best + 1).clamp(0, d_total - 1))
    denom = torch.clamp(c1 + c2 - 2.0 * minval, min=1.0)
    refined = best.to(torch.float32) + (c1 - c2) / (2.0 * denom)
    out = refined if subpixel else best.to(torch.float32)
    return torch.where(reject, 0.0, out)
