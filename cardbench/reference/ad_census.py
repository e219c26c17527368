"""The plain reference of the AD-Census configurations: one pair in, the
final disparity map out, from the configuration's fields as plain data.

``aggregation='rect_mean'`` (`AD-CensusV1/main.cpp:58-94`): the cost of both
views, the arms of each image, the arm-rectangle mean, the 4-path scanline
of the left volume, WTA of both, the LR check, the speckle filter, the
8-direction fill and the truncate median.  ``aggregation='cross_two_pass'``
(the vendored ``ADCensusOption``, `CBLSM/adcensus_types.h:45-75`):
canonical arms, the two-pass cross aggregation, the canonical scanline of
both volumes, WTA, the LR check, region voting, the discontinuity
adjustment where asked for, and the truncate median.

``dtype`` is the precision the volumes are held and computed in from the
cost on: float32, the configuration's, or a lower one for the control.
"""

from __future__ import annotations

import torch

from cardbench.reference import aggregate, post, scanline
from cardbench.reference.volume import ad_census_volume


def _wta(vol: torch.Tensor) -> torch.Tensor:
    """The lowest-cost disparity (the first of equal ones), as float32."""
    return torch.argmin(vol, dim=0).to(torch.float32)


def disparity(left: torch.Tensor, right: torch.Tensor, cfg: dict, disp_range: int,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``disp_final`` of the grey uint8 pair ``left``, ``right`` ``[H, W]``
    under ``cfg`` (the configuration's ``ad_census`` fields)."""
    d = disp_range
    vols = [ad_census_volume(left, right, d, cfg["sigma_c"], cfg["sigma_s"], cfg["census_rows"],
                             cfg["census_cols"], view).to(dtype) for view in ("left", "right")]
    if cfg["aggregation"] == "rect_mean":
        arms = [aggregate.cross_arms(img, cfg["arms"]) for img in (left, right)]
        for _ in range(cfg["agg_iters"]):
            vols = [aggregate.rect_mean(v, a) for v, a in zip(vols, arms)]
        if cfg.get("scanline") is not None:
            vols[0] = scanline.scanline_optimize(vols[0], left, cfg["scanline"])
        disp_l, disp_r = (_wta(v) for v in vols)
        if not cfg["run_post"]:
            return disp_l
        disp, occl, mism = post.lr_check(disp_l, disp_r, cfg["lr_gate"])
        disp = post.remove_speckles(disp, cfg["speckle_diff"], cfg["speckle_area"])
        disp = post.fill_holes_8dir(disp, occl, mism, d)
        return post.median_truncate(disp, cfg["median_size"])
    if cfg["aggregation"] != "cross_two_pass":
        raise ValueError(f"no reference for aggregation {cfg['aggregation']!r}")
    cp = cfg["cross_params"]
    arms = [aggregate.canonical_cross_arms(img, cp) for img in (left, right)]
    vols = [aggregate.cross_aggregate(v, a, cp["num_iters"]) for v, a in zip(vols, arms)]
    if cfg.get("scanline") is not None:
        vols = [scanline.scanline_optimize_canonical(v, left, right, cp["so_p1"], cp["so_p2"],
                                                     cp["so_tso"], view)
                for v, view in zip(vols, ("left", "right"))]
    disp_l, disp_r = (_wta(v) for v in vols)
    if not cfg["run_post"]:
        return disp_l
    disp = disp_l
    if cp["do_lr_check"]:
        disp = post.lr_check(disp_l, disp_r, cp["lrcheck_thres"])[0]
    if cp["do_filling"]:
        disp = post.region_voting(disp, arms[0], d, cp["irv_ts"], cp["irv_th"])
    if cp["do_discontinuity_adjustment"]:
        disp = post.discontinuity_adjustment(disp, vols[0])
    return post.median_truncate(disp, cfg["median_size"])
