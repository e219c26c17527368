"""The config lattice of tests/test_edge_cases.py (``_lattice``, 36
combinations of every documented enum and flag per pipeline, dormant
variants included) run through the port on the CPU at 20x36, D=6: each
configuration runs end to end and gives what the JAX package's lattice
asserts (the shape, finite non-negative disparities, a final map where the
post chain is on).  No JAX call, so the file imports nothing of it."""

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch import config as cfgs
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair


def _cfg_for(name, **kw):
    cfg_cls = get_pipeline(name)[1]
    valid = set(cfg_cls.__dataclass_fields__)
    return cfg_cls(**{k: v for k, v in kw.items() if k in valid})


def _lattice():
    cases = []
    for subpixel in (False, True):
        for right in (False, True):
            cases.append(("sad", dict(max_disparity=6, winsize=2, subpixel=subpixel,
                                      compute_right=right, run_post=right)))
    for mode in ("ignore", "sentinel"):
        cases.append(("ncc", dict(disp_range=6, win_size=2, invalid_mode=mode)))
    cases.append(("ncc", dict(disp_range=6, win_size=2, variant="shifted", alt_max_offset=6)))
    for variant in ("fused", "lab"):
        for post_on in (False, True):
            cases.append(("asw", dict(disp_range=6, win_size=2, variant=variant,
                                      use_pallas=False, run_post=post_on)))
    for agg in ("rect_mean", "cross_two_pass", "none"):
        for scan in (False, True):
            for post_on in (False, True):
                cases.append(("ad_census", dict(disp_range=6, aggregation=agg,
                                                scanline=scan, run_post=post_on)))
    for cost in ("ad", "sad_mean", "local_mean"):
        for agg in ("rect_mean", "rect_mean_v4", "cross_two_pass", "none"):
            cases.append(("cblsm", dict(disp_range=6, win_size=2, cost=cost, aggregation=agg)))
    cases.append(("cblsm", dict(disp_range=6, second_pass_left_arms=False, run_post=True)))
    return cases


def test_lattice_has_the_reference_size():
    assert len(_lattice()) == 36


@pytest.mark.parametrize("name,kw", _lattice())
def test_config_lattice(name, kw):
    kw = dict(kw)
    if kw.pop("scanline", False):
        kw["scanline"] = cfgs.ScanlineConfig()
    L, R, _ = make_pair(20, 36, 6, seed=4)
    cfg = _cfg_for(name, **kw)
    fn, _ = get_pipeline(name)
    lt, rt = pair_to_torch(L, R, "cpu")
    extra = {}
    if name == "asw" and kw.get("variant") == "lab":
        # the Lab variant weights from L*a*b* planes (`ASWeight.cpp:33-34`)
        extra = dict(left_lab=torch.stack([lt] * 3, -1), right_lab=torch.stack([rt] * 3, -1))
    res = fn(lt, rt, cfg, **extra)
    d = res.disp_left.numpy()
    assert d.shape == (20, 36)
    finite = d[np.isfinite(d)]
    assert finite.size and finite.min() >= 0
    if kw.get("run_post"):
        assert res.disp_final is not None
        assert res.disp_final.shape == (20, 36)
