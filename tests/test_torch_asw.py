"""Port parity for the whole ``asw`` slice: ``get_pipeline("asw")`` of the
port against the JAX package's and against the checked-in goldens, plus the
port's registry (all five pipelines) and carry-across helpers."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu.models.registry import PIPELINES as JAX_PIPELINES
from stereo_match_traditional_tpu_torch import ASWConfig
from stereo_match_traditional_tpu_torch import config as port_cfgs
from stereo_match_traditional_tpu_torch.models import StereoResult, get_pipeline
from stereo_match_traditional_tpu_torch.ops.kernels import asw_cuda
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict,
    pair_to_torch,
    result_to_numpy,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipelines_seed42.npz")
# the golden's asw case (tests/golden/generate_pipelines.py)
CFG = cfgs.ASWConfig(disp_range=10, win_size=2, run_post=True, use_pallas=False)
FIELDS = ("disp_left", "disp_right", "disp_final")
# Float summation order and exp rounding differ between the backends, so a
# near-tied argmin can flip: the WTA maps must agree on >= 99.5% of pixels,
# the post-processed map (where a flip can move a speckle or a fill) >= 99%.
MIN_AGREE = {"disp_left": 0.995, "disp_right": 0.995, "disp_final": 0.99}


def port_cfg(cfg):
    """The port's own config, carried across from the JAX package's."""
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _pair():
    L, R, gt = make_pair(48, 64, 10, seed=42)
    return L, R, gt


@functools.lru_cache(maxsize=None)
def _port_result(use_pallas):
    L, R, _ = _pair()
    fn, cfg_cls = get_pipeline("asw")
    assert cfg_cls is ASWConfig
    cfg = dataclasses.replace(port_cfg(CFG), use_pallas=use_pallas)
    return result_to_numpy(fn(*pair_to_torch(L, R, "cpu"), cfg))


def _agreement(ref, got):
    for f in FIELDS:
        a, b = ref[f], got[f]
        assert b.shape == a.shape == (48, 64) and b.dtype == np.float32
        same = int((a == b).sum())
        print(f"{f}: {same}/{a.size} pixels equal ({same / a.size:.4%})")
        assert same / a.size >= MIN_AGREE[f], (f, same, a.size)


def test_asw_slice_matches_jax():
    L, R, _ = _pair()
    fn, _ = jax_get_pipeline("asw")
    jres = fn(jnp.asarray(L), jnp.asarray(R), CFG)
    got = _port_result(False)
    _agreement({f: np.asarray(getattr(jres, f)) for f in FIELDS}, got._asdict())


def test_asw_slice_matches_golden():
    z = np.load(GOLDEN)
    _agreement({f: z[f"asw/{f}"] for f in FIELDS}, _port_result(False)._asdict())


@pytest.mark.parametrize("use_pallas", [None, True])
def test_kernel_route_on_cpu_is_the_plain_version(use_pallas):
    """``use_pallas`` None/True routes through ``asw_volume_cuda``, which
    takes the plain version for CPU tensors and launches nothing."""
    before = asw_cuda.LAUNCHES
    got = _port_result(use_pallas)
    assert asw_cuda.LAUNCHES == before
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(_port_result(False), f))


def test_asw_slice_accuracy_on_ground_truth():
    _, _, gt = _pair()
    res = _port_result(False)
    assert np.isfinite(res.disp_left).all()
    assert res.disp_left.min() >= 0 and res.disp_left.max() <= 9
    assert bad_pixel_rate(res.disp_left, gt) < 0.35


def test_run_post_false_leaves_final_empty():
    L, R, _ = make_pair(16, 20, 4, seed=0)
    cfg = ASWConfig(disp_range=4, win_size=1, run_post=False)
    res = get_pipeline("asw")[0](*pair_to_torch(L, R, "cpu"), cfg)
    assert res.disp_final is None and res.disp_left.shape == (16, 20)


@pytest.mark.parametrize("cfg", [
    cfgs.ASWConfig(disp_range=4, win_size=1, variant="lab", run_post=True),
    cfgs.ASWConfig(disp_range=4, win_size=1, approx="grid", approx_bins=6, run_post=True),
], ids=["lab", "grid"])
def test_dormant_variants_not_ported(cfg):
    """The dormant variants run in the port and agree with JAX's (the WTA
    maps on >= 99.5 % of pixels, the post-processed map on >= 99 %); the Lab
    variant weights from the Lab images of the colour pair."""
    L, R, _ = make_pair(16, 20, 4, seed=0)
    kw = {}
    if cfg.variant == "lab":
        from stereo_match_traditional_tpu_torch.utils.io import rgb_to_lab_u8

        lc, rc, _ = make_pair(16, 20, 4, seed=0, color=True)
        kw = {"left_lab": rgb_to_lab_u8(lc), "right_lab": rgb_to_lab_u8(rc)}
    want = jax_get_pipeline("asw")[0](jnp.asarray(L), jnp.asarray(R), cfg,
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
    got = get_pipeline("asw")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg),
                                 **{k: torch.from_numpy(v) for k, v in kw.items()})
    got = result_to_numpy(got)
    for f in FIELDS:
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.shape == (16, 20)
        assert (g == w).mean() >= MIN_AGREE[f], f


def test_unknown_approx_rejected():
    L, R, _ = make_pair(8, 8, 2, seed=0)
    with pytest.raises(ValueError, match="approx"):
        get_pipeline("asw")[0](*pair_to_torch(L, R, "cpu"),
                               ASWConfig(approx="bogus"))


@pytest.mark.parametrize("name", sorted(JAX_PIPELINES))
def test_registry_resolves_every_jax_pipeline(name):
    """Every name of the JAX registry resolves in the port's, with the
    port's own config class of the same name and defaults, and runs at 8x8
    on CPU tensors."""
    fn, cfg_cls = get_pipeline(name)
    jax_cls = JAX_PIPELINES[name][1]
    assert cfg_cls is getattr(port_cfgs, jax_cls.__name__) and cfg_cls is not jax_cls
    assert dataclasses.asdict(cfg_cls()) == dataclasses.asdict(jax_cls())
    L, R, _ = make_pair(8, 8, 3, seed=0)
    res = fn(*pair_to_torch(L, R, "cpu"), cfg_cls(**port_cfgs.disp_override_kw(cfg_cls, 4)))
    assert res.disp_left.shape == (8, 8) and torch.isfinite(res.disp_left).all()


def test_registry_unknown_name_lists_valid_names():
    with pytest.raises(KeyError, match="ad_census.*asw.*cblsm.*ncc.*sad"):
        get_pipeline("bogus")


def test_convert_round_trip_and_validation():
    L, R, _ = make_pair(6, 7, 2, seed=0)
    lt, rt = pair_to_torch(L, R, "cpu")
    assert lt.dtype == torch.uint8 and lt.shape == (6, 7)
    np.testing.assert_array_equal(lt.numpy(), L)
    back = result_to_numpy(StereoResult(lt.float(), None, rt.float()))
    assert back.disp_right is None
    np.testing.assert_array_equal(back.disp_final, R.astype(np.float32))
    with pytest.raises(ValueError, match="uint8"):
        pair_to_torch(L.astype(np.float32), R, "cpu")
    with pytest.raises(ValueError, match="differ"):
        pair_to_torch(L, R[:, :5], "cpu")


@pytest.mark.slow
def test_asw_at_reference_size_matches_jax():
    """Reference-shape parity (375x450, D=60, win_size 11), the open cell of
    ROADMAP's "Measurement cells": the port's CPU path against JAX's plain
    reference volume under the slice's envelopes, and bad-2.0 within
    tests/test_tpu_smoke.py's 0.15.  Slow: the 625-offset plain volume."""
    L, R, gt = make_pair(375, 450, 60, seed=0)
    cfg = cfgs.ASWConfig(use_pallas=False)
    jres = jax_get_pipeline("asw")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(get_pipeline("asw")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))
    for f in FIELDS:
        a, b = np.asarray(getattr(jres, f)), getattr(got, f)
        assert b.shape == a.shape == (375, 450) and b.dtype == np.float32
        same = float((a == b).mean())
        print(f"{f}: {same:.4%} of pixels equal")
        assert same >= MIN_AGREE[f], (f, same)
    bad2 = bad_pixel_rate(got.disp_left, gt)
    print(f"bad-2.0 of disp_left: {bad2}")
    assert bad2 <= 0.15
