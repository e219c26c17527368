"""Port parity for the ``cblsm`` slice: ``get_pipeline("cblsm")`` of the
port against the JAX package's and against the checked-in goldens, and
its post chain bit for bit."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import cblsm as jcblsm
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu_torch import CBLSMConfig
from stereo_match_traditional_tpu_torch.models import cblsm as tcblsm
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict, pair_to_torch, result_to_numpy,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipelines_seed42.npz")
# the golden's cblsm case (tests/golden/generate_pipelines.py)
POST = cfgs.CBLSMConfig(disp_range=10, run_post=True)
FIELDS = ("disp_left", "disp_right", "disp_final")
# JAX sums its rectangle SAT in float32, which rounds the AD sums (up to
# 255 * H * W) and breaks ties; the port's float64 SAT keeps them.  WTA maps
# agree on >= 99.5 % of pixels, the post-processed map on >= 99 %.
MIN_AGREE = {"disp_left": 0.995, "disp_right": 0.995, "disp_final": 0.99}


def port_cfg(cfg):
    """The port's own config, carried across from the JAX package's."""
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _agreement(ref, got, d, fields=FIELDS):
    """``disp_right`` outside the clamp triangle (columns x <= W - D), as
    test_torch_ad_census.py compares it: inside, a rectangle can hold equal
    costs at several disparities, an exact tie that only the exact SAT
    keeps."""
    for f in fields:
        a, b = np.asarray(ref[f]), np.asarray(got[f])
        assert b.shape == a.shape and b.dtype == np.float32
        if f == "disp_right":
            a, b = a[:, : a.shape[1] - d + 1], b[:, : b.shape[1] - d + 1]
        same = float((a == b).mean())
        print(f"{f}: {same:.4%} of pixels equal")
        assert same >= MIN_AGREE[f], (f, same)


@functools.lru_cache(maxsize=None)
def _golden_pair():
    return make_pair(48, 64, 10, seed=42)


@functools.lru_cache(maxsize=None)
def _port(cfg):
    L, R, _ = _golden_pair()
    return result_to_numpy(
        get_pipeline("cblsm")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))


@pytest.mark.parametrize("cfg", [
    POST,
    cfgs.CBLSMConfig(disp_range=10, run_post=True, second_pass_left_arms=False),
    cfgs.CBLSMConfig(disp_range=10, agg_passes=3),
    cfgs.CBLSMConfig(disp_range=10, agg_passes=1),
    cfgs.CBLSMConfig(disp_range=10, aggregation="none"),
    cfgs.CBLSMConfig(disp_range=10, aggregation="cross_two_pass"),
    cfgs.CBLSMConfig(disp_range=10, aggregation="cross_two_pass", run_post=True),
], ids=["post", "post_own_arms", "three_passes", "one_pass", "no_aggregation",
        "cross_two_pass", "cross_two_pass_post"])
def test_cblsm_slice_matches_jax(cfg):
    L, R, _ = _golden_pair()
    jres = jax_get_pipeline("cblsm")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = _port(cfg)
    fields = FIELDS if cfg.run_post else FIELDS[:2]
    _agreement(jres._asdict(), got._asdict(), 10, fields)
    if not cfg.run_post:
        assert got.disp_final is None and got.occlusion is None
    if cfg.aggregation == "none":       # integer costs, no sums: exact
        np.testing.assert_array_equal(got.disp_left, np.asarray(jres.disp_left))


def test_cblsm_slice_matches_golden():
    z = np.load(GOLDEN)
    _agreement({f: z[f"cblsm/{f}"] for f in FIELDS}, _port(POST)._asdict(), 10)


def test_cblsm_output_contract():
    _, _, gt = _golden_pair()
    res = _port(POST)
    for f in ("disp_left", "disp_right"):
        v = getattr(res, f)
        assert np.isfinite(v).all() and v.min() >= 0 and v.max() <= 9
    assert res.occlusion.dtype == np.bool_ and res.mismatch.dtype == np.bool_
    assert bad_pixel_rate(res.disp_left, gt) < 0.35


def _maps(seed, h=24, w=32, d=10):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, d, size=(h // 4 + 1, w // 4 + 1))
    dl = np.kron(coarse, np.ones((4, 4)))[:h, :w]
    dl = np.where(rng.random((h, w)) < 0.15, rng.integers(0, d, size=(h, w)), dl)
    dr = np.where(rng.random((h, w)) < 0.3, rng.integers(0, d, size=(h, w)), dl)
    return dl.astype(np.float32), dr.astype(np.float32)


@pytest.mark.parametrize("seed", [31, 32])
def test_cblsm_post_bit_exact(seed):
    dl, dr = _maps(seed)
    cfg = cfgs.CBLSMConfig(disp_range=10, speckle_area=8, run_post=True)
    want = jcblsm.cblsm_post(jnp.asarray(dl), jnp.asarray(dr), cfg)
    got = tcblsm.cblsm_post(torch.tensor(dl), torch.tensor(dr), port_cfg(cfg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_cblsm_active_at_reference_size_matches_jax():
    """Reference shape (375x450, D=60): the active path against JAX, and its
    bad-2.0 against the ground truth (tests/test_tpu_smoke.py's limit)."""
    L, R, gt = make_pair(375, 450, 60, seed=0)
    cfg = cfgs.CBLSMConfig()
    jres = jax_get_pipeline("cblsm")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(
        get_pipeline("cblsm")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))
    _agreement(jres._asdict(), got._asdict(), 60, FIELDS[:2])
    assert bad_pixel_rate(got.disp_left, gt) <= 0.20


def test_cpu_tensors_launch_no_kernel():
    L, R, _ = make_pair(20, 24, 6, seed=2)
    before = ad_census_cuda.LAUNCHES
    res = get_pipeline("cblsm")[0](*pair_to_torch(L, R, "cpu"),
                                   CBLSMConfig(disp_range=6, run_post=True))
    assert ad_census_cuda.LAUNCHES == before
    assert res.disp_final.device.type == "cpu"


def test_registry_entry():
    fn, cfg_cls = get_pipeline("cblsm")
    assert fn is tcblsm.cblsm_pipeline and cfg_cls is CBLSMConfig


@pytest.mark.parametrize("cfg,kwargs,match", [
    (cfgs.CBLSMConfig(disp_range=4, cost="sad_mean", win_size=1), {}, None),
    (cfgs.CBLSMConfig(disp_range=4, cost="sad_mean_v4", win_size=1), {"color": True}, None),
    (cfgs.CBLSMConfig(disp_range=4, cost="local_mean"), {}, None),
    (cfgs.CBLSMConfig(disp_range=4, aggregation="rect_mean_v4"), {}, None),
], ids=["sad_mean", "sad_mean_v4", "local_mean", "rect_mean_v4"])
def test_unported_modes_raise(cfg, kwargs, match):
    """The dormant costs and the V4 aggregation run in the port and agree
    with JAX's: the WTA maps on >= 99.5 % of pixels, ``disp_right`` outside
    the clamp triangle (sad_mean_v4 on ``[H, W, 3]`` images, as in JAX)."""
    L, R, _ = make_pair(12, 20, 4, seed=0, **kwargs)
    want = jcblsm.cblsm_pipeline(jnp.asarray(L), jnp.asarray(R), cfg)
    got = tcblsm.cblsm_pipeline(torch.from_numpy(L), torch.from_numpy(R), port_cfg(cfg))
    _agreement(want._asdict(), result_to_numpy(got)._asdict(), cfg.disp_range,
               ("disp_left", "disp_right"))


@pytest.mark.parametrize("cfg", [
    CBLSMConfig(cost="bogus"), CBLSMConfig(aggregation="bogus"),
], ids=["cost", "aggregation"])
def test_unknown_options_rejected(cfg):
    L, R, _ = make_pair(8, 8, 2, seed=0)
    with pytest.raises(ValueError, match="unknown"):
        tcblsm.cblsm_pipeline(*pair_to_torch(L, R, "cpu"), cfg)
