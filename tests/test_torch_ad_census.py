"""Port parity for the flagship ``ad_census`` slice: ``get_pipeline
("ad_census")`` of the port against the JAX package's and against the
checked-in goldens, in its FULL and active forms."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu_torch import ADCensusConfig
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.ad_census import ad_census_pipeline
from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, scanline_cuda
from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict, pair_to_torch, result_to_numpy,
)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipelines_seed42.npz")
# the golden's ad_census case (tests/golden/generate_pipelines.py), which is
# also __graft_entry__.entry()'s FULL configuration at D=10
FULL = cfgs.ADCensusConfig(disp_range=10, scanline=cfgs.ScanlineConfig(), run_post=True)
# test_torch_asw.py's envelopes: float summation order (the port's SAT is
# float64, JAX's float32 matmuls) can flip a near-tied argmin; WTA maps
# agree on >= 99.5% of pixels, the post-processed map on >= 99%.
MIN_AGREE = {"disp_left": 0.995, "disp_right": 0.995, "disp_final": 0.99}


def port_cfg(cfg):
    """The port's own config, carried across from the JAX package's."""
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One small ``torch.exp`` on a permuted tensor before any parity
    check: torch's CPU exp has been seen to return values ~1e-4 off on the
    first call of a process (exp(-0.2) as 0.8188013, in one run of three,
    never on a later call), which is torch's doing, not the port's."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


def _agreement(ref, got, d, fields=tuple(MIN_AGREE)):
    """Fraction of equal pixels per field, held to ``MIN_AGREE``.
    ``disp_right`` is compared outside the clamp triangle (columns
    x <= W - D): inside it, a rectangle can hold the same costs at several
    disparities, an exact tie that the port's exact float64 SAT keeps (the
    lowest d wins, as in the reference's loops) and JAX's float32 SAT breaks
    by rounding."""
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
def _port_full():
    L, R, _ = _golden_pair()
    return result_to_numpy(get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), port_cfg(FULL)))


def test_full_slice_matches_jax():
    L, R, _ = _golden_pair()
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), FULL)
    got = _port_full()
    _agreement(jres._asdict(), got._asdict(), 10)
    for f in ("occlusion", "mismatch"):
        assert getattr(got, f).dtype == np.bool_
        assert (getattr(got, f) == np.asarray(getattr(jres, f))).mean() >= 0.99, f


def test_full_slice_matches_golden():
    z = np.load(GOLDEN)
    _agreement({f: z[f"ad_census/{f}"] for f in MIN_AGREE}, _port_full()._asdict(), 10)


def test_full_slice_output_contract():
    _, _, gt = _golden_pair()
    res = _port_full()
    for f in ("disp_left", "disp_right"):
        v = getattr(res, f)
        assert np.isfinite(v).all() and v.min() >= 0 and v.max() <= 9
    assert np.isfinite(res.disp_final).all()
    assert bad_pixel_rate(res.disp_left, gt) < 0.35


@pytest.mark.parametrize("cfg", [
    cfgs.ADCensusConfig(disp_range=9, aggregation="none"),
    cfgs.ADCensusConfig(disp_range=9, agg_iters=2),
    cfgs.ADCensusConfig(disp_range=9, run_post=True),
    cfgs.ADCensusConfig(disp_range=9, scanline=cfgs.ScanlineConfig(
        faithful_vertical_l2=True, faithful_vertical_p2=True, penalty_scale="auto")),
], ids=["no_aggregation", "agg_iters_2", "post_without_scanline", "quirk_scanline"])
def test_other_configurations_match_jax(cfg):
    L, R, _ = make_pair(37, 53, 9, seed=5)
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg))
    fields = ("disp_left", "disp_right") + (("disp_final",) if cfg.run_post else ())
    _agreement(jres._asdict(), result_to_numpy(got)._asdict(), 9, fields)
    if not cfg.run_post:
        assert got.disp_final is None and got.occlusion is None


def test_active_slice_at_reference_size_matches_jax():
    """Reference-shape parity (375x450, D=60, ROADMAP Queue 1 item 2) of
    the active path, and its bad-2.0 against the ground truth."""
    L, R, gt = make_pair(375, 450, 60, seed=0)
    cfg = cfgs.ADCensusConfig()
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(
        get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))
    _agreement(jres._asdict(), got._asdict(), 60, ("disp_left", "disp_right"))
    assert bad_pixel_rate(got.disp_left, gt) <= 0.15     # tests/test_tpu_smoke.py:37


def test_cpu_tensors_launch_no_kernel():
    L, R, _ = make_pair(20, 24, 6, seed=2)
    before = (ad_census_cuda.LAUNCHES, scanline_cuda.LAUNCHES)
    cfg = cfgs.ADCensusConfig(disp_range=6, scanline=cfgs.ScanlineConfig(), run_post=True)
    res = get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg))
    assert (ad_census_cuda.LAUNCHES, scanline_cuda.LAUNCHES) == before
    assert res.disp_final.device.type == "cpu"


def test_registry_entry():
    fn, cfg_cls = get_pipeline("ad_census")
    assert fn is ad_census_pipeline and cfg_cls is ADCensusConfig


@pytest.mark.parametrize("kwargs,match", [
    (dict(cfg=ADCensusConfig(aggregation="cross_two_pass")), "Queue 1 item 6"),
    (dict(return_stages=True), "Queue 1 item 8"),
], ids=["cross_two_pass", "return_stages"])
def test_unported_modes_raise(kwargs, match):
    L, R, _ = make_pair(8, 8, 2, seed=0)
    with pytest.raises(NotImplementedError, match=match):
        ad_census_pipeline(*pair_to_torch(L, R, "cpu"), **kwargs)


def test_unknown_aggregation_rejected():
    L, R, _ = make_pair(8, 8, 2, seed=0)
    with pytest.raises(ValueError, match="aggregation"):
        ad_census_pipeline(*pair_to_torch(L, R, "cpu"), ADCensusConfig(aggregation="bogus"))
