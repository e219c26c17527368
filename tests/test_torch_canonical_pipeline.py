"""Port parity for the canonical AD-Census family through the entry point:
``get_pipeline("ad_census")`` with ``aggregation='cross_two_pass'``, active
and FULL (canonical scanline on both views, canonical post), against the
JAX package's live and against the checked-in golden
``adc_cross_two_pass``."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu.utils import io as jio
from stereo_match_traditional_tpu_torch import config as tcfgs
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_cuda,
    scanline_canonical_cuda,
    scanline_cuda,
)
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict, pair_to_torch, result_to_numpy,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

QUIRKS = os.path.join(os.path.dirname(__file__), "golden", "quirks_seed42.npz")
CANON = dict(aggregation="cross_two_pass")
FULL = dict(CANON, scanline=cfgs.ScanlineConfig(), run_post=True)
CONFIGS = {
    "active": cfgs.ADCensusConfig(disp_range=10, **CANON),
    "FULL": cfgs.ADCensusConfig(disp_range=10, **FULL),
    "FULL_discontinuity": cfgs.ADCensusConfig(
        disp_range=10, **FULL,
        cross_params=cfgs.CrossAggregatorParams(do_discontinuity_adjustment=True)),
}
# PARITY.md's envelope: the port's cross sums are exact, JAX's float32 (band
# matmuls or prefix-sum differences), and its scanline's compiled loop rounds
# a few values an ulp apart, so a near tie can flip: WTA maps agree on
# >= 99.5 % of pixels, the post-processed map on >= 99 %.
MIN_AGREE = {"disp_left": 0.995, "disp_right": 0.995, "disp_final": 0.99}
# bad-2.0 of the JAX package on make_pair(375, 450, 60, seed=0)
# (BASELINE.md:672-673), hardware-independent
TEDDY_BAD2 = {"active": 0.0737, "FULL": 0.0852}


def port_cfg(cfg):
    """The port's own config, carried across from the JAX package's."""
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _agreement(ref, got, d, fields=tuple(MIN_AGREE)):
    """Fraction of equal pixels per field, held to ``MIN_AGREE``;
    ``disp_right`` outside the clamp triangle (columns x <= W - D), as
    test_torch_ad_census.py compares it."""
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
def _port(name):
    L, R, _ = _golden_pair()
    fn = get_pipeline("ad_census")[0]
    return result_to_numpy(fn(*pair_to_torch(L, R, "cpu"), port_cfg(CONFIGS[name])))


def _fields(cfg):
    return tuple(MIN_AGREE) if cfg.run_post else ("disp_left", "disp_right")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_canonical_matches_jax(name):
    cfg = CONFIGS[name]
    L, R, _ = _golden_pair()
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = _port(name)
    _agreement(jres._asdict(), got._asdict(), 10, _fields(cfg))
    if cfg.run_post:
        for f in ("occlusion", "mismatch"):
            assert getattr(got, f).dtype == np.bool_
            assert (getattr(got, f) == np.asarray(getattr(jres, f))).mean() >= 0.99, f
    else:
        assert got.disp_final is None and got.occlusion is None


def test_canonical_active_matches_golden():
    """tests/golden/generate_quirks.py's ``adc_cross_two_pass`` case."""
    z = np.load(QUIRKS)
    want = {f: z[f"adc_cross_two_pass/{f}"] for f in ("disp_left", "disp_right")}
    _agreement(want, _port("active")._asdict(), 10, tuple(want))


def test_canonical_output_contract():
    _, _, gt = _golden_pair()
    for name in CONFIGS:
        res = _port(name)
        for f in ("disp_left", "disp_right"):
            v = getattr(res, f)
            assert np.isfinite(v).all() and v.min() >= 0 and v.max() <= 9, (name, f)
        assert bad_pixel_rate(res.disp_left, gt) < 0.2, name
    assert not np.array_equal(_port("FULL").disp_left, _port("active").disp_left)


def test_canonical_arms_from_colour_images():
    """``left_color`` / ``right_color`` give the arms (the max-channel rule),
    the gray images everything else: JAX's result, and another one than
    the gray arms give.  The golden pair's shape, whose JAX ops the other
    tests have compiled."""
    Lc, Rc, _ = make_pair(48, 64, 10, seed=9, color=True)
    L, R = jio.rgb_to_gray_u8(Lc), jio.rgb_to_gray_u8(Rc)
    cfg = CONFIGS["FULL"]
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg,
                                            jnp.asarray(Lc), jnp.asarray(Rc))
    fn = get_pipeline("ad_census")[0]
    lt, rt = pair_to_torch(L, R, "cpu")
    got = result_to_numpy(fn(lt, rt, port_cfg(cfg), torch.tensor(Lc), torch.tensor(Rc)))
    _agreement(jres._asdict(), got._asdict(), 10)
    gray = result_to_numpy(fn(lt, rt, port_cfg(cfg)))
    assert not np.array_equal(got.disp_left, gray.disp_left)


def test_cross_params_carry_across():
    """A ``cross_params`` with every field changed from its default comes
    across from the JAX config field for field (``utils/convert.py``'s
    nested conversion) and gives JAX's canonical FULL result."""
    default = cfgs.CrossAggregatorParams()
    changed = cfgs.CrossAggregatorParams(
        min_disparity=1, max_disparity=32, lambda_ad=12.0, lambda_census=25.0, cross_l1=20,
        cross_l2=8, cross_t1=25, cross_t2=5, so_p1=2.0, so_p2=5.0, so_tso=20, irv_ts=10,
        irv_th=0.5, lrcheck_thres=2.0, do_lr_check=False, do_filling=False,
        do_discontinuity_adjustment=True, num_iters=2)
    for f in dataclasses.fields(default):
        assert getattr(changed, f.name) != getattr(default, f.name), f.name
    cfg = cfgs.ADCensusConfig(disp_range=10, **FULL, cross_params=changed)
    ported = port_cfg(cfg)
    assert type(ported.cross_params) is tcfgs.CrossAggregatorParams
    assert dataclasses.asdict(ported.cross_params) == dataclasses.asdict(changed)
    L, R, _ = _golden_pair()
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), ported))
    _agreement(jres._asdict(), got._asdict(), 10)
    assert got.occlusion is None and jres.occlusion is None     # do_lr_check=False
    assert not np.array_equal(got.disp_final, _port("FULL").disp_final)


def test_cpu_tensors_launch_no_kernel():
    L, R, _ = make_pair(20, 24, 6, seed=2)
    kernels = (ad_census_cuda, scanline_cuda, scanline_canonical_cuda)
    before = [k.LAUNCHES for k in kernels]
    cfg = cfgs.ADCensusConfig(disp_range=6, **FULL)
    res = get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg))
    assert [k.LAUNCHES for k in kernels] == before
    assert res.disp_final.device.type == "cpu"


def _teddy(name):
    L, R, gt = make_pair(375, 450, 60, seed=0)
    cfg = cfgs.ADCensusConfig(disp_range=60, **(FULL if name == "FULL" else CANON))
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"),
                                                       port_cfg(cfg)))
    _agreement(jres._asdict(), got._asdict(), 60, _fields(cfg))
    final = got.disp_final if cfg.run_post else got.disp_left
    assert abs(bad_pixel_rate(final, gt) - TEDDY_BAD2[name]) <= 0.005


def test_canonical_active_at_reference_size_matches_jax():
    """Reference shape (375x450, D=60): the active canonical path against
    JAX (~17 s of JAX on a CPU), and its bad-2.0 within 0.005 of 0.0737."""
    _teddy("active")


@pytest.mark.slow
def test_canonical_full_at_reference_size_matches_jax():
    """The FULL canonical path at the reference shape (~35 s of JAX on a
    CPU), ``disp_final``'s bad-2.0 within 0.005 of 0.0852."""
    _teddy("FULL")
