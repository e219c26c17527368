"""The port's own ``config`` and ``utils.synthetic`` against the JAX
package's: same classes, fields, defaults, methods and bytes, and the
carry-across of a config as plain data."""

import dataclasses

import numpy as np
import pytest

from stereo_match_traditional_tpu import config as jcfg
from stereo_match_traditional_tpu.utils import synthetic as jsyn
from stereo_match_traditional_tpu_torch import config as tcfg
from stereo_match_traditional_tpu_torch.utils import synthetic as tsyn
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict

JAX_CLASSES = sorted(
    name for name, obj in vars(jcfg).items()
    if isinstance(obj, type) and dataclasses.is_dataclass(obj)
)


def test_every_config_class_is_listed():
    assert JAX_CLASSES == ["ADCensusConfig", "ASWConfig", "CBLSMConfig",
                           "CrossAggregatorParams", "CrossArmConfig", "NCCConfig",
                           "SADConfig", "ScanlineConfig"]


@pytest.mark.parametrize("name", JAX_CLASSES)
def test_port_config_class_mirrors_jax(name):
    jax_cls, port_cls = getattr(jcfg, name), getattr(tcfg, name)
    assert port_cls is not jax_cls and port_cls.__module__ == tcfg.__name__
    assert ([(f.name, f.type) for f in dataclasses.fields(port_cls)]
            == [(f.name, f.type) for f in dataclasses.fields(jax_cls)])
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(port_cls(), dataclasses.fields(port_cls)[0].name, 0)


@pytest.mark.parametrize("name", JAX_CLASSES)
def test_default_config_carries_across(name):
    got = config_from_dict(name, dataclasses.asdict(getattr(jcfg, name)()))
    assert type(got) is getattr(tcfg, name) and got == getattr(tcfg, name)()


def test_nested_config_round_trips():
    src = jcfg.ADCensusConfig(
        disp_range=17, aggregation="none", run_post=True,
        arms=jcfg.CrossArmConfig(tao1=11, max_length=9),
        scanline=jcfg.ScanlineConfig(p1=3.0, faithful_vertical_l2=True, penalty_scale="auto"),
        cross_params=jcfg.CrossAggregatorParams(num_iters=2),
    )
    got = config_from_dict("ADCensusConfig", dataclasses.asdict(src))
    assert type(got) is tcfg.ADCensusConfig
    assert type(got.arms) is tcfg.CrossArmConfig
    assert type(got.scanline) is tcfg.ScanlineConfig
    assert type(got.cross_params) is tcfg.CrossAggregatorParams
    assert dataclasses.asdict(got) == dataclasses.asdict(src)
    assert config_from_dict("ADCensusConfig", dataclasses.asdict(got)) == got
    assert config_from_dict("ADCensusConfig", {"scanline": None}).scanline is None


def test_carry_across_rejects_what_the_port_lacks():
    with pytest.raises(KeyError, match="BogusConfig"):
        config_from_dict("BogusConfig", {})
    with pytest.raises(KeyError, match="disp_override_kw"):
        config_from_dict("disp_override_kw", {})
    with pytest.raises(ValueError, match="bogus_field"):
        config_from_dict("SADConfig", {"bogus_field": 1})


@pytest.mark.parametrize("d", [10, 60, 128, 256])
def test_effective_penalties_agree(d):
    for scale in (None, "auto", 0.25):
        kw = dict(p1=7.0, p2=130.0, penalty_scale=scale)
        assert (tcfg.ScanlineConfig(**kw).effective_penalties(d)
                == jcfg.ScanlineConfig(**kw).effective_penalties(d))


def test_config_helpers_agree():
    assert tcfg.TEDDY_SHAPE == jcfg.TEDDY_SHAPE
    for name in JAX_CLASSES:
        assert (tcfg.disp_override_kw(getattr(tcfg, name), 33)
                == jcfg.disp_override_kw(getattr(jcfg, name), 33))
    assert tcfg.disp_override_kw(tcfg.SADConfig, None) == {}
    assert tcfg.SADConfig(winsize=5).radius == jcfg.SADConfig(winsize=5).radius
    assert tcfg.ASWConfig(win_size=4).radius == jcfg.ASWConfig(win_size=4).radius


@pytest.mark.parametrize("kwargs", [
    dict(height=48, width=64, max_disp=10, seed=42),
    dict(height=37, width=53, max_disp=9, seed=5, color=True),
    dict(height=60, width=200, max_disp=128, seed=1, feature_scale=24 * 128 // 60),
], ids=["golden_pair", "color", "feature_scale"])
def test_make_pair_is_byte_equal(kwargs):
    want, got = jsyn.make_pair(**kwargs), tsyn.make_pair(**kwargs)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_bad_pixel_rate_agrees():
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 20, size=(12, 15)).astype(np.float32)
    disp = gt + rng.normal(0, 2, size=gt.shape).astype(np.float32)
    disp[0, 0] = np.inf
    valid = rng.random(gt.shape) < 0.7
    for kw in ({}, {"thresh": 1.0}, {"valid": valid}, {"valid": np.zeros_like(valid)}):
        assert tsyn.bad_pixel_rate(disp, gt, **kw) == jsyn.bad_pixel_rate(disp, gt, **kw)
