"""Port parity: the ASW and AD-Census post chains of
``stereo_match_traditional_tpu_torch`` are bit-exact with the JAX package,
on random maps and on JAX's own disparities fed to both."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import ad_census as jadc
from stereo_match_traditional_tpu.models import asw as jasw
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.ops import wta as jwta
from stereo_match_traditional_tpu.utils.synthetic import make_pair
from stereo_match_traditional_tpu_torch.models import ad_census as tadc
from stereo_match_traditional_tpu_torch.models import asw as tasw
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict

_D = 10


def port_cfg(cfg):
    """The port's own config, carried across from the JAX package's."""
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _t(a):
    return torch.tensor(np.asarray(a))


def _random_maps(seed, h=24, w=32):
    """Integer disparities in [0, D) with flat patches, so the LR check
    passes and fails, and speckle components of many sizes exist."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, _D, size=(h // 4 + 1, w // 4 + 1))
    dl = np.kron(coarse, np.ones((4, 4)))[:h, :w]
    noise = rng.random((h, w)) < 0.15
    dl = np.where(noise, rng.integers(0, _D, size=(h, w)), dl).astype(np.float32)
    dr = np.where(rng.random((h, w)) < 0.3, rng.integers(0, _D, size=(h, w)), dl)
    return dl, dr.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_disparities():
    """JAX's own (left, right) WTA maps on a small synthetic pair."""
    L, R, _ = make_pair(24, 32, _D, seed=7)
    vol_l = jvol.asw_volume(L, R, _D, win_size=2)
    vol_r = jvol.right_volume_from_left(vol_l)
    return np.asarray(jwta.wta(vol_l, "min")), np.asarray(jwta.wta(vol_r, "min"))


def _maps(source):
    return _jax_disparities() if source == "jax" else _random_maps(11)


@pytest.mark.parametrize("source", ["random", "jax"])
@pytest.mark.parametrize("invalid_value", [0.0, np.inf])
def test_lr_check_simple_bit_exact(source, invalid_value):
    dl, dr = _maps(source)
    got = tpost.lr_check_simple(_t(dl), _t(dr), 1.0, invalid_value=invalid_value)
    # JAX's banded form (what its pipelines run) and its gather form
    for disp_range in (_D, None):
        want = jpost.lr_check_simple(dl, dr, 1.0, invalid_value=invalid_value,
                                     disp_range=disp_range)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if source == "random":
        assert got.occlusion.any() and got.mismatch.any()


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("invalid_value", [0.0, np.inf])
def test_remove_speckles_bit_exact(connectivity, invalid_value):
    dl, _ = _random_maps(12)
    dl = np.where(dl == 3, invalid_value, dl).astype(np.float32)
    want = np.asarray(
        jpost.remove_speckles(dl, 1.0, 9, invalid_value=invalid_value,
                              connectivity=connectivity)
    )
    got = tpost.remove_speckles(_t(dl), 1.0, 9, invalid_value=invalid_value,
                                connectivity=connectivity).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != dl).any()                  # something was removed


def test_remove_speckles_serpentine():
    """One snake-shaped component whose min-label path winds through every
    row: exact labelling keeps it whole, so nothing is removed."""
    h, w = 15, 12
    snake = np.zeros((h, w), np.float32)
    snake[0::2, :] = 5.0
    snake[1::4, -1] = 5.0
    snake[3::4, 0] = 5.0
    want = np.asarray(jpost.remove_speckles(snake, 0.0, 60, invalid_value=0.0,
                                            connectivity=4))
    got = tpost.remove_speckles(_t(snake), 0.0, 60, invalid_value=0.0,
                                connectivity=4).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, snake)


def test_remove_speckles_unported_modes_raise():
    x = _t(np.ones((4, 4), np.float32))
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 7"):
        tpost.remove_speckles(x, block=2)
    with pytest.raises(ValueError):
        tpost.remove_speckles(x, connectivity=6)


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("source", ["random", "jax"])
def test_median_filter_replicate_bit_exact(size, source):
    x = _maps(source)[0]
    if source == "random":
        x = x + np.random.default_rng(13).standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jpost.median_filter(x, size, border="replicate"))
    got = tpost.median_filter(_t(x), size, border="replicate").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("source", ["random", "jax"])
def test_median_filter_truncate_bit_exact(size, source):
    """Only in-image values take part; inf entries (invalid pixels) count
    and sort last, as in the JAX package."""
    x = _maps(source)[0].copy()
    rng = np.random.default_rng(15)
    x[rng.random(x.shape) < 0.2] = np.inf
    x[:3, :4] = np.inf                      # an all-inf corner window
    want = np.asarray(jpost.median_filter(x, size, border="truncate"))
    got = tpost.median_filter(_t(x), size, border="truncate").numpy()
    np.testing.assert_array_equal(got, want)


def test_median_filter_unknown_border_rejected():
    with pytest.raises(ValueError, match="border"):
        tpost.median_filter(_t(np.ones((4, 4), np.float32)), 3, border="reflect")


def _with_invalid(dl, seed, share=0.1):
    dl = dl.copy()
    dl[np.random.default_rng(seed).random(dl.shape) < share] = np.inf
    return dl


@pytest.mark.parametrize("source", ["random", "jax"])
@pytest.mark.parametrize("gate", [1.0, 2.0])
def test_lr_check_consistency_bit_exact(source, gate):
    """disp, occlusion and mismatch, against JAX's banded form (what its
    pipeline runs) and its gather form; already-invalid (inf) pixels
    included."""
    dl, dr = _maps(source)
    dl = _with_invalid(dl, 16)
    got = tpost.lr_check_consistency(_t(dl), _t(dr), gate)
    for disp_range in (_D, None):
        want = jpost.lr_check_consistency(dl, dr, gate, disp_range=disp_range)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.occlusion.any() and got.mismatch.any()


def _holes(source, seed):
    """A map with inf holes and an occlusion/mismatch split of them."""
    dl = _with_invalid(_maps(source)[0], seed, 0.35)
    dl[4, :] = np.inf                       # a row with no axis candidate
    rng = np.random.default_rng(seed + 1)
    occl = ~np.isfinite(dl) & (rng.random(dl.shape) < 0.5)
    mism = ~np.isfinite(dl) & ~occl & (rng.random(dl.shape) < 0.7)
    return dl, occl, mism


@pytest.mark.parametrize("source", ["random", "jax"])
def test_directional_candidates_bit_exact(source):
    dl, _, _ = _holes(source, 17)
    valid = np.isfinite(dl)
    want_v, want_s = jpost.directional_candidates(dl, valid)
    got_v, got_s = tpost.directional_candidates(_t(dl), _t(valid))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("max_search", [None, _D])
@pytest.mark.parametrize("source", ["random", "jax"])
def test_fill_holes_8dir_bit_exact(max_search, source):
    dl, occl, mism = _holes(source, 18)
    want = np.asarray(jpost.fill_holes_8dir(dl, occl, mism, max_search=max_search))
    got = tpost.fill_holes_8dir(_t(dl), _t(occl), _t(mism), max_search=max_search).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).sum() > np.isfinite(dl).sum()


@pytest.mark.parametrize("source", ["random", "jax"])
def test_ad_census_post_bit_exact(source):
    """The whole FULL post chain (LR check, speckles with inf and
    8-connectivity, 8-direction fill, truncate median)."""
    dl, dr = _maps(source)
    cfg = cfgs.ADCensusConfig(disp_range=_D, speckle_area=6, run_post=True)
    want = jadc.ad_census_post(jnp.asarray(dl), jnp.asarray(dr), cfg)
    got = tadc.ad_census_post(_t(dl), _t(dr), port_cfg(cfg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("source", ["random", "jax"])
def test_fill_image_new_bit_exact(source):
    x = _maps(source)[0].copy()
    rng = np.random.default_rng(14)
    x[rng.random(x.shape) < 0.4] = 0.0
    x[3, :] = 0.0                       # a row with nothing to fill from
    x[5, :-1] = 0.0                     # only a right neighbour
    want = np.asarray(jpost.fill_image_new(x))
    got = tpost.fill_image_new(_t(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source", ["random", "jax"])
def test_asw_post_bit_exact(source):
    dl, dr = _maps(source)
    cfg = cfgs.ASWConfig(disp_range=_D, speckle_area=6)
    want = np.asarray(jasw.asw_post(jnp.asarray(dl), jnp.asarray(dr), cfg))
    got = tasw.asw_post(_t(dl), _t(dr), port_cfg(cfg)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("x", [
    np.arange(0, 511, dtype=np.float32).reshape(7, 73),   # scale 0.5: .5 ties
    np.full((5, 8), 3.0, np.float32),                     # constant: scale 0
    np.linspace(0.0, 7.0, 40, dtype=np.float32).reshape(5, 8),
], ids=["half_ties", "constant", "linspace"])
def test_minmax_u8_bit_exact(x):
    """jnp.round and torch.round both round half to even."""
    want = np.asarray(jasw._minmax_u8(jnp.asarray(x)))
    np.testing.assert_array_equal(tasw._minmax_u8(_t(x)).numpy(), want)
