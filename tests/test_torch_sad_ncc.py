"""Port parity for the ``sad`` and ``ncc`` slices: box sums, the SAD and NCC
volumes, the uniqueness WTA, speckle removal with a background value, the
SAD post chain, and both pipelines through ``get_pipeline`` against the JAX
package and the checked-in goldens (JAX on the CPU backend, unjitted)."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu.models import sad as jsad
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.ops import wta as jwta
from stereo_match_traditional_tpu_torch import NCCConfig, SADConfig
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models import sad as tsad
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.ops import volume as tvol
from stereo_match_traditional_tpu_torch.ops import wta as twta
from stereo_match_traditional_tpu_torch.ops.kernels import window_cost_cuda
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict, pair_to_torch, result_to_numpy,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "pipelines_seed42.npz")
# the golden's sad and ncc cases (tests/golden/generate_pipelines.py)
SAD_GOLDEN = cfgs.SADConfig(max_disparity=10, winsize=1, run_post=True)
NCC_GOLDEN = cfgs.NCCConfig(disp_range=10, win_size=3)


def port_cfg(cfg):
    """The port's own config, carried across from the JAX package's."""
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _t(a):
    return torch.tensor(np.asarray(a))


def _u8(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _golden_pair():
    return make_pair(48, 64, 10, seed=42)


# -- box sums ----------------------------------------------------------------


@pytest.mark.parametrize("shape,rr,rc,centred", [
    ((20, 30), 2, 3, False),
    ((3, 19, 25), 4, 4, False),          # leading axis, as over a shifted stack
    ((30, 40), 10, 10, True),            # NCC: 128-centred products, 21x21
], ids=["u8", "stack", "ncc_products"])
def test_box_sum_valid_bit_exact(shape, rr, rc, centred):
    """Integer values whose window sums stay below 2^24: exact in any order."""
    x = _u8(0, shape)
    if centred:
        x = (x - 128.0) * (_u8(1, shape) - 128.0)
    want = np.asarray(jvol.box_sum_valid(x, rr, rc))
    got = tvol.box_sum_valid(_t(x), rr, rc)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rr,rc", [(1, 1), (3, 2), (10, 10)])
def test_box_sum_same_bit_exact(rr, rc):
    x = _u8(2, (2, 17, 23)) - 128.0
    want = np.asarray(jvol.box_sum_same(x, rr, rc))
    np.testing.assert_array_equal(tvol.box_sum_same(_t(x), rr, rc).numpy(), want)


def test_box_sums_close_on_float_inputs():
    """Non-integer values: the port sums in float64 and rounds once, JAX's
    float32 matmul rounds along the way."""
    x = np.random.default_rng(3).standard_normal((2, 25, 31)).astype(np.float32) * 50
    want = np.asarray(jvol.box_sum_same(x, 4, 4))
    np.testing.assert_allclose(tvol.box_sum_same(_t(x), 4, 4).numpy(), want,
                               rtol=1e-5, atol=1e-4)


# -- SAD volume ----------------------------------------------------------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("h,w,d,winsize,seed", [(20, 30, 7, 3, 1), (9, 6, 10, 1, 5)],
                         ids=["20x30_D7", "D_gt_W"])
def test_sad_volume_bit_exact(h, w, d, winsize, seed, view, mean):
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    want = np.asarray(jvol.sad_volume(L, R, d, winsize, view, mean=mean))
    got = tvol.sad_volume(*pair_to_torch(L, R, "cpu"), d, winsize, view, mean)
    assert got.shape == (d, h, w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", [tvol.sad_volume, window_cost_cuda.sad_volume_cuda],
                         ids=["plain", "wrapper"])
def test_sad_volume_channel_min_not_ported(fn):
    """``channel_min`` (the minimum-channel colour SAD) on u8 ``[H, W, 3]``
    pairs equals JAX's bit for bit, both views, mean on and off; the wrapper
    takes the plain version for CPU tensors and launches nothing."""
    L, R, _ = make_pair(9, 13, 5, seed=3, color=True)
    lt, rt = torch.from_numpy(L), torch.from_numpy(R)
    before = dict(window_cost_cuda.LAUNCHES)
    for view in ("left", "right"):
        for mean in (False, True):
            want = np.asarray(jvol.sad_volume(L, R, 6, 1, view, mean, True))
            got = fn(lt, rt, 6, 1, view, mean, True)
            assert got.shape == (6, 9, 13)
            np.testing.assert_array_equal(got.numpy(), want)
    assert window_cost_cuda.LAUNCHES == before


def test_sad_volume_cuda_takes_plain_version_on_cpu():
    L, R, _ = make_pair(14, 18, 5, seed=2)
    lt, rt = pair_to_torch(L, R, "cpu")
    before = dict(window_cost_cuda.LAUNCHES)
    got = window_cost_cuda.sad_volume_cuda(lt, rt, 5, 2, "right", True)
    assert window_cost_cuda.LAUNCHES == before
    assert torch.equal(got, tvol.sad_volume(lt, rt, 5, 2, "right", True))


# -- uniqueness WTA ------------------------------------------------------------


def _wta_volume(source):
    d = 9
    if source == "sad":
        L, R, _ = make_pair(24, 32, d, seed=6)
        return np.asarray(jvol.sad_volume(L, R, d, 1))
    rng = np.random.default_rng(7)
    vol = rng.integers(0, 4, size=(d, 12, 16)).astype(np.float32)
    vol[:, 0, :] = 2.0                          # all equal: cost[0] is the min
    vol[:, 1, :] = np.arange(d)[:, None] + 1.0  # best at d=1 (low end, rejected)
    vol[:, 2, :] = -np.arange(d)[:, None]       # best at d=D-1 (high end)
    vol[:, 3, :] = 5.0
    vol[4, 3, :] = 1.0
    vol[5, 3, :] = 1.005                        # second minimum within eps
    vol[:, 4, :] = 5.0
    vol[3, 4, :] = 1.0
    vol[6, 4, :] = 1.0                          # tied minimum: lowest d wins
    return vol


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("source", ["sad", "ties"])
def test_optimal_disparity_bit_exact(source, subpixel):
    vol = _wta_volume(source)
    want = np.asarray(jwta.optimal_disparity(vol, 0.01, subpixel))
    got = twta.optimal_disparity(_t(vol), 0.01, subpixel).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got != 0).any()
    if subpixel and source == "sad":
        assert (got != np.round(got)).any()


# -- post: speckles with a background value, the SAD chain -------------------


def _maps_with_background(seed, h=24, w=32, d=10):
    """Integer maps with zero-disparity blobs (some alone, some touching
    other disparities), inf holes, and a right map for the LR check."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, d, size=(h // 4 + 1, w // 4 + 1))
    dl = np.kron(coarse, np.ones((4, 4)))[:h, :w].astype(np.float32)
    dl[rng.random((h, w)) < 0.1] = np.inf
    dl[1:5, 1:6] = np.inf
    dl[2:4, 2:5] = 0.0                      # a small background-only blob
    dr = np.where(rng.random((h, w)) < 0.3, rng.integers(0, d, size=(h, w)), dl)
    return dl, np.where(np.isfinite(dr), dr, 0.0).astype(np.float32)


@pytest.mark.parametrize("seed", [21, 22])
@pytest.mark.parametrize("connectivity", [4, 8])
def test_remove_speckles_background_bit_exact(seed, connectivity):
    dl, _ = _maps_with_background(seed)
    want = np.asarray(jpost.remove_speckles(dl, 1.0, 20, background=0.0,
                                            connectivity=connectivity))
    got = tpost.remove_speckles(_t(dl), 1.0, 20, background=0.0,
                                connectivity=connectivity).numpy()
    np.testing.assert_array_equal(got, want)
    without = tpost.remove_speckles(_t(dl), 1.0, 20, connectivity=connectivity).numpy()
    assert (got != without).any()           # a background-only blob survived
    assert (got == 0.0).sum() > (without == 0.0).sum()


@pytest.mark.parametrize("source", ["random", "jax"])
def test_sad_post_bit_exact(source):
    if source == "jax":
        L, R, _ = make_pair(24, 32, 10, seed=8)
        dl = np.asarray(jwta.optimal_disparity(jvol.sad_volume(L, R, 10, 1)))
        dr = np.asarray(jwta.wta(jvol.sad_volume(L, R, 10, 1, "right")))
    else:
        dl, dr = _maps_with_background(23)
        dl = np.where(np.isfinite(dl), dl, 0.0).astype(np.float32)
    cfg = cfgs.SADConfig(max_disparity=10, speckle_area=12, run_post=True)
    want = jsad.sad_post(jnp.asarray(dl), jnp.asarray(dr), cfg)
    got = tsad.sad_post(_t(dl), _t(dr), port_cfg(cfg))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- NCC volume ----------------------------------------------------------------


def test_ncc_interior_mask_bit_exact():
    want = np.asarray(jvol.ncc_interior_mask(17, 30, 4))
    got = tvol.ncc_interior_mask(17, 30, 4)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def _ncc_check(L, R, d, win, mode):
    want, want_in = jvol.ncc_volume(L, R, d, win, mode)
    lt, rt = pair_to_torch(L, R, "cpu")
    got, got_in = tvol.ncc_volume(lt, rt, d, win, mode)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(want_in))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got


@pytest.mark.parametrize("mode", ["ignore", "sentinel"])
@pytest.mark.parametrize("win", [3, 10])
def test_ncc_volume_bit_exact(win, mode):
    """u8 inputs: the window sums are exact, and every epilogue operation is
    correctly rounded on both sides, so the volume is bit-exact."""
    L, R, _ = make_pair(40, 56, 12, seed=9)
    got = _ncc_check(L, R, 12, win, mode)
    sentinel = 255.0 if mode == "sentinel" else -2.0
    assert (got[:, :, :win] == sentinel).all()
    lf = L.astype(np.float32) - 128.0
    sums = tvol.ncc_sums(*pair_to_torch(L, R, "cpu"), win)[2]
    np.testing.assert_array_equal(sums[1].numpy(), np.asarray(jvol.box_sum_same(lf * lf, win, win)))


def test_ncc_volume_flat_windows():
    """Flat regions give zero variance: masked to -2 on both sides."""
    L, R, _ = make_pair(32, 48, 8, seed=10)
    L, R = L.copy(), R.copy()
    L[:, :20] = 90
    R[8:20, :] = 140
    got = _ncc_check(L, R, 8, 3, "ignore")
    assert (got[:, 4:28, 3:16] == -2.0).all()


def test_ncc_volume_committed_range_row():
    """The committed D=200 (`NCC_main.cpp:18`), which JAX's own tests never
    reach, on a 48x256 band: 43 % of the volume is the invalid sentinel."""
    L, R, _ = make_pair(48, 256, 60, seed=11)
    got = _ncc_check(L, R, 200, 10, "ignore")
    assert got.shape == (200, 48, 256)
    invalid = torch.arange(256)[None, None, :] - 10 - torch.arange(200)[:, None, None] < 0
    assert (got[invalid.expand_as(got)] == -2.0).all()
    assert invalid.float().mean() > 0.4


def test_ncc_volume_wide_window_close():
    """Above win_size 15 the NCC products' window sums may leave float32's
    exact range, where JAX's matmul and the port's float64 sums round
    differently: within a tolerance."""
    L, R, _ = make_pair(64, 80, 8, seed=12)
    want, _ = jvol.ncc_volume(L, R, 8, 17)
    got, _ = tvol.ncc_volume(*pair_to_torch(L, R, "cpu"), 8, 17)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("win", [2, 10])
def test_ncc_sums_close_to_jax_on_float_inputs(win):
    """Non-integer inputs (a texture plus noise), the same numpy-seeded
    images to both packages: the port's window sums (float64, rounded once)
    against JAX's float32 matmuls, within what the CUDA kernel's sliding
    float32 sums are held to on the card: ``FLOAT_RTOL`` of a sum whose terms
    are of one sign (the squares), and of the sum of the terms' magnitudes
    (at most 128 a term) for the signed sums."""
    rng = np.random.default_rng(14)
    L = (rng.random((40, 56)) * 255.0).astype(np.float32)
    R = (np.roll(L, -3, 1) + rng.random((40, 56)) * 8.0).astype(np.float32)
    lf_t, rf_t, sums = tvol.ncc_sums(_t(L), _t(R), win)
    lf, rf = L - np.float32(128.0), R - np.float32(128.0)
    np.testing.assert_array_equal(lf_t.numpy(), lf)
    np.testing.assert_array_equal(rf_t.numpy(), rf)
    rtol = window_cost_cuda.FLOAT_RTOL
    n = float((2 * win + 1) ** 2)
    for got, x, one_sign in zip(sums, (lf, lf * lf, rf, rf * rf), (False, True, False, True),
                                strict=True):
        want = np.asarray(jvol.box_sum_same(x, win, win))
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=0.0 if one_sign else rtol * n * 128.0)


def test_ncc_sums_cuda_takes_plain_version_on_cpu():
    L, R, _ = make_pair(20, 30, 6, seed=13)
    lt, rt = pair_to_torch(L, R, "cpu")
    before = dict(window_cost_cuda.LAUNCHES)
    got = window_cost_cuda.ncc_sums_cuda(lt, rt, 3)
    assert window_cost_cuda.LAUNCHES == before
    for g, want in zip(got, tvol.ncc_sums(lt, rt, 3)[2], strict=True):
        assert torch.equal(g, want)


def test_ncc_volume_cuda_takes_plain_version_on_cpu():
    L, R, _ = make_pair(20, 30, 6, seed=13)
    lt, rt = pair_to_torch(L, R, "cpu")
    before = dict(window_cost_cuda.LAUNCHES)
    got, interior = window_cost_cuda.ncc_volume_cuda(lt, rt, 6, 3, "sentinel")
    assert window_cost_cuda.LAUNCHES == before
    want, want_in = tvol.ncc_volume(lt, rt, 6, 3, "sentinel")
    assert torch.equal(got, want) and torch.equal(interior, want_in)


# -- the pipelines -------------------------------------------------------------

# test_torch_asw.py's envelopes: the WTA maps >= 99.5 %, post-processed >= 99 %
MIN_AGREE = {"disp_left": 0.995, "disp_right": 0.995, "disp_final": 0.99}


def _agreement(ref, got, fields):
    for f in fields:
        a, b = np.asarray(ref[f]), np.asarray(got[f])
        assert b.shape == a.shape and b.dtype == np.float32
        same = float((a == b).mean())
        print(f"{f}: {same:.4%} of pixels equal")
        assert same >= MIN_AGREE[f], (f, same)


@functools.lru_cache(maxsize=None)
def _port(name, cfg):
    L, R, _ = _golden_pair()
    return result_to_numpy(get_pipeline(name)[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))


@pytest.mark.parametrize("name,cfg,fields", [
    ("sad", SAD_GOLDEN, ("disp_left", "disp_right", "disp_final")),
    ("sad", cfgs.SADConfig(max_disparity=10, winsize=1, subpixel=True, compute_right=True),
     ("disp_left", "disp_right")),
    ("ncc", NCC_GOLDEN, ("disp_left",)),
    ("ncc", cfgs.NCCConfig(disp_range=10, win_size=3, invalid_mode="sentinel"), ("disp_left",)),
], ids=["sad_post", "sad_subpixel_right", "ncc", "ncc_sentinel"])
def test_slice_matches_jax(name, cfg, fields):
    L, R, _ = _golden_pair()
    jres = jax_get_pipeline(name)[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = _port(name, cfg)
    _agreement(jres._asdict(), got._asdict(), fields)
    if getattr(cfg, "run_post", False):
        for f in ("occlusion", "mismatch"):
            np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(jres, f)))


@pytest.mark.parametrize("name,cfg,fields", [
    ("sad", SAD_GOLDEN, ("disp_left", "disp_right", "disp_final")),
    ("ncc", NCC_GOLDEN, ("disp_left",)),
], ids=["sad", "ncc"])
def test_slice_matches_golden(name, cfg, fields):
    z = np.load(GOLDEN)
    _agreement({f: z[f"{name}/{f}"] for f in fields}, _port(name, cfg)._asdict(), fields)


def test_sad_active_at_reference_size_matches_jax():
    """Reference shape (375x450, D=60, the 9x9 window): the active path
    against JAX, and its bad-2.0 against the ground truth
    (tests/test_tpu_smoke.py's limit)."""
    L, R, gt = make_pair(375, 450, 60, seed=0)
    cfg = cfgs.SADConfig()
    jres = jax_get_pipeline("sad")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(get_pipeline("sad")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))
    np.testing.assert_array_equal(got.disp_left, np.asarray(jres.disp_left))
    assert got.disp_right is None
    assert bad_pixel_rate(got.disp_left, gt) <= 0.30


def test_cpu_tensors_launch_no_kernel():
    L, R, _ = make_pair(20, 24, 6, seed=2)
    lt, rt = pair_to_torch(L, R, "cpu")
    before = dict(window_cost_cuda.LAUNCHES)
    res = get_pipeline("sad")[0](lt, rt, SADConfig(max_disparity=6, run_post=True))
    get_pipeline("ncc")[0](lt, rt, NCCConfig(disp_range=6, win_size=2))
    assert window_cost_cuda.LAUNCHES == before
    assert res.disp_final.device.type == "cpu"


@pytest.mark.parametrize("name,cfg,kwargs,match", [
    ("ncc", cfgs.NCCConfig(disp_range=4, variant="shifted", alt_max_offset=6,
                           alt_kernel=2), {}, None),
], ids=["ncc_shifted"])
def test_unported_modes_raise(name, cfg, kwargs, match):
    """The dormant shifted NCC runs in the port and equals JAX's depth map
    bit for bit (its values are integers), with JAX's empty stages."""
    L, R, _ = make_pair(12, 20, 4, seed=0)
    want = jax_get_pipeline(name)[0](jnp.asarray(L), jnp.asarray(R), cfg, **kwargs)
    got, stages = get_pipeline(name)[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg),
                                        return_stages=True, **kwargs)
    assert stages == {} and got.disp_right is None
    np.testing.assert_array_equal(got.disp_left.numpy(), np.asarray(want.disp_left))


@pytest.mark.parametrize("cfg", [
    NCCConfig(disp_range=4, variant="bogus"),
    NCCConfig(disp_range=4, invalid_mode="bogus"),
], ids=["variant", "invalid_mode"])
def test_unknown_ncc_options_rejected(cfg):
    L, R, _ = make_pair(8, 8, 2, seed=0)
    with pytest.raises(ValueError):
        get_pipeline("ncc")[0](*pair_to_torch(L, R, "cpu"), cfg)


@pytest.mark.slow
def test_ncc_at_reference_size_and_committed_range_matches_jax():
    """Reference shape at the committed range (375x450, D=200, the 21x21
    window), the open cell of ROADMAP's "Measurement cells": the port's CPU
    path against JAX within the WTA envelope.  Slow: JAX's eager volume."""
    L, R, gt = make_pair(375, 450, 200, seed=0)
    cfg = cfgs.NCCConfig()
    assert cfg.disp_range == 200
    jres = jax_get_pipeline("ncc")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    got = result_to_numpy(get_pipeline("ncc")[0](*pair_to_torch(L, R, "cpu"), port_cfg(cfg)))
    _agreement(jres._asdict(), got._asdict(), ("disp_left",))
    print(f"bad-2.0 of disp_left: {bad_pixel_rate(got.disp_left, gt)} "
          f"(JAX: {bad_pixel_rate(np.asarray(jres.disp_left), gt)})")
