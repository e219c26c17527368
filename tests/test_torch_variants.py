"""Port parity for the dormant variants (ROADMAP.md Queue 1 item 7): the
colour SAD, the shifted NCC, the ASW Lab and grid volumes, the bilateral
filter, the extra WTAs and fills, the block form of the speckle filter, the
CBLSM disparity-conditioned support and arm-region costs, each against the
JAX package on the same seeded inputs (JAX on the CPU backend, unjitted).
The pipelines that reach them: tests/test_torch_variant_pipelines.py.

Tolerances.  Integer-valued results are bit-exact: the colour SAD of u8
images (integer terms and sums), the arm volumes (integer counts), the
fills, the WTAs, the speckle filter and the shifted NCC's depth (an argmax
index; its correlations are formed by the JAX package's operations in its
order, with IEEE divisions and correctly rounded roots).  Float volumes
agree within rtol 1e-5 and on >= 99.5 % of their argmins: ``exp`` and the
summation order differ between the backends (the grid's blurs are float64
products here, float32 at HIGHEST precision in JAX), and the SAT means differ
by JAX's float32 SAT rounding, a few ulp of its largest entry (atol below)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import filters as jfilt
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.ops import wta as jwta
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import filters as tfilt
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.ops import volume as tvol
from stereo_match_traditional_tpu_torch.ops import wta as twta
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict
from stereo_match_traditional_tpu_torch.utils.io import rgb_to_lab_u8
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

RTOL = 1e-5
MIN_ARGMIN = 0.995


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One small ``torch.exp`` on a permuted tensor before any parity
    check: torch's CPU exp has been seen to return values ~1e-4 off on the
    first call of a process, which is torch's doing, not the port's."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


def _t(a):
    return torch.tensor(np.asarray(a))


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _close_volumes(got, want, atol=0.0):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
    assert (got.argmin(0) == want.argmin(0)).mean() >= MIN_ARGMIN


def _colour_pair(h, w, d, seed):
    return make_pair(h, w, d, seed=seed, color=True)


def _arms(img, cfg=None):
    """The JAX package's and the port's cross arms of one image."""
    cfg = cfg or cfgs.CrossArmConfig()
    return jagg.cross_arms(jnp.asarray(img), cfg), tagg.cross_arms(_t(img), port_cfg(cfg))


# -- bit-exact --------------------------------------------------------------


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("h,w,d,winsize,seed", [(10, 14, 5, 1, 0), (7, 5, 9, 0, 3)],
                         ids=["10x14_D5", "D_gt_W"])
def test_sad_volume_channel_min_bit_exact(h, w, d, winsize, seed, view, mean):
    L, R, _ = _colour_pair(h, w, min(d, w - 1), seed)
    want = np.asarray(jvol.sad_volume(L, R, d, winsize, view, mean, True))
    got = tvol.sad_volume(_t(L), _t(R), d, winsize, view, mean, True)
    assert got.shape == (d, h, w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sad_volume_channel_min_needs_colour():
    x = torch.zeros((6, 7), dtype=torch.uint8)
    with pytest.raises(ValueError, match="channel_min"):
        tvol.sad_volume(x, x, 3, 1, "left", True, True)


@pytest.mark.parametrize("view,add_constant,depth_scale", [
    ("left", False, 3), ("right", False, 3), ("left", True, 2), ("right", True, 1)])
def test_ncc_shifted_depth_bit_exact(view, add_constant, depth_scale):
    L, R, _ = make_pair(14, 24, 5, seed=2)
    want = np.asarray(jvol.ncc_shifted_depth(L, R, 7, 2, view, add_constant, depth_scale))
    got = tvol.ncc_shifted_depth(_t(L), _t(R), 7, 2, view, add_constant, depth_scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ncc_shifted_depth_flat_images():
    """Flat images: the quirky divisor ``(rows_in - 1)(cols_in - 1)`` makes
    the "means" differ from the true ones, so no variance is 0 and every
    offset ties; the first wins, as in JAX, bit for bit."""
    x = np.full((9, 12), 77, np.uint8)
    want = np.asarray(jvol.ncc_shifted_depth(x, x, 4, 1))
    got = tvol.ncc_shifted_depth(_t(x), _t(x), 4, 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_steps", [34, 5])
@pytest.mark.parametrize("seed", [0, 1])
def test_cblsm_arm_volumes_bit_exact(seed, max_steps):
    L, R, _ = make_pair(16, 24, 6, seed=seed)
    (jl, tl), (jr, tr) = _arms(L), _arms(R)
    want = jagg.cblsm_arm_volumes(jl, jr, 6, max_steps=max_steps)
    got = tagg.cblsm_arm_volumes(tl, tr, 6, max_steps=max_steps)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _zero_map(seed, h=14, w=19):
    """Disparities with zero holes, whole zero rows and columns among them."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 30, size=(h, w)).astype(np.float32)
    d[rng.random((h, w)) < 0.35] = 0.0
    d[3] = 0.0
    d[:, 0] = 0.0
    d[:, 7] = 0.0
    return d


@pytest.mark.parametrize("name,args", [
    ("fill_image", ()), ("fill_image_second_times", ()), ("fill_image_second_times", (7.0,)),
    ("fill_image_last", ())])
@pytest.mark.parametrize("seed", [0, 1])
def test_fills_bit_exact(name, args, seed):
    d = _zero_map(seed)
    want = np.asarray(getattr(jpost, name)(jnp.asarray(d), *args))
    got = getattr(tpost, name)(_t(d), *args)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_wta_with_cost_and_sum_bit_exact(seed):
    """Ties (repeated slices, integer costs) resolve to the first minimum."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 5, size=(7, 9, 11)).astype(np.float32)
    b = rng.integers(0, 5, size=(7, 9, 11)).astype(np.int32)
    a[4] = a[2]
    jb, jc = jwta.wta_with_cost(jnp.asarray(a))
    tb, tc = twta.wta_with_cost(_t(a))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(twta.wta_sum(_t(b), _t(a)).numpy(),
                                  np.asarray(jwta.wta_sum(jnp.asarray(b), jnp.asarray(a))))


@pytest.mark.parametrize("connectivity", [8, 4])
@pytest.mark.parametrize("block", [2, 5, 16])
def test_remove_speckles_block_bit_exact(block, connectivity):
    """The block form gives JAX's block form and the single-level result."""
    rng = np.random.default_rng(block)
    d = rng.integers(0, 4, size=(30, 37)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = np.inf
    kw = dict(diff_insame=1.0, min_speckle_area=15, connectivity=connectivity)
    want = np.asarray(jpost.remove_speckles(jnp.asarray(d), block=block, **kw))
    got = tpost.remove_speckles(_t(d), block=block, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tpost.remove_speckles(_t(d), **kw).numpy())


# -- within the stated tolerance ---------------------------------------------


@pytest.mark.parametrize("faithful_lut", [False, True])
def test_asw_lab_volume(faithful_lut):
    L, R, _ = make_pair(12, 18, 4, seed=1)
    Lc, Rc, _ = _colour_pair(12, 18, 4, 1)
    ll, rl = rgb_to_lab_u8(Lc), rgb_to_lab_u8(Rc)
    want = jvol.asw_lab_volume(L, R, ll, rl, 5, 1, faithful_lut=faithful_lut)
    got = tvol.asw_lab_volume(_t(L), _t(R), _t(ll), _t(rl), 5, 1, faithful_lut=faithful_lut)
    _close_volumes(got, want)
    assert float(got.max()) <= 40.0        # truncated at the cost level


@pytest.mark.parametrize("bins", [2, 5])
def test_asw_volume_approx_grid(bins):
    L, R, _ = make_pair(14, 20, 5, seed=4)
    want = jvol.asw_volume_approx_grid(L, R, 6, 1, bins=bins)
    got = tvol.asw_volume_approx_grid(_t(L), _t(R), 6, 1, bins=bins)
    _close_volumes(got, want)


def test_asw_volume_approx_grid_needs_two_bins():
    x = torch.zeros((4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bins >= 2"):
        tvol.asw_volume_approx_grid(x, x, 2, 1, bins=1)


@pytest.mark.parametrize("bins", [2, 12, 33])
def test_grid_centres_are_jax_linspace(bins):
    """The centres follow ``jnp.linspace``'s formula with IEEE division; the
    compiled JAX rounds some centres (of 12 bins: two) one ulp apart, so the
    two agree within one ulp."""
    want = np.asarray(jnp.linspace(0.0, 255.0, bins))
    got = np.asarray(tvol._linspace_f32(0.0, 255.0, bins), np.float32)
    assert got[0] == 0.0 and got[-1] == 255.0 and got.shape == want.shape
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("colour", [False, True], ids=["grey", "colour"])
def test_bilateral_filter(colour):
    L = (_colour_pair(13, 17, 4, 5) if colour else make_pair(13, 17, 4, seed=5))[0]
    want = np.asarray(jfilt.bilateral_filter(jnp.asarray(L), 2, 4.0, 12.0))
    got = tfilt.bilateral_filter(_t(L), 2, 4.0, 12.0).numpy()
    assert got.shape == L.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0)


def _sat_atol(vol):
    """A few ulp of JAX's float32 SAT's largest entry: what its rounding
    moves a rectangle sum by (a mean, divided by its count, by less)."""
    return 4.0 * float(np.spacing(np.float32(np.abs(vol).sum(axis=(1, 2)).max())))


@pytest.mark.parametrize("inclusive", [False, True])
def test_rect_mean_aggregate_volume(inclusive):
    L, R, _ = make_pair(16, 22, 6, seed=3)
    (jl, tl), (jr, tr) = _arms(L), _arms(R)
    vol = np.asarray(jvol.ad_volume(L, R, 6))
    jarm = jagg.cblsm_arm_volumes(jl, jr, 6)
    tarm = tagg.cblsm_arm_volumes(tl, tr, 6)
    want = jagg.rect_mean_aggregate_volume(jnp.asarray(vol), *jarm, inclusive=inclusive)
    got = tagg.rect_mean_aggregate_volume(_t(vol), *tarm, inclusive=inclusive)
    _close_volumes(got, want, atol=_sat_atol(vol))


def test_local_mean_cost():
    L, R, _ = make_pair(16, 22, 6, seed=6)
    (jl, tl), (jr, tr) = _arms(L), _arms(R)
    want = jagg.local_mean_cost(jnp.asarray(L), jnp.asarray(R), jl, jr, 6)
    got = tagg.local_mean_cost(_t(L), _t(R), tl, tr, 6)
    _close_volumes(got, want, atol=_sat_atol(L[None].astype(np.float32)))


def test_local_mean_cost_volume():
    L, R, _ = make_pair(16, 22, 6, seed=7)
    (jl, tl), (jr, tr) = _arms(L), _arms(R)
    want = jagg.local_mean_cost_volume(jnp.asarray(L), jnp.asarray(R),
                                       *jagg.cblsm_arm_volumes(jl, jr, 6))
    got = tagg.local_mean_cost_volume(_t(L), _t(R), *tagg.cblsm_arm_volumes(tl, tr, 6))
    _close_volumes(got, want, atol=_sat_atol(L[None].astype(np.float32)))
