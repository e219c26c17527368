"""Port parity: the AD-Census cost and aggregation ops of
``stereo_match_traditional_tpu_torch`` against the JAX package on the same
seeded NumPy inputs (JAX on the CPU backend)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu.config import CrossArmConfig
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.utils.synthetic import make_pair
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import volume as tvol
from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict, pair_to_torch

# (h, w, D, seed): the golden pair's size, an odd shape, and D > W
CASES = [(48, 64, 10, 42), (13, 17, 5, 3), (9, 6, 10, 5)]
IDS = ["48x64_D10", "13x17_D5", "9x6_D10"]
ARMS = CrossArmConfig(tao1=30)     # ADCensusConfig().arms
PORT_ARMS = config_from_dict("CrossArmConfig", dataclasses.asdict(ARMS))


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One small ``torch.exp`` on a permuted tensor before any parity
    check: torch's CPU exp has been seen to return values ~1e-4 off on the
    first call of a process (exp(-0.2) as 0.8188013, in one run of three,
    never on a later call), which is torch's doing, not the port's."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


def _pair(h, w, d, seed):
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    return L, R, pair_to_torch(L, R, "cpu")


@pytest.mark.parametrize("h,w,d,seed", CASES, ids=IDS)
@pytest.mark.parametrize("window", [(9, 7), (3, 5)])
def test_census_transform_bit_exact(h, w, d, seed, window):
    """The int64 signature is JAX's (hi, lo) words packed as
    ``(hi << 32) | (lo & 0xFFFFFFFF)``."""
    L, _, (lt, _) = _pair(h, w, d, seed)
    hi, lo = jvol.census_transform(L, *window)
    want = (np.asarray(hi).astype(np.int64) << 32) | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)
    got = tvol.census_transform(lt, *window)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_census_transform_rejects_wide_window():
    with pytest.raises(ValueError, match="63"):
        tvol.census_transform(torch.zeros((4, 4), dtype=torch.uint8), 8, 8)


def test_popcount64_matches_python():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**63 - 1, size=200, dtype=np.int64)
    x[:3] = [0, 1, 2**63 - 1]
    want = [bin(int(v)).count("1") for v in x]
    np.testing.assert_array_equal(tvol.popcount64(torch.tensor(x)).numpy(), want)


@pytest.mark.parametrize("h,w,d,seed", CASES, ids=IDS)
@pytest.mark.parametrize("view", ["left", "right"])
def test_ad_and_census_volumes_bit_exact(h, w, d, seed, view):
    L, R, (lt, rt) = _pair(h, w, d, seed)
    np.testing.assert_array_equal(tvol.ad_volume(lt, rt, d, view).numpy(),
                                  np.asarray(jvol.ad_volume(L, R, d, view)))
    np.testing.assert_array_equal(tvol.census_volume(lt, rt, d, view=view).numpy(),
                                  np.asarray(jvol.census_volume(L, R, d, view=view)))


@pytest.mark.parametrize("h,w,d,seed", CASES, ids=IDS)
@pytest.mark.parametrize("view", ["left", "right"])
def test_ad_census_volume_matches_jax(h, w, d, seed, view):
    """Same integer parts and the same float operations; only exp's
    last-ulp rounding may differ between the backends: rtol/atol 1e-6."""
    L, R, (lt, rt) = _pair(h, w, d, seed)
    want = np.asarray(jvol.ad_census_volume(L, R, d, view=view))
    got = tvol.ad_census_volume(lt, rt, d, view=view).numpy()
    assert got.shape == (d, h, w) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("view", ["left", "right"])
def test_kernel_wrappers_take_plain_version_on_cpu(view):
    """CPU tensors go to the plain versions and launch nothing."""
    _, _, (lt, rt) = _pair(13, 17, 5, 3)
    before = ad_census_cuda.LAUNCHES
    pairs = [
        (ad_census_cuda.ad_census_volume_cuda(lt, rt, 5, view=view),
         tvol.ad_census_volume(lt, rt, 5, view=view)),
        (ad_census_cuda.ad_volume_cuda(lt, rt, 5, view), tvol.ad_volume(lt, rt, 5, view)),
        (ad_census_cuda.census_volume_cuda(lt, rt, 5, view=view),
         tvol.census_volume(lt, rt, 5, view=view)),
    ]
    assert ad_census_cuda.LAUNCHES == before
    for got, want in pairs:
        assert torch.equal(got, want)


@pytest.mark.parametrize("h,w,d,seed", CASES, ids=IDS)
@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
def test_cross_arms_bit_exact(h, w, d, seed, color):
    L, R, _ = _pair(h, w, d, seed)
    img = np.stack([L, R, L // 2], axis=-1) if color else L
    want = jagg.cross_arms(jnp.asarray(img), ARMS)
    got = tagg.cross_arms(torch.tensor(img), PORT_ARMS)
    for name in ("left", "right", "up", "down"):
        g = getattr(got, name)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)), err_msg=name)


@pytest.mark.parametrize("h,w,d,seed", CASES, ids=IDS)
@pytest.mark.parametrize("inclusive", [True, False], ids=["inclusive", "exclusive"])
def test_rect_mean_aggregate_matches_jax(h, w, d, seed, inclusive):
    """The port sums its SAT in float64, the JAX package in float32 with
    triangular matmuls, so the means differ by JAX's SAT rounding: a few
    ulp of the largest SAT entry (ulp 4.9e-4 at 48x64, where a slice sums
    to ~4e3) -> atol 1e-3, rtol 1e-5; and >= 99.5% argmin agreement."""
    L, R, (lt, _) = _pair(h, w, d, seed)
    vol = np.asarray(jvol.ad_census_volume(L, R, d))
    want = np.asarray(jagg.rect_mean_aggregate(jnp.asarray(vol), jagg.cross_arms(L, ARMS),
                                               inclusive))
    got = tagg.rect_mean_aggregate(torch.tensor(vol), tagg.cross_arms(lt, PORT_ARMS),
                                   inclusive).numpy()
    assert got.shape == vol.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
    assert (got.argmin(0) == want.argmin(0)).mean() >= 0.995
