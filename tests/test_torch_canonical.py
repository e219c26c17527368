"""Port parity for the canonical AD-Census components
(``aggregation='cross_two_pass'``): canonical arms, the two-pass cross
aggregation, the tso-scheduled scanline, iterative region voting and the
discontinuity adjustment, each against its JAX counterpart on the same
NumPy inputs (JAX on the CPU) and, where ``tests/test_canonical.py`` has
one, against its NumPy oracle."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_canonical import oracle_canonical_pass, oracle_irv

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import ad_census as jadc
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu.ops import scanline as jscan
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu_torch.models import ad_census as tadc
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.ops import scanline as tscan
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

# A cap below the second-threshold length: L1 = 5 < L2 = 9 never reaches t2
SHORT = cfgs.CrossAggregatorParams(cross_l1=5, cross_l2=9, cross_t1=15, cross_t2=4)


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _t(a):
    return torch.tensor(np.asarray(a))


def _arms_t(arms):
    return tagg.Arms(*[_t(a) for a in arms])


def _image(kind, shape, seed=42):
    """The golden pair's left image (gray, or a colour image built from
    both) cut to ``shape``."""
    L, R, _ = make_pair(48, 64, 10, seed=seed)
    img = L if kind == "gray" else np.stack([L, L // 2 + R // 2, 255 - R], axis=-1)
    return np.ascontiguousarray(img[: shape[0], : shape[1]])


@pytest.mark.parametrize("shape", [(1, 64), (48, 1), (48, 64)], ids=["1xW", "Hx1", "48x64"])
@pytest.mark.parametrize("kind", ["gray", "colour"])
@pytest.mark.parametrize("params", [cfgs.CrossAggregatorParams(), SHORT], ids=["default", "l1_lt_l2"])
def test_canonical_cross_arms_exact(params, kind, shape):
    """int32 arms, equal to JAX's: the growth rules are comparisons of
    exact integer differences."""
    img = _image(kind, shape)
    want = jagg.canonical_cross_arms(jnp.asarray(img), params)
    got = tagg.canonical_cross_arms(_t(img), port_cfg(params))
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if shape == (48, 64):
        assert (got.left > 1).any() and (got.up > 1).any()


def _cross_inputs():
    L, R, _ = make_pair(48, 64, 10, seed=42)
    vol = np.asarray(jvol.ad_census_volume(L, R, 10))
    arms = jagg.canonical_cross_arms(jnp.asarray(L), cfgs.CrossAggregatorParams())
    return vol, arms


# rtol 1e-5 against JAX's direct span sums (its 'auto' path here, band
# matmuls at HIGHEST precision): the port's sums are exact and rounded once.
# Against JAX's 'gather' path an absolute 1e-4 besides: JAX takes each span
# as a difference of float32 prefix sums, and the column prefix of row spans
# (up to 48 x 69 x 2 = 6.6e3) has an ulp of 4.9e-4 before the division by
# the support count.
CROSS_TOL = {"auto": dict(rtol=1e-5, atol=1e-6), "gather": dict(rtol=1e-5, atol=1e-4)}


@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("num_iters", [1, 2, 3, 4])
def test_cross_aggregate_matches_jax(num_iters, horizontal_first):
    """Values within ``CROSS_TOL`` of JAX's 'gather' and 'auto' paths; WTA
    equal on >= 99.5 % of the pixels outside the clamp triangle (x >= D-1:
    inside it several disparities can hold the same costs, exact ties that
    the port's exact sums keep, lowest d winning, and JAX's float32 sums
    break by rounding)."""
    vol, arms = _cross_inputs()
    got = tagg.cross_aggregate(_t(vol), _arms_t(arms), num_iters, horizontal_first).numpy()
    assert got.dtype == np.float32
    for method, tol in CROSS_TOL.items():
        want = np.asarray(jagg.cross_aggregate(jnp.asarray(vol), arms, num_iters,
                                               horizontal_first, method=method))
        np.testing.assert_allclose(got, want, **tol, err_msg=method)
        same = (got.argmin(0) == want.argmin(0))[:, 9:].mean()
        assert same >= 0.995, (method, same)


@pytest.mark.parametrize("method", ["auto", "matmul", "gather", "pixel_major"])
@pytest.mark.parametrize("max_arm,span_cap", [(None, None), (34, 34)])
def test_cross_aggregate_methods_run_one_layout(method, max_arm, span_cap):
    """Every JAX method, ``max_arm`` and ``span_cap`` give the same bits."""
    vol, arms = _cross_inputs()
    tarms = _arms_t(arms)
    got = tagg.cross_aggregate(_t(vol), tarms, 2, True, max_arm, method, span_cap)
    assert torch.equal(got, tagg.cross_aggregate(_t(vol), tarms, 2))


def test_cross_aggregate_rejects_unknown_method():
    vol, arms = _cross_inputs()
    with pytest.raises(ValueError, match="method"):
        tagg.cross_aggregate(_t(vol), _arms_t(arms), method="banded")


def _scanline_inputs(d, h, w, seed):
    """Costs in [0, 2) and images whose steps are small (scale 1), large
    in one image (0.25) or in both (0.1) at tso 15."""
    rng = np.random.default_rng(seed)
    cost = (rng.random((d, h, w)) * 2).astype(np.float32)
    step = rng.choice([3, 40], size=(h, w))
    L = (np.cumsum(step, axis=1) % 256).astype(np.uint8)
    R = ((np.cumsum(rng.choice([3, 40], size=(h, w)), axis=0) + L) % 256).astype(np.uint8)
    return cost, L, R


def _ulps(a, b):
    a = a.astype(np.float32).view(np.int32).astype(np.int64)
    b = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def test_canonical_scale_bit_exact():
    """The three scales (0.1 as float32) where JAX has them; the inputs
    split all three."""
    cost, L, R = _scanline_inputs(6, 9, 11, 0)
    g1 = L.astype(np.float32)
    g2 = np.asarray(jvol.shifted_stack(jnp.asarray(R, jnp.float32), 6, "left")).transpose(1, 0, 2)
    args = (g1, np.concatenate([g1[:1], g1[:-1]]), g2, np.concatenate([g2[:1], g2[:-1]]), 15.0)
    want = np.asarray(jscan.canonical_scale(*map(jnp.asarray, args[:4]), 15.0))
    got = tscan.canonical_scale(*map(_t, args[:4]), 15.0).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    assert set(np.unique(got)) == {np.float32(0.1), np.float32(0.25), np.float32(1.0)}


def test_canonical_pass_matches_jax_and_oracle():
    """Bit-exact with JAX run op by op (``jax.disable_jit()``); within 4 ulp
    of JAX's compiled scan, whose fused loop rounds in another way at a few
    values (1 ulp a pass seen, growing along the path); within rtol/atol
    1e-5 of tests/test_canonical.py's float64 NumPy oracle."""
    rng = np.random.default_rng(0)
    n, d, m = 12, 5, 4
    cost = (rng.random((n, d, m)) * 2).astype(np.float32)
    g1 = (rng.random((n, m)) * 255).astype(np.float32)
    g2 = (rng.random((n, d, m)) * 255).astype(np.float32)
    got = tscan._canonical_pass(_t(cost), _t(g1), _t(g2), 1.0, 3.0, 15.0).numpy()
    args = (jnp.asarray(cost), jnp.asarray(g1), jnp.asarray(g2), 1.0, 3.0, 15.0)
    with jax.disable_jit():
        eager = np.asarray(jscan._canonical_pass(*args))
    np.testing.assert_array_equal(got, eager)
    assert _ulps(got, np.asarray(jscan._canonical_pass(*args))) <= 4
    for lane in range(m):
        want = oracle_canonical_pass(cost[:, :, lane], g1[:, lane], g2[:, :, lane], 1.0, 3.0, 15.0)
        np.testing.assert_allclose(got[:, :, lane], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("d,h,w", [(5, 9, 11), (12, 6, 9)], ids=["W%4=3", "D>W,W%4=1"])
def test_scanline_optimize_canonical_matches_jax(d, h, w, view):
    """Bit-exact with JAX run op by op (``jax.disable_jit()``)."""
    cost, L, R = _scanline_inputs(d, h, w, d + h + w)
    got = tscan.scanline_optimize_canonical(_t(cost), _t(L), _t(R), 1.0, 3.0, 15.0, view)
    assert got.shape == (d, h, w) and got.dtype == torch.float32
    with jax.disable_jit():
        want = jscan.scanline_optimize_canonical(jnp.asarray(cost), jnp.asarray(L),
                                                 jnp.asarray(R), 1.0, 3.0, 15.0, view)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("view", ["left", "right"])
def test_scanline_optimize_canonical_near_compiled_jax(view):
    """Within 8 ulp of JAX's compiled scans (four passes, each a few ulp
    apart at some values, see above; 4 seen); one small geometry, as each
    new shape costs JAX a compile of ~15 s on a CPU."""
    cost, L, R = _scanline_inputs(5, 9, 11, 25)
    got = tscan.scanline_optimize_canonical(_t(cost), _t(L), _t(R), 1.0, 3.0, 15.0, view)
    want = jscan.scanline_optimize_canonical(jnp.asarray(cost), jnp.asarray(L), jnp.asarray(R),
                                             1.0, 3.0, 15.0, view)
    assert _ulps(got.numpy(), np.asarray(want)) <= 8


def _voting_inputs(h=17, w=23, d=10, seed=7):
    rng = np.random.default_rng(seed)
    disp = rng.integers(0, d, (h, w)).astype(np.float32)
    disp[rng.random((h, w)) < 0.35] = np.inf
    img = (rng.random((h, w)) * 40).astype(np.uint8)
    arms = jagg.canonical_cross_arms(jnp.asarray(img), cfgs.CrossAggregatorParams(cross_l1=3,
                                                                                  cross_l2=2))
    return disp, arms


@pytest.mark.parametrize("d_chunk", [None, 1, 3, 8])
def test_iterative_region_voting_exact(d_chunk):
    """Exact against JAX at D=10, monolithic and chunked, and chunked equal
    to monolithic bit for bit (a chunk of 3 does not divide D)."""
    disp, arms = _voting_inputs()
    want = np.asarray(jpost.iterative_region_voting(jnp.asarray(disp), arms, 10, 4.0, 0.4, 2,
                                                    d_chunk=d_chunk))
    got = tpost.iterative_region_voting(_t(disp), _arms_t(arms), 10, 4.0, 0.4, 2, d_chunk=d_chunk)
    np.testing.assert_array_equal(got.numpy(), want)
    mono = tpost.iterative_region_voting(_t(disp), _arms_t(arms), 10, 4.0, 0.4, 2)
    assert torch.equal(got, mono)
    assert np.isinf(disp).sum() > np.isinf(got.numpy()).sum()


def test_iterative_region_voting_matches_oracle():
    """tests/test_canonical.py's NumPy oracle, exactly."""
    disp, arms = _voting_inputs(14, 18, 6, 3)
    arms_np = type(arms)(*[np.asarray(a) for a in arms])
    got = tpost.iterative_region_voting(_t(disp), _arms_t(arms), 6, 4.0, 0.4, 2)
    np.testing.assert_array_equal(got.numpy(), oracle_irv(disp, arms_np, 6, 4.0, 0.4, 2))


def _discontinuity_case(cheaper):
    """tests/test_canonical.py's two cases: a column at disparity 3 between
    columns at 0, with the neighbours' disparity (``"neighbour"``) or its
    own (``"self"``) the cheaper one there."""
    vol = np.full((4, 3, 5), 5.0, np.float32)
    disp = np.zeros((3, 5), np.float32)
    disp[:, 2] = 3.0
    if cheaper == "neighbour":
        vol[0, :, 2], vol[3, :, 2] = 1.0, 4.0
    else:
        vol[3, :, 2] = 1.0
    return disp, vol


@pytest.mark.parametrize("cheaper", ["neighbour", "self"])
def test_discontinuity_adjustment_exact(cheaper):
    disp, vol = _discontinuity_case(cheaper)
    got = tpost.discontinuity_adjustment(_t(disp), _t(vol)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpost.discontinuity_adjustment(
        jnp.asarray(disp), jnp.asarray(vol))))
    expect = disp.copy()
    if cheaper == "neighbour":
        expect[:, 2] = 0.0
    np.testing.assert_array_equal(got, expect)


def test_discontinuity_adjustment_random_exact():
    """Random maps with invalid pixels and out-of-range disparities, on a
    non-contiguous volume (the scanline kernel's layout may be a view)."""
    rng = np.random.default_rng(4)
    vol = rng.random((6, 12, 15)).astype(np.float32)
    disp = rng.integers(-1, 8, (12, 15)).astype(np.float32)
    disp[rng.random((12, 15)) < 0.2] = np.inf
    want = np.asarray(jpost.discontinuity_adjustment(jnp.asarray(disp), jnp.asarray(vol)))
    padded = torch.zeros((6, 12, 16))
    padded[:, :, :15] = _t(vol)
    got = tpost.discontinuity_adjustment(_t(disp), padded[:, :, :15])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != disp).any()


@pytest.mark.parametrize("h,w,d", [(48, 64, 10), (720, 1280, 128), (2160, 3840, 256)])
def test_irv_auto_d_chunk_equals_jax(h, w, d):
    assert tadc.irv_auto_d_chunk(h, w, d) == jadc.irv_auto_d_chunk(h, w, d)
