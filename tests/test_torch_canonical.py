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


@pytest.mark.parametrize("p1,p2,tso", [(1.0, 3.0, 0.0), (0.5, 2.0, 15.0), (0.5, 2.0, 0.0)],
                         ids=["tso0", "p1_0.5_p2_2", "p1_0.5_p2_2_tso0"])
@pytest.mark.parametrize("view", ["left", "right"])
def test_scanline_optimize_canonical_other_parameters_match_jax(p1, p2, tso, view):
    """Bit-exact with unjitted JAX at tso = 0 (every scale 0.1: |dg| >= 0
    always holds, in the clamp triangle too) and at non-default P1 / P2."""
    cost, L, R = _scanline_inputs(12, 6, 9, 31)
    got = tscan.scanline_optimize_canonical(_t(cost), _t(L), _t(R), p1, p2, tso, view)
    with jax.disable_jit():
        want = jscan.scanline_optimize_canonical(jnp.asarray(cost), jnp.asarray(L),
                                                 jnp.asarray(R), p1, p2, tso, view)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# A model of csrc/scanline_canonical.cu's edge bits, in its own index
# arithmetic: the prologue's four bit planes, the words the movers stage for
# a tile, and the funnel shift and bit each walker lane reads at a step.
# Held against the plain version's penalty scales, it checks the kernel's
# indexing without the card.
PAD = 256
SCALES = np.array([1.0, 0.25, 0.1], np.float32)


def _row_words(w):
    return (w + 640 + 31) // 32


def _edge_planes(base, match, tso):
    """The prologue's planes [base h, base v, match h, match v] as uint32
    words [4, H, RW]."""
    h, w = base.shape
    cols = np.arange(_row_words(w) * 32) - PAD
    zero = np.float32(0.0) >= np.float32(tso)

    def horizontal(g):
        inside = (cols >= 1) & (cols < w)
        c = np.where(inside, cols, 1 if w > 1 else 0)
        return np.where(inside, np.abs(g[:, c] - g[:, np.maximum(c - 1, 0)]) >= tso, zero)

    def vertical(g):
        c = np.clip(cols, 0, w - 1)
        out = np.zeros((h, cols.size), bool)
        out[1:] = np.abs(g[1:, c] - g[:-1, c]) >= tso
        return out

    g1, g2 = base.astype(np.float32), match.astype(np.float32)
    bits = np.stack([horizontal(g1), vertical(g1), horizontal(g2), vertical(g2)])
    weights = (np.uint64(1) << np.arange(32, dtype=np.uint64))
    words = (bits.reshape(4, h, -1, 32).astype(np.uint64) * weights).sum(-1)
    return words.astype(np.uint64)


def _funnel(lo, hi, shift):
    return ((int(hi) << 32 | int(lo)) >> (shift & 31)) & 0xFFFFFFFF


def _word(words, i):
    assert 0 <= i < len(words), ("bit row word out of range", i, len(words))
    return int(words[i])


def _k_of(d_range):
    return next(k for k in (1, 2, 4, 8) if d_range <= 32 * k)


def _koff(k, kk, right):
    return k if right else kk - 1 - k


def _model_horizontal(planes, h, w, d_range, right, rev):
    """Scale [W path steps, D, H] that the kernel's horizontal walkers use;
    NaN at the first step and where no lane holds d."""
    kk = _k_of(d_range)
    mb = kk + 4
    ntiles = -(-w // 32)
    head = ntiles * 32 - w if rev else 0
    out = np.full((w, d_range, h), np.nan, np.float32)
    for y in range(h):
        for ti in range(ntiles):
            x0 = (ntiles - 1 - ti if rev else ti) * 32
            w0 = (x0 + PAD) // 32
            stage = ([_word(planes[2, y], w0 - (0 if right else kk) + i) for i in range(mb)]
                     + [_word(planes[0, y], w0 + i) for i in range(2)])
            for lane in range(32):
                lane_bit = lane * kk if right else 32 * kk - lane * kk - (kk - 1)
                for g in range(8):
                    p0 = 32 - 4 * g if rev else 4 * g
                    plo = p0 - 3 if rev else p0
                    b1 = _funnel(stage[mb + (plo >> 5)], stage[mb + (plo >> 5) + 1], plo & 31)
                    for j in range(4):
                        step = 4 * g + j
                        x = x0 + (31 - step if rev else step)
                        t = w - 1 - x if rev else x
                        if ti == 0 and step < head or x >= w or t == 0:
                            continue
                        o1 = b1 >> (3 - j if rev else j) & 1
                        b = (p0 - j if rev else p0 + j) + lane_bit
                        assert 0 <= b >> 5 and (b >> 5) + 1 < mb
                        o2 = _funnel(stage[b >> 5], stage[(b >> 5) + 1], b & 31)
                        for k in range(kk):
                            d = lane * kk + k
                            if d < d_range:
                                out[t, d, y] = SCALES[o1 + (o2 >> _koff(k, kk, right) & 1)]
    return out


def _model_vertical(planes, h, w, d_range, right, bottom_up, xc_block):
    """Scale [H path steps, D, W] that the kernel's vertical walkers use,
    for blocks of ``xc_block`` columns; NaN at the first step."""
    kk = _k_of(d_range)
    mb = kk + 4
    out = np.full((h, d_range, w), np.nan, np.float32)
    for x0 in range(0, w, xc_block):
        mo = (x0 + PAD - (0 if right else 32 * kk - 1)) >> 5
        bo = (x0 + PAD) >> 5
        for s in range(1, h):
            q = h - s if bottom_up else s
            stage = ([_word(planes[3, q], mo + i) for i in range(mb)]
                     + [_word(planes[1, q], bo)])
            for wq in range(xc_block // 4):
                xc = x0 + 4 * wq
                if xc >= w:
                    continue
                o1 = stage[mb] >> (((x0 + PAD) & 31) + 4 * wq)
                for lane in range(32):
                    mbit = xc + PAD + (lane * kk if right else -lane * kk - (kk - 1)) - 32 * mo
                    assert 0 <= mbit >> 5 and (mbit >> 5) + 1 < mb
                    o2 = _funnel(stage[mbit >> 5], stage[(mbit >> 5) + 1], mbit & 31)
                    for n in range(4):
                        for k in range(kk):
                            d = lane * kk + k
                            if xc + n < w and d < d_range:
                                bits = (o1 >> n & 1) + (o2 >> (n + _koff(k, kk, right)) & 1)
                                out[s, d, xc + n] = SCALES[bits]
    return out


def _plain_scales(base, match, d_range, tso, view):
    """The plain version's scales of the four passes, each [path steps, D,
    lines], as ``scanline_optimize_canonical`` builds them."""
    from stereo_match_traditional_tpu_torch.ops.volume import shifted_stack

    g1 = torch.tensor(base, dtype=torch.float32)
    g2 = shifted_stack(torch.tensor(match, dtype=torch.float32), d_range, view)

    def scales(a, b):
        return tscan.canonical_scale(a, torch.cat([a[:1], a[:-1]]), b,
                                     torch.cat([b[:1], b[:-1]]), tso).numpy()

    horiz = (g1.T, g2.permute(2, 0, 1))
    vert = (g1, g2.permute(1, 0, 2))
    return {"lr": scales(*horiz), "rl": scales(*(t.flip(0) for t in horiz)),
            "ud": scales(*vert), "du": scales(*(t.flip(0) for t in vert))}


@pytest.mark.parametrize("tso", [0.0, 15.0, 300.0])
@pytest.mark.parametrize("h,w,d", [(9, 21, 12), (6, 9, 70), (5, 70, 33), (3, 40, 256),
                                   (2, 33, 40)],
                         ids=["K1", "D>W,K4", "K2,3tiles", "D>W,K8", "K2,head31,H2"])
def test_kernel_edge_bit_model_matches_plain_scale(h, w, d, tso):
    """Element for element, the scale the kernel's walkers take at every
    path step after the first, disparity and line, for all four directions,
    both views and both vertical block widths, equals the plain version's
    ``canonical_scale`` (D > W covers the whole clamp triangle)."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_canonical_cuda

    rng = np.random.default_rng(h * w + d)
    left = rng.integers(0, 40, (h, w)).astype(np.uint8)
    right = rng.integers(0, 40, (h, w)).astype(np.uint8)
    for view in ("left", "right"):
        base, match = (left, right) if view == "left" else (right, left)
        planes = _edge_planes(base, match, tso)
        assert planes.size == scanline_canonical_cuda.edge_bit_words(h, w)
        want = _plain_scales(base, match, d, tso, view)
        got = {"lr": _model_horizontal(planes, h, w, d, view == "right", False),
               "rl": _model_horizontal(planes, h, w, d, view == "right", True)}
        for xc_block in (8, 16):
            got["ud"] = _model_vertical(planes, h, w, d, view == "right", False, xc_block)
            got["du"] = _model_vertical(planes, h, w, d, view == "right", True, xc_block)
            for name, g in got.items():
                assert not np.isnan(g[1:]).any() and np.isnan(g[0]).all(), (view, name)
                np.testing.assert_array_equal(g[1:], want[name][1:], err_msg=f"{view} {name}")
        if tso == 15.0:
            assert {float(v) for v in np.unique(want["lr"][1:])} == {float(v) for v in SCALES}


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
