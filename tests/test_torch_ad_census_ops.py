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
    """The public cost functions on CPU tensors run their plain bodies and
    launch nothing."""
    _, _, (lt, rt) = _pair(13, 17, 5, 3)
    before = ad_census_cuda.LAUNCHES
    pairs = [
        (tvol.ad_census_volume(lt, rt, 5, view=view),
         tvol._ad_census_volume_plain(lt, rt, 5, view=view)),
        (tvol.ad_volume(lt, rt, 5, view), tvol._ad_volume_plain(lt, rt, 5, view)),
        (tvol.census_volume(lt, rt, 5, view=view),
         tvol._census_volume_plain(lt, rt, 5, view=view)),
    ]
    assert ad_census_cuda.LAUNCHES == before
    for got, want in pairs:
        assert torch.equal(got, want)


# (h, w, D, seed) beyond CASES for the both-view identities: D > W over two
# disparity chunks, one column, one row, one pixel
EXTRA = [(2, 5, 40, 7), (5, 1, 4, 2), (1, 20, 7, 1), (1, 1, 3, 4)]
EXTRA_IDS = ["2x5_D40", "one_column", "one_row", "one_pixel"]
SIGMA_C, SIGMA_S = 10.0, 30.0      # the volume functions' defaults


def _any_pair(h, w, d, seed):
    """A synthetic scene, or random u8 images where it is too small for one."""
    if min(h, w) == 1:
        rng = np.random.default_rng(seed)
        L, R = (rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(2))
        return L, R, pair_to_torch(L, R, "cpu")
    return _pair(h, w, d, seed)


def _plain_views(lt, rt, d, part):
    """Both plain views of ``part`` ('cost', 'ad' or 'census')."""
    if part == "cost":
        return tvol.ad_census_volumes(lt, rt, d)
    if part == "ad":
        return tvol.ad_volumes(lt, rt, d)
    return tuple(tvol.census_volume(lt, rt, d, view=v) for v in ("left", "right"))


def _pair_values(lt, rt, part):
    """``g[y, a, b]``: the value of left pixel (y, a) against right pixel
    (y, b), as float64 for the integer parts and, for the cost, from the two
    tables the kernel builds for u8 images."""
    ad = np.abs(lt.numpy().astype(np.int64)[:, :, None] - rt.numpy().astype(np.int64)[:, None, :])
    cl = tvol.census_transform(lt)[:, :, None]
    cr = tvol.census_transform(rt)[:, None, :]
    ham = tvol.popcount64(cl ^ cr).numpy()
    if part == "ad":
        return ad.astype(np.float64)
    if part == "census":
        return ham.astype(np.float64)
    tab_ad = 1.0 - torch.exp(-torch.arange(256, dtype=torch.float32) / SIGMA_C)
    tab_ham = 1.0 - torch.exp(-torch.arange(64, dtype=torch.float32) / SIGMA_S)
    return (tab_ad[torch.tensor(ad)] + tab_ham[torch.tensor(ham)]).numpy().astype(np.float64)


@pytest.mark.parametrize("part", ["cost", "ad", "census"])
@pytest.mark.parametrize("h,w,d,seed", CASES + EXTRA, ids=IDS + EXTRA_IDS)
def test_both_views_shift_identity(h, w, d, seed, part):
    """What the kernel's one pass rests on, on the plain volumes: the right
    view at (d, y, x) is the left view at (d, y, x + d) bit for bit wherever
    x + d <= W-1, and in the right clamp triangle (x > W-1-d) it is the value
    of L(y, W-1) against R(y, x) for every d.  The integer parts are held
    exactly there; the cost within 1e-6 (torch's exp on another tensor)."""
    _, _, (lt, rt) = _any_pair(h, w, d, seed)
    vol_l, vol_r = _plain_views(lt, rt, d, part)
    g = _pair_values(lt, rt, part)
    for dd in range(d):
        if dd < w:
            assert torch.equal(vol_r[dd, :, : w - dd], vol_l[dd, :, dd:]), dd
        tri = np.arange(max(w - dd, 0), w)          # x > W-1-d
        want = g[:, w - 1, tri].astype(np.float32)
        got = vol_r[dd][:, tri].numpy()
        if part == "cost":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,w,d,seed", CASES, ids=IDS)
def test_both_view_volumes_match_jax(h, w, d, seed):
    """``ad_census_volumes`` and ``ad_volumes`` against JAX's single-view
    functions for both views: AD exact, the cost within 1e-6."""
    L, R, (lt, rt) = _pair(h, w, d, seed)
    for view, got in zip(("left", "right"), tvol.ad_census_volumes(lt, rt, d), strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(jvol.ad_census_volume(L, R, d, view=view)),
                                   rtol=1e-6, atol=1e-6)
    for view, got in zip(("left", "right"), tvol.ad_volumes(lt, rt, d), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(jvol.ad_volume(L, R, d, view)))


def test_both_view_wrappers_take_plain_version_on_cpu():
    """The both-view functions on CPU tensors run their plain bodies and
    launch nothing."""
    _, _, (lt, rt) = _pair(13, 17, 5, 3)
    before = ad_census_cuda.LAUNCHES
    got = [tvol.ad_census_volumes(lt, rt, 5), tvol.ad_volumes(lt, rt, 5)]
    assert ad_census_cuda.LAUNCHES == before
    want_both = (tvol._ad_census_volumes_plain(lt, rt, 5), tvol._ad_volumes_plain(lt, rt, 5))
    for pair, want in zip(got, want_both, strict=True):
        assert all(torch.equal(a, b) for a, b in zip(pair, want, strict=True))


# The cost kernel's tiling (csrc/ad_census_cost.cu): a block owns TX left
# columns and DC disparities of a row; warp (cg, dg) takes 128 columns (4 a
# lane) and DPW disparities
TX, DC, DPW = 256, 32, 8


def _store_quads(flat, count, e, s, own, xq, lo, hi, base):
    """``store_quads`` of the kernel for one warp, vectorised over its
    lanes: ``own[lane, i]`` is the value of source column ``xq[lane] + i``,
    stored to ``flat[e + column]``; returns nothing, counts every write."""
    lane = np.arange(32)
    prev = np.concatenate([own[:1], own[:-1]])           # __shfl_up_sync by 1
    both = np.concatenate([prev, own], axis=1)            # columns xq-4 .. xq+3
    q = both[:, 4 - s : 8 - s]
    c0 = xq - s
    vec = ((lane > 0) | (s == 0)) & (c0 >= lo) & (c0 + 4 <= hi)
    assert ((base + e + c0[vec]) % 4 == 0).all()         # 16-byte aligned stores
    for i in range(4):
        c = c0 + i
        m = vec | ((c >= lo) & (c < hi) & ((lane > 0) | (i >= s)))
        flat[e + c[m]] = q[m, i]
        np.add.at(count, e + c[m], 1)
    for i in range(4 - s, 4):                            # lane 31's tail
        c = xq[31] + i
        if lo <= c < hi:
            flat[e + c] = own[31, i]
            count[e + c] += 1


def _kernel_model(g, d_range, bases):
    """The index logic of ``cost_kernel``, block by block and warp by warp,
    vectorised over the lanes: which lane computes which value from which
    staged column, which stores it makes (aligned 16-byte stores after the
    shuffle, the scalar ends), and the right clamp triangle it writes
    directly.  ``g[y, a, b]`` gives the value of a pixel pair; ``bases``
    maps each view written to its address in floats modulo 4.  Returns the
    volumes and how often each entry was written."""
    h, w = g.shape[:2]
    views = tuple(bases)
    out = {v: np.full((d_range, h, w), np.nan) for v in views}
    writes = {v: np.zeros((d_range, h, w), np.int64) for v in views}
    flat = {v: out[v].reshape(-1) for v in views}
    nflat = {v: writes[v].reshape(-1) for v in views}
    for x0 in range(0, w, TX):
        for d0 in range(0, d_range, DC):
            cols = np.clip(x0 - d0 - (DC - 1) + np.arange(TX + DC - 1), 0, w - 1)   # r_s
            lcols = np.minimum(x0 + np.arange(TX), w - 1)                             # l_s
            for cg in range(TX // 128):
                xq = x0 + 128 * cg + 4 * np.arange(32)
                for dg in range(DC // DPW):
                    ds = d0 + DPW * dg
                    kb = (xq - x0) + (DC - 1) - (ds - d0)
                    tri_cols = np.maximum(w - 1 - xq[:, None] - np.arange(4), 0)
                    for y in range(h):
                        tri = g[y, w - 1][tri_cols]
                        lpix = lcols[(xq - x0)[:, None] + np.arange(4)]
                        for m in range(DPW):
                            d = ds + m
                            if d >= d_range:
                                break
                            v = g[y, lpix, cols[kb[:, None] + np.arange(4) - m]]
                            e = (d * h + y) * w
                            if "left" in views:
                                s = (bases["left"] + e + xq[0]) % 4
                                _store_quads(flat["left"], nflat["left"], e, s, v, xq, 0, w,
                                             bases["left"])
                            if "right" in views:
                                s = (bases["right"] + e - d + xq[0]) % 4
                                _store_quads(flat["right"], nflat["right"], e - d, s, v, xq, d, w,
                                             bases["right"])
                                c = xq[:, None] + np.arange(4)
                                t = (c < d) & (c < w)
                                at = e + w - 1 - c[t]
                                flat["right"][at] = tri[t]
                                np.add.at(nflat["right"], at, 1)
    return out, writes


# (h, w, D, seed): a few rows of the kernel's edges: several strips and
# disparity chunks with D no multiple of DC or DPW and W % 4 != 0, D > W, one
# row, one column, one pixel
MODEL_CASES = [(13, 17, 5, 3), (9, 6, 10, 5), (3, 300, 70, 6), (4, 131, 33, 7),
               (2, 5, 40, 7), (1, 520, 64, 1), (5, 1, 4, 2), (1, 1, 3, 4)]


@pytest.mark.parametrize("views", ["both", "left", "right"])
@pytest.mark.parametrize("part", ["cost", "ad", "census"])
@pytest.mark.parametrize("h,w,d,seed", MODEL_CASES)
def test_kernel_index_model_matches_plain(h, w, d, seed, part, views):
    """The numpy model of the kernel's index logic writes every entry of
    each requested view exactly once and gives the plain volumes: the
    integer parts exactly, the cost (from the tables) within 1e-6.  Both
    views lie in one allocation, as the wrapper makes them, so the right
    view starts D*H*W floats after the left; a single view is placed at an
    address of 1 or 3 modulo 4 floats."""
    _, _, (lt, rt) = _any_pair(h, w, d, seed)
    bases = {"both": {"left": 0, "right": (d * h * w) % 4}, "left": {"left": 1},
             "right": {"right": 3}}[views]
    out, writes = _kernel_model(_pair_values(lt, rt, part), d, bases)
    for v, want in zip(("left", "right"), _plain_views(lt, rt, d, part), strict=True):
        if v not in bases:
            continue
        assert (writes[v] == 1).all(), (v, np.argwhere(writes[v] != 1)[:5])
        if part == "cost":
            np.testing.assert_allclose(out[v], want.numpy(), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(out[v], want.numpy())


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
