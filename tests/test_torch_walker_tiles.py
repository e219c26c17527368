"""NumPy models of the strip walker of the rect mean and of the tile-local
labelling of the speckle filter (``csrc/aggregate.cu``
``rect_mean_walker_f32``, ``csrc/post.cu`` ``remove_speckles_f32``), held
against the JAX package on the CPU; and the cap on the arms, ``max_span``,
passed where the JAX package passes it.

The CUDA kernels run only on a card (``tests/test_torch_kernels_cuda.py``
holds them against their plain versions there).  Each model here follows
its kernel's indexing step by step: the walker's pre-pass carries at the
strips' halo edges, the ring of 2L + 1 + R table rows (every corner it
reads is checked to be the table row it should be, not one the ring has
overwritten), the emission schedule and the clamped, packed arms; the
speckle filter's tiles labelled alone, the links across tile borders, the
tile roots' counts and the kill.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_pipeline
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu_torch.models import get_pipeline as torch_pipeline
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops.kernels import aggregate_cuda
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

S = aggregate_cuda.WALKER_STRIP
R = 16  # table rows a step: csrc/aggregate.cu's WALK_R
CSRC = Path(aggregate_cuda.__file__).parent / "csrc" / "aggregate.cu"


# ---------------------------------------------------------------------------
# rect_mean_walker_f32: pre-pass, strips, ring
# ---------------------------------------------------------------------------


def walker_model(vol, arms, inclusive, span, strip=S, rows=R):
    """``rect_mean_walker_f32`` in NumPy; returns the means and the number
    of arms outside [0, span] (the device word's increment)."""
    x = np.asarray(vol, np.float32)
    n, h, w = x.shape
    strips = -(-w // strip)
    # pre-pass: each row's float64 prefix at each strip's left halo edge;
    # slice 0's warps pack the arms, clamped, and count the arms outside
    prefix = np.zeros((n, h, w + 1))
    prefix[:, :, 1:] = np.cumsum(x.astype(np.float64), axis=2)
    carries = np.zeros((n, strips, h))
    for k in range(strips):
        if k * strip - span > 0:
            carries[:, k, :] = prefix[:, :, k * strip - span]
    raw = [np.asarray(a, np.int64) for a in (arms.left, arms.right, arms.up, arms.down)]
    left, right, up, down = (np.clip(a, 0, span) for a in raw)
    over = int(sum((np.clip(a, 0, span) != a).sum() for a in raw))
    e = 0 if inclusive else 1
    count = ((up + down + 1) * (left + right + 1) if inclusive
             else (up + down) * (left + right)).astype(np.float32)
    # each pixel's rectangle as the pre-pass packs it: its corners' table
    # rows and columns as offsets from the pixel, each a byte
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    d_up = np.minimum(up, ii)
    d_down = np.minimum(np.maximum(ii + down - e, 0), h - 1) + 1 - ii
    d_left = np.minimum(left, jj)
    d_right = np.minimum(np.maximum(jj + right - e, 0), w - 1) + 1 - jj
    for a in (d_up, d_down, d_left, d_right):
        assert ((0 <= a) & (a <= span + 1)).all()
    ring_rows, cols = 2 * span + 1 + rows, strip + 2 * span + 1
    out = np.full_like(x, np.nan)
    for s in range(n):
        for k in range(strips):
            c0 = k * strip
            jlo = max(c0 - span, 0)
            nin = min(c0 + strip + span, w) - jlo
            ring = np.full((ring_rows, cols), np.nan)
            held = np.full(ring_rows, -1)       # the table row each slot holds
            ring[0, : nin + 1] = 0.0
            held[0] = 0
            acc = np.zeros(nin + 1)
            done = 0
            for step in range(-(-h // rows)):
                t0 = 1 + step * rows
                t1 = min(t0 + rows, h + 1)
                upto = h if t1 - 1 == h else max(t1 - 1 - span, 0)
                for t in range(t0, t1):       # (a) scans from the carries, (b) columns
                    carry = carries[s, k, t - 1] if c0 - span > 0 else 0.0
                    row = carry + np.concatenate([[0.0], np.cumsum(
                        x[s, t - 1, jlo: jlo + nin].astype(np.float64))])
                    acc = acc + row
                    ring[t % ring_rows, : nin + 1] = acc
                    held[t % ring_rows] = t
                for r in range(done, upto):   # (c) the outputs
                    j = np.arange(c0, min(c0 + strip, w))
                    sr = r % ring_rows
                    s0 = sr - d_up[r, j]
                    s0 = np.where(s0 < 0, s0 + ring_rows, s0)
                    s1 = sr + d_down[r, j]
                    s1 = np.where(s1 >= ring_rows, s1 - ring_rows, s1)
                    # the ring holds the plain version's corner rows i0, i1 + 1
                    i0 = np.maximum(r - up[r, j], 0)
                    i1 = np.minimum(np.maximum(r + down[r, j] - e, 0), h - 1)
                    assert (held[s0] == i0).all() and (held[s1] == i1 + 1).all()
                    j0, j1 = j - jlo - d_left[r, j], j - jlo + d_right[r, j]
                    assert (j0 >= 0).all() and (j1 <= nin).all()
                    assert (j0 + jlo == np.maximum(j - left[r, j], 0)).all()
                    total = (((ring[s1, j1] - ring[s0, j1]) - ring[s1, j0])
                             + ring[s0, j0]).astype(np.float32)
                    cnt = count[r, j]
                    mean = total / np.where(cnt > 0, cnt, np.float32(1))
                    out[s, r, j] = np.where(cnt > 0, mean, x[s, r, j])
                done = upto
            assert done == h
    return out, over


def _arms(rng, h, w, span, at_cap=0.3):
    """Random arms in [0, span], a share exactly at the cap, clipped to the
    image as real arms are."""
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    out = []
    for room in (jj, w - 1 - jj, ii, h - 1 - ii):     # left, right, up, down
        a = rng.integers(0, span + 1, size=(h, w))
        a = np.where(rng.random((h, w)) < at_cap, span, a)
        out.append(np.minimum(a, room).astype(np.int32))
    return out


def _jax_means(vol, arms, inclusive, span):
    return np.asarray(jagg.rect_mean_aggregate(
        jnp.asarray(vol), jagg.Arms(*(jnp.asarray(a) for a in arms)), inclusive,
        max_span=span))


def _torch_arms(arms):
    return tagg.Arms(*(torch.from_numpy(a) for a in arms))


# (n, h, w, span, strip, rows): W a multiple of the strip and not, h below
# 2L + 2 and a one-row and a one-column volume, the kernel's strip of 128
# and narrow strips (many strips, halos over several), the cap 0
WALKER_CASES = [
    (3, 29, 300, 6, S, R),       # 128 does not divide 300
    (2, 20, 256, 9, S, R),       # 128 divides 256
    (3, 11, 70, 6, S, R),        # h = 11 < 2L + 2
    (2, 1, 90, 4, S, R),         # one row
    (4, 37, 1, 5, S, R),         # one column
    (3, 30, 41, 7, 8, 3),        # strips narrower than the cap
    (2, 23, 33, 3, 5, 1),        # one table row a step: a ring of 2L + 2
    (2, 17, 19, 0, 4, 2),        # cap 0: one-pixel rectangles
]


@pytest.mark.parametrize("inclusive", [True, False], ids=["inclusive", "exclusive"])
@pytest.mark.parametrize("n,h,w,span,strip,rows", WALKER_CASES)
def test_walker_model_matches_jax(n, h, w, span, strip, rows, inclusive):
    """On integer volumes the JAX package's float32 table is exact too, so
    the model's means are JAX's bit for bit."""
    rng = np.random.default_rng(n * 1000 + h * 7 + w)
    vol = rng.integers(0, 8, size=(n, h, w)).astype(np.float32)
    arms = _arms(rng, h, w, span)
    got, over = walker_model(vol, _torch_arms(arms), inclusive, span, strip, rows)
    assert over == 0
    np.testing.assert_array_equal(got, _jax_means(vol, arms, inclusive, span))


@pytest.mark.parametrize("inclusive", [True, False], ids=["inclusive", "exclusive"])
def test_walker_model_stacked_views_match_jax(inclusive):
    """Both views concatenated along D (cblsm's stacked second pass) share
    the arms: each half equals its own call, and both JAX's."""
    rng = np.random.default_rng(31)
    h, w, span = 26, 133, 8
    left, right = (rng.integers(0, 6, size=(5, h, w)).astype(np.float32) for _ in range(2))
    arms = _arms(rng, h, w, span, at_cap=0.5)
    both, _ = walker_model(np.concatenate([left, right]), _torch_arms(arms), inclusive, span)
    np.testing.assert_array_equal(both[:5], walker_model(left, _torch_arms(arms), inclusive,
                                                         span)[0])
    np.testing.assert_array_equal(both, _jax_means(np.concatenate([left, right]), arms,
                                                   inclusive, span))


@pytest.mark.parametrize("n,h,w,span", [(3, 40, 150, 34), (2, 70, 97, 34), (2, 9, 200, 12)])
def test_walker_model_matches_plain_on_ad_census_costs(n, h, w, span):
    """AD-Census-like costs (0, or multiples of 2^-28 in [0.03, 2)) sum
    exactly in float64 in any order: the model is the port's plain version
    bit for bit, at the main path's cap of 34 too, with the cross arms of
    a real image."""
    rng = np.random.default_rng(h + w)
    vol = np.where(rng.random((n, h, w)) < 0.2, 0.0,
                   np.round((0.0328 + 1.9 * rng.random((n, h, w))) * 2**28) / 2**28)
    vol = vol.astype(np.float32)
    img = rng.integers(0, 255, size=(h, w)).astype(np.uint8)
    arm_cfg = config_from_dict("CrossArmConfig", dataclasses.asdict(
        cfgs.CrossArmConfig(tao1=60, tao2=20, max_length=span)))
    arms = tagg._cross_arms_plain(torch.from_numpy(img), arm_cfg)
    for inclusive in (True, False):
        got, over = walker_model(vol, arms, inclusive, span)
        want = tagg._rect_mean_aggregate_plain(torch.from_numpy(vol), arms, inclusive).numpy()
        assert over == 0
        np.testing.assert_array_equal(got, want)


def test_walker_model_counts_arms_over_the_cap():
    """Arms above the cap are clamped into it and counted: the means are
    those of the clamped arms, and the count is the device word's."""
    rng = np.random.default_rng(4)
    n, h, w, span = 2, 21, 75, 5
    vol = rng.integers(0, 8, size=(n, h, w)).astype(np.float32)
    arms = _arms(rng, h, w, span + 3, at_cap=0.4)
    outside = sum(int((a > span).sum()) for a in arms)
    got, over = walker_model(vol, _torch_arms(arms), True, span)
    assert over == outside > 0
    clamped = [np.minimum(a, span) for a in arms]
    np.testing.assert_array_equal(got, _jax_means(vol, clamped, True, span))


def test_walker_takes_the_caps_that_fit():
    """The route rule: a cap up to 48 (the largest whose ring fits a
    block's shared memory) takes the walker; none, a negative one, a larger
    one or more than 65535 slices keep the chunked-table kernels.  The
    wrapper's strip and cap, and this file's rows a step, are the C
    source's."""
    src = CSRC.read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (WALK_\w+) = (\d+);", src)}
    assert consts["WALK_S"] == aggregate_cuda.WALKER_STRIP == S
    assert consts["WALK_MAX_SPAN"] == aggregate_cuda.WALKER_MAX_SPAN == 48
    assert consts["WALK_R"] == R
    assert aggregate_cuda.walker_takes(34) and aggregate_cuda.walker_takes(0)
    assert aggregate_cuda.walker_takes(48) and not aggregate_cuda.walker_takes(49)
    assert not aggregate_cuda.walker_takes(None) and not aggregate_cuda.walker_takes(-1)
    assert not aggregate_cuda.walker_takes(34, slices=65536)


# ---------------------------------------------------------------------------
# remove_speckles_f32: tiles, border merge, counts
# ---------------------------------------------------------------------------


def _find(labels, x, halve=True):
    curr = labels[x]
    if curr != x:
        prev = x
        while curr > labels[curr]:
            nxt = labels[curr]
            if halve:
                labels[prev] = nxt
            prev, curr = curr, nxt
    return curr


def _unite(labels, a, b):
    while True:
        a, b = _find(labels, a), _find(labels, b)
        if a == b:
            return
        if a < b:
            old = labels[b]
            labels[b] = min(old, a)
            if old == b:
                return
            b = old
        else:
            old = labels[a]
            labels[a] = min(old, b)
            if old == a:
                return
            a = old


def _up_links(v, l, a, b, c, left_p, left_b, left_c, has_l, has_r, conn8, lk):
    """The kernels' ``up_links``: which of p's up, up-left and up-right
    links to unite, leaving out those that other links imply."""
    lb = lk(v, b)
    la = conn8 and has_l and lk(v, a)
    lc = conn8 and has_r and lk(v, c)
    l_a = has_l and lk(l, a)
    return (lb and not (left_p and left_b and l_a),
            la and not ((left_p and l_a) or (lb and left_b)),
            lc and not (lb and left_c))


def tile_speckle_model(disp, diff, min_area, invalid, background=None, connectivity=8,
                       tile=32, order_seed=0):
    """``remove_speckles_f32`` in NumPy: each tile labelled alone (each
    run of left links labelled with its first pixel, then the up links that
    no other link implies united, in a random order), its roots' areas and
    foreground counts; the links across tile borders that no other link
    implies, on the global labels (the merge kernel's three thread rows, in
    a random order); each tile root's counts added at its global root; the
    kill."""
    d = np.asarray(disp, np.float32)
    h, w = d.shape
    rng = np.random.default_rng(order_seed)
    inv = np.float32(invalid)
    conn8 = connectivity == 8

    def ok(v):
        return bool(np.isfinite(v) and v != inv)

    def lk(v, u):
        return ok(v) and ok(u) and bool(np.abs(v - u) <= np.float32(diff))

    def val(i, j):
        return d[i, j] if 0 <= i < h and 0 <= j < w else inv

    valid = np.isfinite(d) & (d != inv)
    fgbit = valid & (background is not None) & (d != np.float32(
        0.0 if background is None else background))
    labels = np.arange(h * w)
    local = np.zeros(h * w, np.int64)      # area | foreground << 16 at tile roots
    for ti0 in range(0, h, tile):
        for tj0 in range(0, w, tile):
            def tv(r, c):                  # inside the tile, else invalid
                return val(ti0 + r, tj0 + c) if 0 <= r < tile and 0 <= c < tile else inv

            lab = list(range(tile * tile))
            for r in range(tile):         # runs of left links, by the ballot
                start = 0
                for c in range(tile):
                    if not (c > 0 and lk(tv(r, c), tv(r, c - 1))):
                        start = c
                    lab[r * tile + c] = r * tile + start
            for l in rng.permutation(tile * tile):
                r, c = divmod(int(l), tile)
                v = tv(r, c)
                if r == 0 or not ok(v):
                    continue
                has_l, has_r = c > 0, c + 1 < tile
                up, up_left, up_right = _up_links(
                    v, tv(r, c - 1), tv(r - 1, c - 1), tv(r - 1, c), tv(r - 1, c + 1),
                    lk(v, tv(r, c - 1)), lk(tv(r - 1, c), tv(r - 1, c - 1)),
                    has_r and lk(tv(r - 1, c + 1), tv(r - 1, c)), has_l, has_r, conn8, lk)
                for go, q in ((up, l - tile), (up_left, l - tile - 1), (up_right, l - tile + 1)):
                    if go:
                        _unite(lab, int(l), int(q))
            stats = np.zeros(tile * tile, np.int64)
            roots = {}
            for l in range(tile * tile):
                r, c = divmod(l, tile)
                i, j = ti0 + r, tj0 + c
                if i < h and j < w and valid[i, j]:
                    x = _find(lab, l, halve=False)
                    roots[l] = x
                    stats[x] += 1 + (int(fgbit[i, j]) << 16)
            for l, x in roots.items():
                r, c = divmod(l, tile)
                p = (ti0 + r) * w + tj0 + c
                labels[p] = (ti0 + x // tile) * w + tj0 + x % tile
                assert labels[p] <= p
                if x == l:
                    local[p] = stats[l]
    # the merge kernel's threads: (ty, tx) of every tile, in a random order
    threads = [(ti0, tj0, ty, tx) for ti0 in range(0, h, tile) for tj0 in range(0, w, tile)
               for ty in range(3) for tx in range(tile)]
    for t in rng.permutation(len(threads)):
        ti0, tj0, ty, tx = threads[t]
        i = ti0 if ty == 0 else ti0 + tx
        j = tj0 + tx if ty == 0 else tj0 if ty == 1 else tj0 + tile - 1
        if i >= h or j >= w or (ty == 2 and tx == 0):
            continue
        p, v = i * w + j, d[i, j]
        if not ok(v):
            continue
        crossing = []
        if ty == 1 and lk(v, val(i, j - 1)):
            crossing.append(p - 1)
        if i > 0 and not (ty == 1 and tx == 0):
            has_l, has_r = j > 0, j + 1 < w
            a, b, c = val(i - 1, j - 1), val(i - 1, j), val(i - 1, j + 1)
            up, up_left, up_right = _up_links(v, val(i, j - 1), a, b, c, lk(v, val(i, j - 1)),
                                              lk(b, a), lk(c, b), has_l, has_r, conn8, lk)
            if ty == 0:
                crossing += [q for go, q in ((up, p - w), (up_left, p - w - 1),
                                             (up_right, p - w + 1)) if go]
            elif ty == 1 and up_left:
                crossing.append(p - w - 1)
            elif ty == 2 and up_right and has_r:
                crossing.append(p - w + 1)
        for q in crossing:
            assert (i // tile, j // tile) != ((q // w) // tile, (q % w) // tile)
            _unite(labels, p, int(q))
    area, fg = np.zeros(h * w, np.int64), np.zeros(h * w, np.int64)   # the 64-bit totals
    for p in rng.permutation(h * w):
        if local[p]:
            r = _find(labels, int(p))
            area[r] += local[p] & 0xFFFF
            fg[r] += local[p] >> 16
    out = d.copy()
    for p in range(h * w):
        i, j = divmod(p, w)
        if valid[i, j]:
            r = p
            while labels[r] != r:
                r = labels[r]
            if area[r] < min_area and (background is None or fg[r] > 0):
                out[i, j] = inv
    return out


def _patches(seed, h, w, levels=6, holes=0.15, invalid=np.inf, patch=3):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, levels, size=(h // patch + 1, w // patch + 1))
    d = np.kron(coarse, np.ones((patch, patch)))[:h, :w]
    d = np.where(rng.random((h, w)) < 0.2, rng.integers(0, levels, size=(h, w)), d)
    return np.where(rng.random((h, w)) < holes, invalid, d).astype(np.float32)


def _held(d, diff, area, invalid, background, connectivity, tile, order_seed=0):
    want = np.asarray(jpost.remove_speckles(jnp.asarray(d), diff, area, invalid_value=invalid,
                                            background=background,
                                            connectivity=connectivity))
    got = tile_speckle_model(d, diff, area, invalid, background, connectivity, tile,
                             order_seed)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("invalid,background", [(np.inf, None), (0.0, None), (np.inf, 0.0)],
                         ids=["inf", "zero", "background"])
@pytest.mark.parametrize("tile", [4, 32])
def test_tile_model_matches_jax(connectivity, invalid, background, tile):
    """Seeded maps with components of many sizes; tiles of 4 make nearly
    every component cross many tiles, tiles of 32 are the kernel's."""
    d = _patches(tile + connectivity, 37, 45, invalid=invalid)
    got = _held(d, 1.0, 9, invalid, background, connectivity, tile, order_seed=tile)
    assert (got != d).any() or background is not None


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("tile", [3, 4, 32])
def test_tile_model_one_component_over_the_map(connectivity, tile):
    """One component covering the whole map, every tile: kept above the
    area, removed below it."""
    d = np.full((23, 30), 5.0, np.float32)
    d[::2, 1::3] = 5.5                    # within diff: still one component
    np.testing.assert_array_equal(_held(d, 1.0, 23 * 30, np.inf, None, connectivity, tile), d)
    assert np.isinf(_held(d, 1.0, 23 * 30 + 1, np.inf, None, connectivity, tile)).all()


@pytest.mark.parametrize("connectivity", [4, 8])
def test_tile_model_serpentine_and_checkerboard(connectivity):
    """A snake winding through every tile row; a checkerboard of single
    pixels (8-connected along its diagonals, alone with 4)."""
    snake = np.zeros((15, 12), np.float32)
    snake[0::2, :] = 5.0
    snake[1::4, -1] = 5.0
    snake[3::4, 0] = 5.0
    np.testing.assert_array_equal(_held(snake, 0.0, 60, 0.0, None, connectivity, 4), snake)
    board = np.where((np.arange(18)[:, None] + np.arange(21)[None, :]) % 2 == 0, 3.0,
                     np.inf).astype(np.float32)
    got = _held(board, 0.0, 2, np.inf, None, connectivity, 4)
    assert np.isinf(got).all() == (connectivity == 4)


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.sampled_from([(1, 13), (11, 1), (9, 14),
                                                              (16, 16), (20, 7)]),
       connectivity=st.sampled_from([4, 8]), area=st.integers(1, 12),
       diff=st.sampled_from([0.0, 1.0, 2.5]), background=st.sampled_from([None, 0.0, 2.0]),
       tile=st.sampled_from([2, 3, 5, 32]))
def test_tile_model_hypothesis(seed, shape, connectivity, area, diff, background, tile):
    d = _patches(seed, *shape, holes=0.2)
    _held(d, diff, area, np.inf, background, connectivity, tile, order_seed=seed)


# ---------------------------------------------------------------------------
# max_span at the port's call sites, as at the JAX package's
# ---------------------------------------------------------------------------


def _spans(monkeypatch, module, fn):
    """The ``max_span`` of every ``module.rect_mean_aggregate`` call that
    ``fn()`` makes."""
    seen = []
    plain = module.rect_mean_aggregate

    def recorded(vol, arms, inclusive=True, max_span=None, layout="auto"):
        seen.append(max_span)
        return plain(vol, arms, inclusive, max_span, layout)

    monkeypatch.setattr(module, "rect_mean_aggregate", recorded)
    fn()
    return seen


@pytest.mark.parametrize("name,kwargs", [
    ("ad_census", {}),
    ("ad_census", {"agg_iters": 2}),
    ("cblsm", {}),
    ("cblsm", {"agg_passes": 2, "second_pass_left_arms": True}),
    ("cblsm", {"agg_passes": 2, "second_pass_left_arms": False}),
], ids=["ad_census", "ad_census_two_iters", "cblsm", "cblsm_stacked", "cblsm_two_passes"])
def test_call_sites_pass_max_span_as_jax_does(monkeypatch, name, kwargs):
    """ad_census and cblsm hand ``max_span=cfg.arms.max_length`` to every
    rect-mean call, as the JAX package's pipelines do, call for call."""
    L, R_, _ = make_pair(12, 20, 6, seed=2)
    jfn, jcls = jax_pipeline(name)
    jcfg = jcls(disp_range=6, **kwargs)
    tfn, _ = torch_pipeline(name)
    tcfg = config_from_dict(type(jcfg).__name__, dataclasses.asdict(jcfg))
    want = _spans(monkeypatch, jagg, lambda: jfn(jnp.asarray(L), jnp.asarray(R_), jcfg))
    got = _spans(monkeypatch, tagg, lambda: tfn(torch.from_numpy(L), torch.from_numpy(R_), tcfg))
    assert got == want and want and set(want) == {jcfg.arms.max_length}
