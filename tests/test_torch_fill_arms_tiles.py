"""NumPy models of the redesigned 8-direction fill and cross arms
(``csrc/post.cu`` ``fill_pass_f32``, ``csrc/aggregate.cu``
``cross_arms_i32``), held against the JAX package on the CPU.

The CUDA kernels run only on a card (``tests/test_torch_kernels_cuda.py``
holds them against their plain versions there).  Each model here follows
its kernel's indexing step by step:

* the fill: the bitsets of a pass's input along the four line families,
  built by 32 x 32 tiles that ballot the flags of 32 rows x 96 columns and
  write each word once (row and column words of the tile, diagonal and
  anti-diagonal words of the lines through its top row where they hold a
  pixel; the searches never read a word no block wrote); the rays'
  searches over a line's words from the pixel outwards, within the cap and
  the line's pixels, in rounds; the found values and the pick by rank, ties
  in ray order; the bits rebuilt from each pass's own input;
* the arms: the grey uint8 kernel (four pixels a thread as the bytes of a
  word, the rows' bytes staged with a pad, unaligned words by funnel
  shifts, integer thresholds, packed bounds, bytewise counts, four offsets
  a step) and the generic kernel (a thread a pixel, eight offsets a group,
  a warp vote between groups), each with the min-1 rule and the band's
  rows clamped into it.

PR 17's per-pixel walks stay in ``tests/test_torch_agg_post_kernels.py``
as models of the same functions.
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
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.ops.kernels import post_cuda
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict

INF = np.float32(np.inf)
CSRC = Path(post_cuda.__file__).parent / "csrc"


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text()).group(1))


# the arm kernels' constants (csrc/aggregate.cu's; the first test holds them
# to the source)
ARM_GROUP, ARM_PACK, ARM_U8_MAX = 8, 4, 252
UNWRITTEN = 1 << 40  # a word no block wrote (the kernel leaves it as it was)


def test_model_constants_are_the_kernels():
    assert [_constant("aggregate.cu", n) for n in ("ARM_GROUP", "ARM_PACK", "ARM_U8_MAX")] == [
        ARM_GROUP, ARM_PACK, ARM_U8_MAX]
    agg = (CSRC / "aggregate.cu").read_text()
    assert "__vabsdiffu4" in agg and "return (max_length + 6) & ~3;" in agg
    post_src = (CSRC / "post.cu").read_text()
    assert "fill_bits_kernel" in post_src and "__ballot_sync" in post_src


# ---------------------------------------------------------------------------
# fill_pass_f32: the bitsets and the rays' searches
# ---------------------------------------------------------------------------


def _fill_value(src, raw, invalid):
    v = np.asarray(src, np.float32)
    return np.where(v == np.float32(invalid), INF, v) if raw else v


def bits_model(src, raw, invalid, writes=None):
    """``fill_bits_kernel`` in NumPy, a block at a time: block (tc, q), tc in
    [-1, nw], ballots the flags of rows [32 q, 32 q + 32) x columns [32 tc -
    32, 32 tc + 64) into three words a row, then writes its tile's row and
    column words (0 <= tc < nw) and the diagonal / anti-diagonal words of
    the lines through (32 q, 32 tc + s), s < 32, where they hold a pixel of
    its rows.  Returns (rows [h, nw], cols [nh, w], diag [nh, nd], anti [nh,
    nd]) as int64 arrays of 32-bit words, UNWRITTEN where no block wrote;
    ``writes`` counts the writes of each word."""
    fin = np.isfinite(_fill_value(src, raw, invalid))
    h, w = fin.shape
    nw, nh, nd = -(-w // 32), -(-h // 32), h + w - 1
    assert h * nw + nh * (w + 2 * nd) == post_cuda.fill_bits_words(h, w)
    rows = np.full((h, nw), UNWRITTEN, np.int64)
    cols = np.full((nh, w), UNWRITTEN, np.int64)
    diag = np.full((nh, nd), UNWRITTEN, np.int64)
    anti = np.full((nh, nd), UNWRITTEN, np.int64)
    count = {} if writes is None else writes
    lane = np.arange(32)
    sl = np.arange(32)[:, None]                        # s, one a row of the arrays below
    weight = np.int64(1) << np.arange(32, dtype=np.int64)

    def store(arr, name, keep, idx, words):
        for (a, b), word in zip(np.stack(idx, -1)[keep].tolist(), words[keep].tolist()):
            arr[a, b] = word
            count[name, (a, b)] = count.get((name, (a, b)), 0) + 1

    for q in range(nh):
        i0 = 32 * q
        for tc in range(-1, nw + 1):
            j0 = 32 * tc
            i = i0 + lane[:, None]
            j = j0 - 32 + np.arange(96)[None, :]
            flags = (i < h) & (j >= 0) & (j < w)           # the rows' three words, bit by bit
            flags &= fin[np.minimum(i, h - 1), np.clip(j, 0, w - 1)]
            tile = 0 <= tc < nw
            s_ = sl[:, 0]
            zero = np.zeros(32, np.int64)
            if tile:   # row s: bits 32..63 of its flags; column j0 + s: bit s of every row
                store(rows, "rows", i0 + s_ < h, (i0 + s_, zero + tc),
                      (flags[:, 32:64] * weight).sum(1))
                store(cols, "cols", j0 + s_ < w, (zero + q, j0 + s_),
                      (flags[:, 32:64].T * weight).sum(1))
            js = j0 + s_                                   # the lines through (i0, j0 + s)
            kd, ka = js - i0 + h - 1, i0 + js
            diag_words = (flags[lane[None, :], 32 + sl + lane[None, :]] * weight).sum(1)
            anti_words = (flags[lane[None, :], 32 + sl - lane[None, :]] * weight).sum(1)
            store(diag, "diag", (js >= -31) & (js <= w - 1) & (kd >= 0), (zero + q, kd),
                  diag_words)
            store(anti, "anti", (js >= 0) & (js <= w + 30) & (ka <= nd - 1), (zero + q, ka),
                  anti_words)
    return rows, cols, diag, anti


def search_model(words, pos, cap, lo_line, hi_line, forward, stats=None):
    """One ray of ``fill_pass_kernel``: positions [lo, hi] within the cap
    and the line's pixels [lo_line, hi_line], its words read from the
    pixel's outwards, one a round; the found position or -1."""
    if forward:
        lo, hi = pos + 1, min(pos + cap, hi_line)
    else:
        lo, hi = max(pos - cap, lo_line), pos - 1
    if lo > hi:
        return -1
    q = (lo if forward else hi) >> 5
    rounds = 0
    while True:
        m = int(words(q))
        assert m != UNWRITTEN, "a search read a word no block wrote"
        rounds += 1
        if q == lo >> 5:
            m &= (0xFFFFFFFF << (lo & 31)) & 0xFFFFFFFF
        if q == hi >> 5:
            m &= 0xFFFFFFFF >> (31 - (hi & 31))
        if m:
            found = q * 32 + ((m & -m).bit_length() - 1 if forward else m.bit_length() - 1)
            break
        if q == (hi if forward else lo) >> 5:
            found = -1
            break
        q += 1 if forward else -1
    if stats is not None:
        stats.append((cap, rounds))
    return found


def sort_model(src, mask, raw, invalid, need_nonfinite, finalize):
    """The tile blocks of ``fill_bits_kernel`` sorting their own pixels: a
    pixel that is no target written as it stays (NaN left for the targets),
    a target appended to the list, block by block, a warp's 32 columns of a
    row at a time."""
    vals = _fill_value(src, raw, invalid)
    h, w = vals.shape
    out = np.full((h, w), np.nan, np.float32)
    targets = []
    for i0 in range(0, h, 32):
        for j0 in range(0, w, 32):
            for r in range(32):
                i = i0 + r
                for j in range(j0, min(j0 + 32, w)):
                    if i >= h:
                        continue
                    v = vals[i, j]
                    target = (mask is None or mask[i, j]) and (not need_nonfinite or
                                                               not np.isfinite(v))
                    if target:
                        targets.append(i * w + j)
                    else:
                        out[i, j] = np.float32(invalid) if finalize and not np.isfinite(v) else v
    assert len(targets) <= h * w < post_cuda.fill_scratch_words(h, w)
    return out, targets


def fill_pass_model(src, mask, raw, invalid, need_nonfinite, second, caps, finalize,
                    bits=None, stats=None):
    """One call of ``fill_pass_f32`` in NumPy: the bitsets of ``src`` (or
    ``bits`` given) and the target list, then a thread a target.  ``stats``
    collects each ray's (cap, words read)."""
    src = np.asarray(src, np.float32)
    h, w = src.shape
    rows, cols, diag, anti = bits_model(src, raw, invalid) if bits is None else bits
    vals = _fill_value(src, raw, invalid)
    out, targets = sort_model(src, mask, raw, invalid, need_nonfinite, finalize)
    for p in targets:
        i, j = divmod(p, w)
        assert np.isnan(out[i, j])                      # each pixel written once
        res = vals[i, j]
        kd, ka = j - i + h - 1, i + j
        line = [lambda q: rows[i, q], lambda q: cols[q, j], lambda q: diag[q, kd],
                lambda q: anti[q, ka]]
        pmin = [0, 0, max(0, i - j), max(0, i - (w - 1 - j))]
        pmax = [w - 1, h - 1, min(h - 1, i + w - 1 - j), min(h - 1, i + j)]
        found, cand = [], []
        for r in range(8):
            f = r >> 1
            fr = search_model(line[f], j if r < 2 else i, caps[0] if r < 4 else caps[1],
                              pmin[f], pmax[f], r % 2 == 0, stats)
            found.append(fr)
            if fr < 0:
                cand.append(np.float32(0))
                continue
            ii, jj = ((i, fr), (i, fr), (fr, j), (fr, j), (fr, j + (fr - i)),
                      (fr, j + (fr - i)), (fr, j - (fr - i)), (fr, j - (fr - i)))[r]
            assert 0 <= ii < h and 0 <= jj < w
            u = src[ii, jj]                             # read raw: the bit says it is valid
            assert np.isfinite(u) and not (raw and u == np.float32(invalid))
            cand.append(u)
        k = sum(f >= 0 for f in found)
        pick = (1 if k > 1 else 0) if second else k // 2
        for r in range(8):                              # rank: below it, ties in ray order
            rank = sum(found[t] >= 0 and (cand[t] < cand[r] or (cand[t] == cand[r] and t < r))
                       for t in range(8))
            if found[r] >= 0 and rank == pick:
                res = cand[r]
        out[i, j] = np.float32(invalid) if finalize and not np.isfinite(res) else res
    return out


def _caps(max_search, h, w):
    if max_search is None:
        return max(h, w), max(h, w)
    axis = max(max_search - 1, 0)
    return axis, int(round(axis * 0.70710678))


def fill_model(disp, occlusion, mismatch, invalid=np.inf, max_search=None, stale=False):
    """``fill_holes_8dir_f32`` in NumPy: three passes, the bits rebuilt from
    each pass's input (``stale``: pass 1's bits reused, which the kernels
    must not do)."""
    d = np.asarray(disp, np.float32)
    caps = _caps(max_search, *d.shape)
    bits = bits_model(d, True, invalid)
    d = fill_pass_model(d, occlusion, True, invalid, True, True, caps, False, bits)
    d = fill_pass_model(d, mismatch, False, invalid, True, False, caps, False,
                        bits if stale else None)
    return fill_pass_model(d, None, False, invalid, True, False, caps, True,
                           bits if stale else None)


def _holes(seed, h, w, share=0.35, invalid=np.inf):
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 10, size=(h // 3 + 1, w // 3 + 1))
    d = np.kron(coarse, np.ones((3, 3)))[:h, :w]
    d = np.where(rng.random((h, w)) < 0.2, rng.integers(0, 10, size=(h, w)), d)
    d = np.where(rng.random((h, w)) < share, invalid, d).astype(np.float32)
    if h > 4:
        d[4, :] = invalid                # a row with no axis candidate
    if w > 6:
        d[:, 6] = invalid                # and a column
    bad = ~np.isfinite(d) | (d == np.float32(invalid))
    occl = bad & (rng.random(d.shape) < 0.5)
    mism = bad & ~occl & (rng.random(d.shape) < 0.7)
    return d, occl, mism


# The shapes of the JAX comparisons (JAX compiles its eager ops once a shape,
# ~20 s on a CPU): a map wider than a word with caps at and past its sides,
# one row, one column, a small odd one
FILL_SHAPE = (24, 40)
FILL_EDGE_SHAPES = [(1, 40), (40, 1), (9, 13)]


def _jax_fill(d, occl, mism, invalid, max_search):
    return np.asarray(jpost.fill_holes_8dir(jnp.asarray(d), jnp.asarray(occl),
                                            jnp.asarray(mism), invalid, max_search))


@pytest.mark.parametrize("shape", [(1, 70), (70, 1), (5, 40), (40, 5), (33, 65), (64, 32),
                                   (40, 97)])
def test_bit_layouts_hold_the_finite_pixels(shape):
    """Every row and column word is written once and holds its line's
    finite pixels (0 beyond the map); every diagonal and anti-diagonal word
    that holds a pixel of the map is written once with the flags of its
    line, including words at the ends of lines shorter than a word; the
    others are never written (and never read: ``search_model`` asserts)."""
    h, w = shape
    d = _holes(3, h, w, share=0.4)[0]
    d[0, 0] = 7.0
    writes = {}
    rows, cols, diag, anti = bits_model(d, False, np.inf, writes)
    assert set(writes.values()) == {1}
    fin = np.isfinite(d)

    def bit(word, b):
        return int(word) >> b & 1

    assert (rows != UNWRITTEN).all() and (cols != UNWRITTEN).all()
    for i in range(h):
        for q in range(rows.shape[1]):
            for b in range(32):
                j = 32 * q + b
                assert bit(rows[i, q], b) == (j < w and fin[i, j])
    for q in range(cols.shape[0]):
        for b in range(32):
            i = 32 * q + b
            for j in range(w):
                assert bit(cols[q, j], b) == (i < h and fin[i, j])
    for family, words, column in (("diag", diag, lambda k, i: k - (h - 1) + i),
                                  ("anti", anti, lambda k, i: k - i)):
        for q in range(words.shape[0]):
            for k in range(h + w - 1):
                pixels = [(32 * q + b, column(k, 32 * q + b)) for b in range(32)]
                inside = [(i, j) for i, j in pixels if i < h and 0 <= j < w]
                assert (words[q, k] != UNWRITTEN) == bool(inside), (family, q, k)
                if inside:
                    for b, (i, j) in enumerate(pixels):
                        assert bit(words[q, k], b) == ((i, j) in inside and fin[i, j])
    # a corner's diagonal holds one pixel, the rest of its word 0
    assert int(diag[0, h - 1]) & 1 == 1 and int(anti[0, 0]) == 1


@pytest.mark.parametrize("raw", [True, False])
def test_bits_read_invalid_as_inf_in_a_raw_pass(raw):
    d = np.array([[1.0, -1.0, 3.0], [-1.0, 2.0, np.inf]], np.float32)
    rows = bits_model(d, raw, -1.0)[0]
    assert [int(x) for x in rows[:, 0]] == ([0b101, 0b010] if raw else [0b111, 0b011])


@pytest.mark.parametrize("caps", [(0, 0), (1, 1), (1, 0), (2, 5), (31, 22), (32, 23),
                                  (33, 23), (40, 40), (200, 200)])
@pytest.mark.parametrize("second", [True, False])
def test_one_pass_model_matches_jax_at_every_cap(caps, second):
    """Cap 0, 1, a diagonal cap apart from the axis one, caps at word
    edges, and caps at and beyond max(H, W): the masks keep each ray to
    its cap; any target mask, finite pixels too."""
    h, w = FILL_SHAPE
    d = _holes(11, h, w, share=0.5)[0]
    target = ~np.isfinite(d) | (np.random.default_rng(2).random(d.shape) < 0.2)
    want = np.asarray(jpost._fill_from_candidates(jnp.asarray(d), jnp.asarray(target), second,
                                                  *caps))
    got = fill_pass_model(d, target, False, np.inf, False, second, caps, False)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("second", [True, False])
def test_one_pass_model_uncapped_matches_jax(second):
    """Uncapped rays (the wrapper's cap max(H, W)) against JAX's None."""
    h, w = FILL_SHAPE
    d = _holes(12, h, w, share=0.6)[0]
    target = ~np.isfinite(d)
    want = np.asarray(jpost._fill_from_candidates(jnp.asarray(d), jnp.asarray(target), second,
                                                  None, None))
    got = fill_pass_model(d, target, False, np.inf, False, second, (max(h, w),) * 2, False)
    np.testing.assert_array_equal(got, want)


def test_ray_search_reads_words_not_pixels():
    """A ray reads at most ceil(cap / 32) + 1 words, an uncapped ray at
    most its line's; the found pixels are the first finite ones."""
    h, w = 20, 300
    d = np.full((h, w), np.inf, np.float32)
    d[:, 0] = d[:, -1] = 3.0
    target = np.zeros((h, w), bool)
    target[10, 150] = True
    for caps in ((40, 28), (w, w)):
        stats = []
        got = fill_pass_model(d, target, False, np.inf, False, False, caps, False, stats=stats)
        for cap, rounds in stats:
            assert rounds <= -(-cap // 32) + 1
        assert max(r for _, r in stats) == (2 if caps[0] == 40 else 6)   # words 4..9 of the row
        assert got[10, 150] == (np.inf if caps[0] == 40 else 3.0)


@pytest.mark.parametrize("max_search", [None, 1, 2, 4, 10, 100])
@pytest.mark.parametrize("invalid", [np.inf, -1.0], ids=["inf", "minus_one"])
def test_fill_model_matches_jax(max_search, invalid):
    d, occl, mism = _holes(18, *FILL_SHAPE, invalid=invalid)
    want = _jax_fill(d, occl, mism, invalid, max_search)
    got = fill_model(d, occl, mism, invalid, max_search)
    np.testing.assert_array_equal(got, want)
    if max_search not in (1,):
        assert (got != d).sum() > 0


def test_fill_needs_each_pass_to_rebuild_its_bits():
    """Pass 1's bits reused by passes 2 and 3 miss the pixels pass 1
    filled: the model that rebuilds matches JAX, the stale one does not."""
    d, occl, mism = _holes(21, *FILL_SHAPE, share=0.5)
    want = _jax_fill(d, occl, mism, np.inf, None)
    np.testing.assert_array_equal(fill_model(d, occl, mism), want)
    assert (fill_model(d, occl, mism, stale=True) != want).any()


@pytest.mark.parametrize("invalid", [np.inf, -1.0], ids=["inf", "minus_one"])
@pytest.mark.parametrize("shape", FILL_EDGE_SHAPES)
def test_fill_model_all_invalid_and_one_valid(invalid, shape):
    h, w = shape
    d = np.full((h, w), invalid, np.float32)
    occl = np.ones((h, w), bool)
    mism = np.zeros((h, w), bool)
    for max_search in (None, 3):
        np.testing.assert_array_equal(fill_model(d, occl, mism, invalid, max_search),
                                      _jax_fill(d, occl, mism, invalid, max_search))
        one = d.copy()
        one[h // 2, w // 2] = 4.0
        got = fill_model(one, occl & (one != 4.0), mism, invalid, max_search)
        np.testing.assert_array_equal(got, _jax_fill(one, occl & (one != 4.0), mism, invalid,
                                                     max_search))
        assert (got == 4.0).sum() > 1


def test_fill_model_matches_the_ports_plain_version():
    d, occl, mism = _holes(5, 20, 33, invalid=-1.0)
    want = tpost._fill_holes_8dir_plain(torch.from_numpy(d), torch.from_numpy(occl),
                                        torch.from_numpy(mism), -1.0, 8).numpy()
    np.testing.assert_array_equal(fill_model(d, occl, mism, -1.0, 8), want)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.sampled_from(FILL_EDGE_SHAPES + [FILL_SHAPE]),
       share=st.sampled_from([0.1, 0.5, 0.95]), max_search=st.sampled_from([None, 1, 2, 6, 40]),
       invalid=st.sampled_from([np.inf, -1.0]))
def test_fill_model_hypothesis(seed, shape, share, max_search, invalid):
    d, occl, mism = _holes(seed, *shape, share=share, invalid=invalid)
    np.testing.assert_array_equal(fill_model(d, occl, mism, invalid, max_search),
                                  _jax_fill(d, occl, mism, invalid, max_search))


# ---------------------------------------------------------------------------
# cross_arms_i32: the grey uint8 kernel and the generic kernel
# ---------------------------------------------------------------------------

DIRS = [(False, -1), (False, 1), (True, -1), (True, 1)]  # left, right, up, down
ONES = 0x01010101


def _arm_limit(inside, pos, sign, gsize, max_length):
    """``arm_limit``: offsets 1..lim are in bounds and within max_length."""
    first_in = (pos + sign >= 0) & (pos + sign <= gsize - 1)
    room = pos if sign < 0 else gsize - 1 - pos
    return np.where(inside & first_in, np.minimum(max_length, room), 0)


def _channel_diff(a, b):
    """The largest |a_c - b_c| over the last axis in float32, NaN if any is
    NaN (the generic kernel's, as torch.amax)."""
    m = np.abs(a[..., 0] - b[..., 0])
    for c in range(1, a.shape[-1]):
        v = np.abs(a[..., c] - b[..., c])
        m = np.where(np.isnan(m) | (v <= m), m, v)
    return m


def generic_arms_model(img, max_length, sec_length, tao1, tao2, row_offset=0, global_rows=None,
                       stats=None):
    """``cross_arms_kernel`` in NumPy: a thread a pixel, a warp 32
    neighbouring pixels of a row, the four directions in turn, ARM_GROUP
    offsets a group (each tested only within the limit), a warp vote before
    each group.  ``stats`` collects the groups each warp ran."""
    x = np.asarray(img)
    h, w = x.shape[:2]
    x = x.reshape(h, w, -1).astype(np.float32)
    global_rows = h if global_rows is None else global_rows
    tao1, tao2 = np.float32(tao1), np.float32(tao2)
    out = np.zeros((4, h, w), np.int32)
    wp = -(-w // 32) * 32
    i = np.arange(h)[:, None, None]
    j = (np.arange(wp) % w if w else np.arange(wp))[None, :].reshape(1, -1, 32)
    jj = np.arange(wp).reshape(1, -1, 32)                        # [1, warps, 32]
    inside = jj < w
    ic, jc = i, np.minimum(jj, w - 1)
    cen = x[ic, jc]
    for k, (vertical, sign) in enumerate(DIRS):
        pos = i + row_offset + 0 * jj if vertical else jj + 0 * i
        gsize = global_rows if vertical else w
        lim = _arm_limit(inside, pos, sign, gsize, max_length)
        arm = np.zeros(lim.shape, np.int64)
        open_ = lim >= 1
        fail1 = np.zeros(lim.shape, bool)
        running = np.ones(lim.shape[:2] + (1,), bool)
        groups = 0
        for o0 in range(1, max_length + 1, ARM_GROUP):
            running &= open_.any(-1, keepdims=True)               # __any_sync
            if not running.any():
                break
            groups += int(running.sum())
            acc = np.zeros(lim.shape, np.int64)
            for t in range(ARM_GROUP):
                o = o0 + t
                live = running & (o <= lim)
                if vertical:
                    at = x[np.clip(ic + sign * o, 0, h - 1) + 0 * jc, jc + 0 * ic]
                else:
                    at = x[ic + 0 * jc, np.clip(jc + sign * o, 0, w - 1) + 0 * ic]
                m = _channel_diff(at, cen)
                tao = tao1 if o <= sec_length else tao2
                acc |= np.where(live & (m <= tao), 1 << t, 0)
                if o == 1:
                    fail1 = np.where(live, m > tao, fail1)
            ones = np.zeros(lim.shape, np.int64)
            for t in range(ARM_GROUP):                            # __ffs(~acc) - 1
                ones += (ones == t) & ((acc >> t) & 1 == 1)
            step = open_ & running
            arm = np.where(step, arm + ones, arm)
            open_ = np.where(step, (ones == ARM_GROUP) & (o0 + ARM_GROUP <= lim), open_)
        border_ok = pos >= 2 if sign < 0 else pos <= gsize - 3
        res = np.where((arm == 0) & fail1 & border_ok, 1, arm).reshape(h, wp)[:, :w]
        out[k] = res
        if stats is not None:
            stats.append(groups)
    return out


def _u8_threshold(tao):
    """``u8_threshold``: |a - b| <= tao iff |a - b| <= it, for integer
    differences; -1 accepts nothing."""
    tao = np.float32(tao)
    return -1 if tao < 0 else 255 if tao >= 255 else int(np.floor(tao))


def _pack(b):
    """Four bytes (the last axis) as a 32-bit word, byte k from bit 8 k."""
    b = np.asarray(b, np.int64) & 0xFF
    return b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24


def _bytes(word):
    return np.stack([(word >> (8 * k)) & 0xFF for k in range(4)], -1)


def u8_arms_model(img, max_length, sec_length, tao1, tao2, row_offset=0, global_rows=None,
                  skew=0, stats=None):
    """``cross_arms_u8_kernel`` in NumPy.  Block (bx, by): columns [128 bx,
    128 bx + 128) of rows [8 by, 8 by + 8), a warp a row, its row's bytes
    [j0 - pad, j0 + 128 + pad + 4) staged, clamped into the image; thread
    (tx, ty) the pixels (i, j + b), j = j0 + 4 tx, b < 4, tested four
    offsets a step while a byte is open and the step starts within the
    largest limit, the bounds applied at the end.  ``skew``: where the
    image's first byte sits in its aligned word (the vertical loads' funnel
    shifts).  ``stats`` collects the steps each direction's slowest thread
    ran."""
    x = np.asarray(img, np.uint8)
    h, w = x.shape
    n = h * w
    global_rows = h if global_rows is None else global_rows
    assert max_length <= ARM_U8_MAX
    t1, t2 = _u8_threshold(tao1), _u8_threshold(tao2)
    pad = (max_length + 6) & ~3
    assert pad >= max_length + 3
    row_words = (128 + 2 * pad) // 4 + 1
    # the image as aligned words from `skew` bytes before its first element
    flat = np.concatenate([np.full(skew, 0xAB, np.uint8), x.reshape(-1),
                           np.full(8, 0xCD, np.uint8)])
    words = _pack(flat[:len(flat) // 4 * 4].reshape(-1, 4))

    def load4(e):
        a = e + skew
        wi, sh = a >> 2, (a & 3) * 8
        lo = words[wi]
        read_hi = (sh != 0) & ((wi + 1) * 4 - skew < n)
        hi = np.where(read_hi, words[np.minimum(wi + 1, len(words) - 1)], 0)
        return ((hi << 32 | lo) >> sh) & 0xFFFFFFFF

    out = np.zeros((4, h, w), np.int32)
    for i0 in range(0, h, 8):
        for j0 in range(0, w, 128):
            r_ = np.minimum(i0 + np.arange(8), h - 1)[:, None]
            c_ = np.clip(j0 - pad + np.arange(4 * row_words), 0, w - 1)[None, :]
            rowwords = _pack(x[r_, c_].reshape(8, row_words, 4))   # each warp's row
            ty, tx = np.arange(8)[:, None], np.arange(32)[None, :]
            i, j = i0 + ty, j0 + 4 * tx                           # [8, 1], [1, 32]
            live = (i < h) & (j < w)
            centre = _bytes(rowwords[ty, (pad + 4 * tx) >> 2])
            for k, (vertical, sign) in enumerate(DIRS):
                lim = np.stack([_arm_limit((j + b < w) & (i < h),
                                           i + row_offset + 0 * j if vertical else j + b + 0 * i,
                                           sign, global_rows if vertical else w, max_length)
                                for b in range(4)], -1)           # [8, 32, 4]
                most = lim.max(-1)
                open_ = np.ones((8, 32, 4), bool)
                arm = np.zeros((8, 32, 4), np.int64)
                first = np.zeros((8, 32, 4), bool)
                steps = np.zeros((8, 32), np.int64)
                for o0 in range(1, max_length + 1, 4):
                    go = live & open_.any(-1) & (o0 <= most)      # a thread's own loop
                    if not go.any():
                        break
                    steps += go
                    for kk in range(4):
                        o = o0 + kk
                        if vertical:
                            r = np.clip(i + sign * o, 0, h - 1)
                            xw = load4(np.where(live, r * w + np.minimum(j, w - 1), 0))
                        else:
                            c = pad + 4 * tx + sign * o + 0 * ty
                            assert (c >= 0).all() and ((c >> 2) + 1 < row_words).all()
                            lo_w, hi_w = rowwords[ty, c >> 2], rowwords[ty, (c >> 2) + 1]
                            xw = ((hi_w << 32 | lo_w) >> ((c & 3) * 8)) & 0xFFFFFFFF
                        t = t1 if o <= sec_length else t2
                        le = (np.abs(_bytes(xw) - centre) <= t) & (t >= 0)   # absdiff, cmple
                        g = go[..., None]
                        if o == 1:
                            first = np.where(g, le, first)
                        open_ = np.where(g, open_ & le, open_)
                        arm = np.where(g, arm + open_, arm)
                assert (arm <= 255).all()
                arm = np.minimum(arm, lim)                        # __vminu4(arm, lim4)
                fail1 = (lim > 0) & ~first
                for b in range(4):
                    jb = j + b
                    pos = i + row_offset + 0 * jb if vertical else jb + 0 * i
                    gsize = global_rows if vertical else w
                    border_ok = pos >= 2 if sign < 0 else pos <= gsize - 3
                    res = np.where((arm[..., b] == 0) & fail1[..., b] & border_ok, 1, arm[..., b])
                    ok = live & (jb < w)
                    out[k, np.broadcast_to(i, ok.shape)[ok],
                        np.broadcast_to(jb, ok.shape)[ok]] = res[ok]
                if stats is not None:
                    stats.append(int(steps.max(initial=0)))
    return out


def arms_model(img, arm_cfg, row_offset=0, global_rows=None, skew=0):
    """``cross_arms_i32``: the u8 kernel for grey uint8 images (max_length
    <= ARM_U8_MAX, thresholds not NaN), the generic kernel otherwise."""
    args = (arm_cfg.max_length, arm_cfg.sec_length, arm_cfg.tao1, arm_cfg.tao2, row_offset,
            global_rows)
    x = np.asarray(img)
    if (x.dtype == np.uint8 and x.ndim == 2 and arm_cfg.max_length <= ARM_U8_MAX
            and not np.isnan(arm_cfg.tao1) and not np.isnan(arm_cfg.tao2)):
        return u8_arms_model(x, *args, skew=skew)
    return generic_arms_model(x, *args)


def _jax_arms(img, arm_cfg, row_offset=0, global_rows=None):
    want = jagg.cross_arms(jnp.asarray(img), arm_cfg, row_offset, global_rows)
    return np.stack([np.asarray(getattr(want, n)) for n in ("left", "right", "up", "down")])


def _arms_case(img, arm_cfg, row_offset=0, global_rows=None, skew=0):
    got = arms_model(img, arm_cfg, row_offset, global_rows, skew)
    np.testing.assert_array_equal(got, _jax_arms(img, arm_cfg, row_offset, global_rows))
    return got


def _image(seed, shape, dtype, colour, flat=0.5):
    """Random images with flat patches (long arms) and texture (short)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    base = np.kron(rng.integers(0, 200, size=(h // 9 + 1, w // 9 + 1)), np.ones((9, 9)))[:h, :w]
    noise = rng.integers(-12, 13, size=(h, w)) * (rng.random((h, w)) > flat)
    g = np.clip(base + noise, 0, 255)
    img = np.stack([g, np.roll(g, 1, 1), g // 2 + 40], -1) if colour else g
    return img.astype(dtype)


def _long_runs(seed, shape):
    """Runs of 70-80 equal columns with sparse noise within tao2."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.kron(rng.integers(0, 200, size=(1, -(-w // 80))), np.ones((h, 80)))[:, :w]
    img = img + rng.integers(-3, 4, size=img.shape) * (rng.random(img.shape) < 0.1)
    return np.clip(img, 0, 255).astype(np.uint8)


ARM_CFG = cfgs.CrossArmConfig()


# The images of the JAX comparisons (JAX compiles once a shape, type and
# max_length, a few seconds each): one row, one column, and 21 rows x 150
# columns (a 128-column block and a part of one, 8-row blocks and a part)
ARM_SHAPES = [(1, 67), (53, 1), (21, 150)]


@pytest.mark.parametrize("colour", [False, True], ids=["grey", "colour"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "float32"])
@pytest.mark.parametrize("shape", ARM_SHAPES)
def test_arms_model_matches_jax(shape, dtype, colour):
    """The default arms (max_length 34) over partial blocks (128 and 32
    columns, 8 rows), one row, one column, u8 and float32, grey and
    colour: grey u8 takes the u8 kernel, the others the generic one."""
    _arms_case(_image(7, shape, dtype, colour), ARM_CFG)


@pytest.mark.parametrize("skew", [0, 1, 2, 3])
@pytest.mark.parametrize("shape", ARM_SHAPES)
def test_u8_arms_model_skewed_rows(shape, skew):
    """Rows that start anywhere in an aligned word (widths 4 does not
    divide, an image whose first byte sits 1-3 bytes into its word, as a
    band view of a larger image): the vertical loads' funnel shifts, and the
    word after read only where it holds an element of the image."""
    _arms_case(_image(13, shape, np.uint8, False), ARM_CFG, skew=skew)


@pytest.mark.parametrize("max_length,sec_length,dtype", [
    (1, 17, np.uint8), (2, 0, np.uint8), (34, 17, np.uint8), (65, 30, np.uint8),
    (130, 200, np.uint8), (252, 100, np.uint8), (253, 100, np.uint8), (34, 17, np.float32),
    (65, 30, np.float32)])
def test_arms_model_lengths(max_length, sec_length, dtype):
    """max_length 1, a step's last offsets past the cap (the u8 kernel's
    pad), groups after the first, the u8 kernel's largest cap (252, bytes)
    and the generic kernel above it (253); tao2 from the first offset
    (sec_length 0) and never (sec_length > max_length)."""
    img = _long_runs(8, ARM_SHAPES[-1]).astype(dtype)
    cfg = cfgs.CrossArmConfig(tao1=30, tao2=8, max_length=max_length, sec_length=sec_length)
    got = _arms_case(img, cfg)
    if max_length >= 65:
        assert (got > 64).any()


@pytest.mark.parametrize("tao1,tao2", [(0, 0), (6.5, 0.5), (-1, 6), (30, -0.5), (255, 300),
                                       (np.inf, 6)])
def test_u8_arms_model_thresholds(tao1, tao2):
    """Float thresholds as the u8 kernel's integers: 0, fractions, below 0
    (nothing accepted, every in-bounds first offset refused), 255 and
    above."""
    img = _image(14, ARM_SHAPES[-1], np.uint8, False, flat=0.3)
    cfg = cfgs.CrossArmConfig(tao1=tao1, tao2=tao2, max_length=34, sec_length=17)
    _arms_case(img, cfg)


@pytest.mark.parametrize("row_offset", [-3, 0, 5])
@pytest.mark.parametrize("kind", ["u8", "colour u8", "float32"])
def test_arms_model_band_clamping(row_offset, kind):
    """A band of rows placed in a taller image: the vertical offsets read
    the band's own rows clamped into it, the rules take global rows (rows
    beyond the image's border for row_offset < 0)."""
    img = _image(9, ARM_SHAPES[-1], np.float32 if kind == "float32" else np.uint8,
                 kind == "colour u8")
    for global_rows in (40, 21 + max(row_offset, 0) + 2):
        _arms_case(img, ARM_CFG, row_offset, global_rows)


@pytest.mark.parametrize("colour", [False, True], ids=["grey", "colour"])
def test_arms_model_nan_pixels(colour):
    """NaN pixels of float images: a NaN difference is neither accepted nor
    a refused first offset (fail1), so the arms keep two predicates."""
    img = _image(10, ARM_SHAPES[-1], np.float32, colour)
    rng = np.random.default_rng(1)
    holes = rng.random(img.shape[:2]) < 0.08
    if colour:
        img[holes, rng.integers(0, 3)] = np.nan
    else:
        img[holes] = np.nan
    got = _arms_case(img, ARM_CFG)
    assert (got[:, holes] == 0).all()


@pytest.mark.parametrize("kind", ["u8", "colour float32"])
def test_arms_model_matches_the_ports_plain_version(kind):
    img = _image(11, (33, 140), np.uint8, kind != "u8")
    if kind != "u8":
        img = img.astype(np.float32) * np.float32(0.75)
    cfg = config_from_dict("CrossArmConfig", dataclasses.asdict(ARM_CFG))
    want = torch.stack(list(tagg._cross_arms_plain(torch.from_numpy(img), cfg))).numpy()
    np.testing.assert_array_equal(arms_model(img, cfg), want)


def test_arms_stop_early_on_texture():
    """On a checkerboard every arm closes at its first offset: a generic
    warp runs one group a direction and a u8 thread one step; on a flat
    image they run to the arms' ends."""
    h, w = ARM_SHAPES[-1]
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    board = np.where((ii + jj) % 2 == 0, 0, 255).astype(np.uint8)
    flat = np.full((h, w), 90, np.uint8)
    a = ARM_CFG
    args = (a.max_length, a.sec_length, a.tao1, a.tao2)
    for img in (board, flat):
        want = _jax_arms(img, a)
        groups, steps = [], []
        np.testing.assert_array_equal(generic_arms_model(img, *args, stats=groups), want)
        np.testing.assert_array_equal(u8_arms_model(img, *args, stats=steps), want)
        if img is board:
            # every warp once a direction, but the top row's up and the bottom's down
            row = -(-w // 32)
            assert groups == [h * row, h * row, (h - 1) * row, (h - 1) * row]
            assert max(steps) == 1
        else:
            assert min(groups) > h * -(-w // 32) and max(steps) == -(-a.max_length // 4)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), shape=st.sampled_from(ARM_SHAPES),
       colour=st.booleans(), dtype=st.sampled_from([np.uint8, np.float32]),
       max_length=st.sampled_from([34, 65]), flat=st.sampled_from([0.0, 0.7, 1.0]),
       band=st.sampled_from([None, (-3, 30), (4, 50)]), skew=st.integers(0, 3))
def test_arms_model_hypothesis(seed, shape, colour, dtype, max_length, flat, band, skew):
    img = _image(seed, shape, dtype, colour, flat)
    cfg = cfgs.CrossArmConfig(tao1=20, tao2=6, max_length=max_length,
                              sec_length=max(max_length // 2, 0))
    ro, rows = band if band else (0, None)
    _arms_case(img, cfg, ro, rows, skew)
