"""A NumPy model of the cross aggregation's span walker
(``csrc/cross_aggregate.cu`` ``cross_support_f32`` and
``cross_aggregate_f32``),
held to the plain version (``ops.aggregate._cross_aggregate_plain``) on the
CPU; and the cap on the arms, ``span_cap``, passed where the JAX package
passes it.

The CUDA kernel runs only on a card (``tests/test_torch_kernels_cuda.py``
holds it to the plain version there).  The model follows its indexing step
by step: the strips and their halos clamped at the strip's and the image's
edges, the first pass's prefix rows from the halo's first lane, the ring of
table rows (every slot an output reads is checked to hold the table row it
should, not one the ring has overwritten), the rows written at each step
(each output once), both pass orders as one walk with the axes swapped, and
the packed, clamped arms and the supports of the support kernel.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch.config import ADCensusConfig, CBLSMConfig
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import aggregate
from stereo_match_traditional_tpu_torch.ops.kernels import aggregate_cuda
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

CSRC = Path(aggregate_cuda.__file__).parent / "csrc" / "cross_aggregate.cu"
WALKER_H = CSRC.parent / "walker.cuh"


def _source_constant(name: str, src: Path = CSRC) -> int:
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src.read_text()).group(1))


# (S, R) of the instances in the order the host tries them, read from
# launch_cross's launch_cross_walker<H, S, R, NT> calls; the first is tried
# only vertically first, the last takes every cap the others do not
INSTANCES = [tuple(map(int, m)) for m in
             re.findall(r"launch_cross_walker<(?:H|false), (\d+), (\d+), \d+>\(x",
                        CSRC.read_text())]


def shared_bytes(s, r, span, walk, across):
    """``cross_shared_bytes``: ring, prefix rows, two stages, sums."""
    nin = min(s + 2 * span, across)
    ring_rows = min(2 * span + 1 + r, walk + 1)
    return (ring_rows * (s + 1) * 8 + r * ((nin + 1) | 1) * 8 + 2 * r * (nin | 1) * 4
            + r * (s + 1) * 4)


def max_span(s, r):
    """``cross_max_span``: the largest cap whose walker fits a block at
    strip s and step r, at any shape."""
    limit = _source_constant("WALK_SHARED_LIMIT", WALKER_H)
    span = _source_constant("CROSS_MAX_SPAN")
    while span > 0 and shared_bytes(s, r, span, 1 << 30, 1 << 30) > limit:
        span -= 1
    return span


def scan_runs(s, r, span, across):
    """The inputs a lane of the first pass's scan sums at this cap and
    shape (the kernel's ``per``), and the most its registers hold (``PER``,
    from the instance's largest cap)."""
    nin = min(s + 2 * span, across)
    return ((nin + 31) >> 5) | 1, ((s + 2 * max_span(s, r) + 31) >> 5) | 1


def instance(span, walk, across, horizontal_first):
    """The (S, R) the host launches at this cap and pass order (the shape
    does not choose)."""
    tried = INSTANCES[1:] if horizontal_first else INSTANCES
    for s, r in tried[:-1]:
        if span <= max_span(s, r):
            return s, r
    return tried[-1]


def support_model(arms, span):
    """``cross_support_kernel``: the arms clamped into [0, span] and packed,
    the arms outside counted, both supports by the kernel's loops."""
    raw = [np.asarray(a, np.int64) for a in arms]
    left, right, up, down = (np.clip(a, 0, span) for a in raw)
    over = int(sum((np.clip(a, 0, span) != a).sum() for a in raw))
    packed = left | right << 8 | up << 16 | down << 24
    h, w = left.shape
    sup_h = np.zeros((h, w), np.int64)
    sup_v = np.zeros((h, w), np.int64)
    for i in range(h):
        for j in range(w):
            for t in range(max(i - up[i, j], 0), min(i + down[i, j], h - 1) + 1):
                sup_h[i, j] += min(j + right[t, j], w - 1) - max(j - left[t, j], 0) + 1
            for u in range(max(j - left[i, j], 0), min(j + right[i, j], w - 1) + 1):
                sup_v[i, j] += min(i + down[i, u], h - 1) - max(i - up[i, u], 0) + 1
    assert sup_h.max(initial=0) < 2**24 and sup_v.max(initial=0) < 2**24
    return packed, sup_h.astype(np.float32), sup_v.astype(np.float32), over


def walker_model(x, packed, sup, span, horizontal_first, strip, rows):
    """One ``cross_aggregate_f32`` launch in NumPy: x float32 [n, h, w]."""
    H = horizontal_first
    # walk row a, lane b: pixel (a, b) horizontally first, (b, a) vertically
    X = x if H else x.transpose(0, 2, 1)
    P = packed if H else packed.T
    SUP = sup if H else sup.T
    sh1, sh2 = (0, 16) if H else (16, 0)
    n, walk, across = X.shape
    ring_rows = min(2 * span + 1 + rows, walk + 1)
    steps = -(-walk // rows)
    out = np.full(X.shape, np.nan, np.float32)
    written = np.zeros(X.shape, np.int64)
    for s in range(n):
        for b0 in range(0, across, strip):
            blo = max(b0 - span, 0)
            nin = min(b0 + strip + span, across) - blo
            lanes = min(strip, across - b0)
            assert blo >= 0 and blo + nin <= across and nin <= min(strip + 2 * span, across)
            bs = np.arange(b0, b0 + lanes)
            ring = np.full((ring_rows, lanes), np.nan)
            holds = np.full(ring_rows, -1)     # the table row each slot holds
            ring[0], holds[0] = 0.0, 0
            acc = np.zeros(lanes)
            done, slot_t0, slot_done = 0, 1, 0
            for step in range(steps):
                a0 = step * rows
                nrows = min(rows, walk - a0)
                last = a0 + nrows
                upto = walk if last == walk else max(last - span, 0)
                sums = np.zeros((nrows, lanes), np.float32)
                for r in range(nrows):
                    # (a) the prefix of the strip's inputs from lane blo
                    pre = np.zeros(nin + 1)
                    pre[1:] = np.cumsum(X[s, a0 + r, blo:blo + nin].astype(np.float64))
                    # (b) the first pass's picks
                    word = P[a0 + r, bs]
                    lo = np.maximum(bs - ((word >> sh1) & 255), 0) - blo
                    hi = np.minimum(bs + ((word >> (sh1 + 8)) & 255) + 1, across) - blo
                    assert (lo >= 0).all() and (hi <= nin).all() and (lo < hi).all()
                    sums[r] = (pre[hi] - pre[lo]).astype(np.float32)
                # (c) the second pass's table rows, slots by increments
                slot = slot_t0
                for r in range(nrows):
                    acc = acc + sums[r].astype(np.float64)
                    ring[slot], holds[slot] = acc, a0 + r + 1
                    slot = 0 if slot + 1 == ring_rows else slot + 1
                # (d) output rows [done, upto), each slot checked
                for r in range(done, upto):
                    word = P[r, bs]
                    lo = np.maximum(r - ((word >> sh2) & 255), 0)
                    hi = np.minimum(r + ((word >> (sh2 + 8)) & 255) + 1, walk)
                    sr = slot_done + (r - done)
                    assert sr < 2 * ring_rows
                    sr = sr - ring_rows if sr >= ring_rows else sr
                    s0 = sr - (r - lo)
                    s0 = np.where(s0 < 0, s0 + ring_rows, s0)
                    s1 = sr + (hi - r)
                    s1 = np.where(s1 >= ring_rows, s1 - ring_rows, s1)
                    assert (s0 >= 0).all() and (s1 < ring_rows).all()
                    assert (holds[s0] == lo).all() and (holds[s1] == hi).all(), (step, r)
                    lanes_ix = np.arange(lanes)
                    total = (ring[s1, lanes_ix] - ring[s0, lanes_ix]).astype(np.float32)
                    out[s, r, bs] = total / SUP[r, bs]
                    written[s, r, bs] += 1
                slot_done += upto - done
                assert slot_done < 2 * ring_rows
                slot_done = slot_done - ring_rows if slot_done >= ring_rows else slot_done
                done = upto
                slot_t0 += nrows
                while slot_t0 >= ring_rows:
                    slot_t0 -= ring_rows
            assert done == walk
    assert (written == 1).all()
    return out if H else out.transpose(0, 2, 1)


def cross_model(vol, arms, num_iters, horizontal_first, span, strip, rows):
    """``aggregate_cuda.cross_aggregate_cuda``: the support launch, then one
    walker launch an iteration, the pass order flipping."""
    packed, sup_h, sup_v, over = support_model(arms, span)
    out, hf = np.asarray(vol, np.float32), horizontal_first
    for _ in range(num_iters):
        out = walker_model(out, packed, sup_h if hf else sup_v, span, hf, strip, rows)
        hf = not hf
    return out, over


def _ad_census_like(n, h, w, seed):
    """Costs as the AD-Census volumes have them: 0 or float32 values in
    [2^-5, 2), all multiples of 2^-28 (exact float64 sums)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(2**23, 2**29, size=(n, h, w)).astype(np.float64) * 2.0**-28
    v = np.where(rng.random((n, h, w)) < 0.2, 0.0, v).astype(np.float32)
    return v


def _arms(h, w, cap, seed, at_cap=0.3):
    """Random arms in [0, cap], a share exactly at it, clipped to the image
    as real arms are."""
    rng = np.random.default_rng(seed)
    ii, jj = np.arange(h)[:, None], np.arange(w)[None, :]
    out = []
    for room in (jj + 0 * ii, w - 1 - jj + 0 * ii, ii + 0 * jj, h - 1 - ii + 0 * jj):
        a = rng.integers(0, cap + 1, size=(h, w))
        a = np.where(rng.random((h, w)) < at_cap, cap, a)
        out.append(np.minimum(a, room).astype(np.int32))
    return aggregate.Arms(*(torch.from_numpy(a) for a in out))


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))


# (n, h, w, span, strip, rows): strips that the width does not divide, one
# row, one column, a walk shorter than the ring, the cap 0, halos wider than
# the strip, steps longer than the walk, the main path's strip and step
MODEL_CASES = [
    (2, 11, 23, 3, 8, 4), (1, 1, 19, 2, 4, 2), (1, 17, 1, 3, 4, 4), (2, 5, 9, 4, 4, 2),
    (1, 9, 14, 0, 4, 2), (1, 13, 30, 9, 4, 4), (2, 3, 7, 2, 8, 8), (1, 40, 150, 34, 128, 16),
    (1, 20, 45, 6, 16, 8), (1, 70, 90, 34, 128, 32),
]


@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("n,h,w,span,strip,rows", MODEL_CASES)
def test_walker_model_first_iteration_bit_exact(n, h, w, span, strip, rows, horizontal_first):
    """One iteration on AD-Census-like costs: the model equals the plain
    version bit for bit (every float64 sum is exact) and its word is 0."""
    vol = _ad_census_like(n, h, w, seed=n + h + w + span)
    arms = _arms(h, w, span, seed=h * w + span)
    got, over = cross_model(vol, arms, 1, horizontal_first, span, strip, rows)
    want = aggregate._cross_aggregate_plain(torch.from_numpy(vol), arms, 1, horizontal_first)
    assert over == 0
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("num_iters", [2, 3, 4])
@pytest.mark.parametrize("n,h,w,span,strip,rows", MODEL_CASES[:4] + MODEL_CASES[-2:])
def test_walker_model_later_iterations_within_an_ulp(n, h, w, span, strip, rows, num_iters):
    """Later iterations sum float32 means: within one float32 ulp of the
    plain version (its prefix starts at lane 0, the model's at the halo)."""
    vol = _ad_census_like(n, h, w, seed=3 * n + h + w)
    arms = _arms(h, w, span, seed=h + w * span)
    for hf in (True, False):
        got, _ = cross_model(vol, arms, num_iters, hf, span, strip, rows)
        want = aggregate._cross_aggregate_plain(torch.from_numpy(vol), arms, num_iters, hf)
        assert _ulps(got, want.numpy()).max() <= 1


@pytest.mark.parametrize("h,w,span", [(9, 14, 3), (1, 12, 5), (12, 1, 5), (20, 31, 34)])
def test_support_model_matches_plain_supports(h, w, span):
    """The support kernel's loops give the plain version's supports (span
    sums of a plane of ones), exact in float32."""
    arms = _arms(h, w, span, seed=h + w)
    _, sup_h, sup_v, _ = support_model(arms, span)
    ones = torch.ones((h, w))
    want_h = aggregate._vsum(aggregate._hsum(ones, arms.left, arms.right), arms.up, arms.down)
    want_v = aggregate._hsum(aggregate._vsum(ones, arms.up, arms.down), arms.left, arms.right)
    np.testing.assert_array_equal(sup_h, want_h.numpy())
    np.testing.assert_array_equal(sup_v, want_v.numpy())


def test_model_clamps_and_counts_arms_over_the_cap():
    """Arms above the cap: clamped into it and counted; the result is the
    plain version's on the clamped arms."""
    h, w, cap = 14, 26, 3
    arms = _arms(h, w, 7, seed=5)
    vol = _ad_census_like(2, h, w, seed=2)
    got, over = cross_model(vol, arms, 1, True, cap, 8, 4)
    assert over == sum(int((a > cap).sum()) for a in arms) > 0
    clamped = aggregate.Arms(*(a.clamp(max=cap) for a in arms))
    want = aggregate._cross_aggregate_plain(torch.from_numpy(vol), clamped, 1, True)
    np.testing.assert_array_equal(got, want.numpy())


def test_instances_from_the_source():
    """The host's instances, widest first, and the strip it picks by the
    cap and the pass order: 128 at the main path's cap on both pass orders
    (32 rows a step vertically first), 128 up to the largest cap of each
    step, and the narrowest strip for every cap up to 255."""
    assert INSTANCES == [(128, 32), (128, 16), (32, 8)]
    assert _source_constant("CROSS_MAX_SPAN") == aggregate_cuda.CROSS_MAX_SPAN == 255
    assert [max_span(s, r) for s, r in INSTANCES] == [37, 67, 255]
    cap = ADCensusConfig().cross_params.cross_l1
    for h, w in ((375, 1242), (720, 1280), (375, 450)):
        assert instance(cap, h, w, True) == (128, 16)
        assert instance(cap, w, h, False) == (128, 32)
    big = 4000
    assert [instance(c, big, big, False) for c in (37, 38, 67, 68)] == [
        (128, 32), (128, 16), (128, 16), (32, 8)]
    assert [instance(c, big, big, True) for c in (37, 38, 67, 68)] == [
        (128, 16), (128, 16), (128, 16), (32, 8)]
    # a short walk fits a wider halo's ring in a 128-lane block, but not the
    # halo's inputs in its scan lanes' registers: the cap alone chooses
    assert instance(255, 40, 640, True) == instance(100, 57, 300, True) == (32, 8)
    assert instance(255, 40, 300, False) == (32, 8)
    assert instance(60, 60, 400, False) == (128, 16)


# (cap, walk, across): the main path's, each instance's largest cap and the
# first past it, short walks with wide halos, narrow cross axes, one pixel
FIT_CASES = [(c, walk, across) for c in (0, 1, 34, 37, 38, 67, 68, 100, 200, 255)
             for walk, across in ((1, 1), (40, 640), (57, 300), (375, 1242), (1242, 375),
                                  (60, 400), (300, 40), (4000, 4000))]


@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("cap,walk,across", FIT_CASES)
def test_instance_fits_its_block_and_registers(cap, walk, across, horizontal_first):
    """The instance picked at any cap and shape fits the block's shared
    memory at that shape, and each scan lane's inputs fit its registers."""
    s, r = instance(cap, walk, across, horizontal_first)
    assert shared_bytes(s, r, cap, walk, across) <= _source_constant("WALK_SHARED_LIMIT",
                                                                     WALKER_H)
    per, regs = scan_runs(s, r, cap, across)
    assert per <= regs, (s, r, per, regs)


def test_cross_aggregate_cpu_routes_to_plain():
    """On CPU tensors the public function is the plain body, whatever
    ``span_cap``, ``max_arm`` and ``method``, and launches nothing; an
    unknown method raises."""
    vol = torch.from_numpy(_ad_census_like(3, 12, 17, seed=9))
    arms = _arms(12, 17, 4, seed=1)
    want = aggregate._cross_aggregate_plain(vol, arms, 4, True)
    before = dict(aggregate_cuda.LAUNCHES)
    for cap in (None, 4, 255):
        assert torch.equal(aggregate.cross_aggregate(vol, arms, 4, span_cap=cap), want)
        assert torch.equal(aggregate.cross_aggregate(vol, arms, 4, True, cap, "matmul", cap),
                           want)
    assert aggregate_cuda.LAUNCHES == before
    with pytest.raises(ValueError):
        aggregate.cross_aggregate(vol, arms, method="bogus")


@pytest.mark.parametrize("bad", ["dtype", "ndim", "contiguous", "empty", "arms_shape",
                                 "arms_dtype", "cap"])
def test_cross_aggregate_cuda_checks_inputs(bad):
    """The wrapper's checks refuse what the kernel does not take (they run
    before any launch); the cap is span_cap, 255 without one, at most 255."""
    h, w = 6, 9
    vol = torch.zeros((3, h, w))
    arms = _arms(h, w, 2, seed=0)
    assert [aggregate_cuda.cross_checks(vol, arms, c) for c in (None, 0, 34, 255, 300)] == [
        255, 0, 34, 255, 255]
    cap = 34
    if bad == "dtype":
        vol = vol.double()
    elif bad == "ndim":
        vol = vol[0]
    elif bad == "contiguous":
        vol = torch.zeros((3, w, h)).transpose(1, 2)
    elif bad == "empty":
        vol = vol[:0]
    elif bad == "arms_shape":
        arms = aggregate.Arms(*(a[:, :-1] for a in arms))
    elif bad == "arms_dtype":
        arms = aggregate.Arms(*(a.long() for a in arms))
    else:
        cap = -1
    with pytest.raises(ValueError):
        aggregate_cuda.cross_checks(vol, arms, cap)


@pytest.mark.parametrize("pipeline,cfg", [
    ("ad_census", ADCensusConfig(disp_range=8, aggregation="cross_two_pass")),
    ("cblsm", CBLSMConfig(disp_range=8, aggregation="cross_two_pass")),
], ids=["ad_census", "cblsm"])
def test_canonical_pipelines_pass_span_cap(pipeline, cfg, monkeypatch):
    """The direct canonical pipelines pass ``span_cap=cross_l1`` as the JAX
    package does, and their CPU maps are the plain version's."""
    L, R, _ = make_pair(24, 40, 8, seed=2)
    fn = get_pipeline(pipeline)[0]
    lt, rt = torch.from_numpy(L), torch.from_numpy(R)
    before = fn(lt, rt, cfg)
    caps = []
    real = aggregate.cross_aggregate

    def spy(vol, arms, num_iters=4, horizontal_first=True, max_arm=None, method="auto",
            span_cap=None):
        caps.append(span_cap)
        return real(vol, arms, num_iters, horizontal_first, max_arm, method, span_cap)

    monkeypatch.setattr(aggregate, "cross_aggregate", spy)
    after = fn(lt, rt, cfg)
    assert caps == [cfg.cross_params.cross_l1] * 2
    for f in ("disp_left", "disp_right", "disp_final"):
        a, b = getattr(before, f), getattr(after, f)
        assert (a is None and b is None) or torch.equal(a, b), f
