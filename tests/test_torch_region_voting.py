"""The canonical iterative region voting: a NumPy model of the CUDA kernel's
indexing (``csrc/region_voting.cu``) held to the plain PyTorch body on the
CPU, and on the card the kernel held to the plain body bit for bit.

This file imports no jax, so on a machine with a card it runs without the
suite's conftest:

    python -m pytest tests/test_torch_region_voting.py -m cuda --noconftest -q

Without a CUDA device every ``cuda`` test skips itself.
"""

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch.config import ADCensusConfig, ScanlineConfig
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import aggregate, post
from stereo_match_traditional_tpu_torch.ops.kernels import post_cuda
from stereo_match_traditional_tpu_torch.utils import profiling
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

INF = float("inf")
CAP = ADCensusConfig().cross_params.cross_l1    # the pipelines' arm cap, 34


def voting_map(h, w, nd, seed, holes=0.3, outside=False):
    """A map of 8 x 8 patches of one disparity, jittered by halves (ties of
    the rounding) and small offsets, with ``holes`` of it invalid (+inf);
    ``outside`` adds values that vote in no bin (below 0, at or above D, a
    -0.5 that rounds into bin 0, NaN)."""
    rng = np.random.default_rng(seed)
    patches = rng.integers(0, nd, size=(h // 8 + 1, w // 8 + 1))
    d = patches.repeat(8, 0).repeat(8, 1)[:h, :w].astype(np.float32)
    d += rng.choice(np.float32([0, 0, 0, 0.5, -0.5, 0.49, 1.5, 0.3]), size=(h, w))
    if outside:
        odd = rng.random((h, w))
        d[odd < 0.05] = -3.0
        d[(odd >= 0.05) & (odd < 0.1)] = nd + 0.5
        d[(odd >= 0.1) & (odd < 0.12)] = nd - 0.5
        d[(odd >= 0.12) & (odd < 0.14)] = -0.5
        d[(odd >= 0.14) & (odd < 0.15)] = np.nan
    d[rng.random((h, w)) < holes] = INF
    return d


def voting_arms(h, w, top, seed):
    """Four int32 arm maps of random lengths in [0, top], in bands of rows
    so that the rows of a region take arms of their own."""
    rng = np.random.default_rng(seed + 1000)
    maps = []
    for _ in range(4):
        a = rng.integers(0, top + 1, size=(h, w))
        a[rng.random((h, w)) < 0.3] = top
        maps.append(a.astype(np.int32))
    return maps


def as_arms(maps, device="cpu"):
    return aggregate.Arms(*(torch.from_numpy(a).to(device) for a in maps))


def plain(disp, maps, nd, ts, th, iters, invalid=INF, device="cpu"):
    return post._iterative_region_voting_plain(
        torch.from_numpy(disp).to(device), as_arms(maps, device), nd, ts, th, iters, invalid)


def host_targets(disp, maps, nd, ts, th, iters, invalid=INF, device="cpu"):
    """The targets the kernel's count kernel takes, counted on the host with
    the plain body an iteration at a time: the pixels invalid at the start
    of each iteration, one count an iteration."""
    d = torch.from_numpy(disp).to(device)
    arms = as_arms(maps, device)
    counts = []
    for _ in range(iters):
        counts.append(int((d == invalid).sum()))
        d = post._iterative_region_voting_plain(d, arms, nd, ts, th, 1, invalid)
    return counts


# -- the NumPy model of the kernel --------------------------------------------

def _lowest_set(x: int) -> int:
    return (x & -x).bit_length() - 1


def _count_row(hist, bins_row, lo, hi):
    """One row of a target's region, as a warp counts it: the span in chunks
    of 32 lanes, a lane past ``hi`` holding -1; the heads of runs of equal
    bins ballotted into a 32-bit word, each head adding the distance to the
    next head (``heads & ~((2 << lane) - 1)``, 32 bits) to its bin."""
    for c in range(lo, hi + 1, 32):
        b = [int(bins_row[c + lane]) if c + lane <= hi else -1 for lane in range(32)]
        heads = 0
        for lane in range(32):
            if lane == 0 or b[lane] != b[lane - 1]:
                heads |= 1 << lane
        for lane in range(32):
            if (heads >> lane) & 1 and b[lane] >= 0:
                after = heads & ~(((2 << lane) - 1) & 0xFFFFFFFF) & 0xFFFFFFFF
                hist[b[lane]] += (_lowest_set(after) if after else 32) - lane


def model_voting(disp, maps, nd, ts, th, iters, invalid=INF):
    """The kernel's indexing in NumPy: the prep kernel's bins, spans and
    target list; each iteration the count kernel (the rows of the target's
    vertical span, each row's span from that row's arms, the bins by run
    heads, the lowest d of the largest bin, float32 tests) and the apply
    kernel (fills written, the rest listed).  Returns the map and the
    iterations' target counts."""
    h, w = disp.shape
    left, right, up, down = (np.maximum(a.astype(np.int64), 0) for a in maps)
    out = disp.astype(np.float32).copy()
    inv = np.float32(invalid)
    target = out == inv
    with np.errstate(invalid="ignore"):
        r = np.rint(out)
        bins = np.where(~target & (r >= 0) & (r < nd), r, -1).astype(np.int16)
    x = np.arange(w)[None, :]
    lo = x - np.minimum(left, x)
    hi = x + np.minimum(right, w - 1 - x)
    todo = list(np.flatnonzero(target.ravel()))
    counts = [len(todo)]
    ts32, th32 = np.float32(ts), np.float32(th)
    for _ in range(iters):
        res = []
        for p in todo:
            y, xx = divmod(int(p), w)
            y0 = y - min(up[y, xx], y)
            y1 = y + min(down[y, xx], h - 1 - y)
            hist = np.zeros(nd, np.int64)
            for yy in range(y0, y1 + 1):
                _count_row(hist, bins[yy], int(lo[yy, xx]), int(hi[yy, xx]))
            total, best = int(hist.sum()), int(hist.max())
            at = int(np.flatnonzero(hist == best)[0])
            tf = np.float32(total)
            res.append(at if tf > ts32 and np.float32(best) > th32 * tf else -1)
        nxt = []
        for p, b in zip(todo, res):
            y, xx = divmod(int(p), w)
            keep = True
            if b >= 0:
                out[y, xx] = np.float32(b)
                if np.float32(b) != inv:
                    bins[y, xx] = b
                    keep = False
            if keep:
                nxt.append(p)
        todo = nxt
        counts.append(len(todo))
    return out, counts[:iters]


# (h, w, D, arm top, ts, th, iterations, seed): one row, one column, caps 0,
# 3, the pipelines' 34 and 255, D from 1 to 290
MODEL_CASES = [
    (1, 70, 6, 34, 2.0, 0.4, 5, 1),
    (70, 1, 6, 34, 2.0, 0.4, 5, 2),
    (24, 40, 1, 3, 4.0, 0.4, 5, 3),
    (24, 40, 60, 0, 0.0, 0.4, 5, 4),
    (24, 40, 60, CAP, 20.0, 0.4, 5, 5),
    (20, 36, 128, 255, 20.0, 0.4, 5, 6),
    (17, 45, 290, 5, 4.0, 0.3, 3, 7),
    (33, 29, 256, 12, 8.0, 0.4, 1, 8),
]


@pytest.mark.parametrize("outside", [False, True], ids=["in_range", "outside"])
@pytest.mark.parametrize("h,w,nd,top,ts,th,iters,seed", MODEL_CASES)
def test_kernel_model_matches_plain(h, w, nd, top, ts, th, iters, seed, outside):
    """The model's maps equal the plain body's bit for bit, and its targets
    an iteration equal the host's count."""
    disp = voting_map(h, w, nd, seed, outside=outside)
    maps = voting_arms(h, w, top, seed)
    got, counts = model_voting(disp, maps, nd, ts, th, iters)
    want = plain(disp, maps, nd, ts, th, iters).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert counts == host_targets(disp, maps, nd, ts, th, iters)


def _row_case(values, left, right, invalid=INF):
    """A one-row map and arms reaching ``left`` / ``right`` pixels, none up
    or down."""
    d = np.float32(values)[None, :]
    w = d.shape[1]
    maps = [np.full((1, w), left, np.int32), np.full((1, w), right, np.int32),
            np.zeros((1, w), np.int32), np.zeros((1, w), np.int32)]
    return d, maps


def edge_cases():
    """(name, disp, arms, D, ts, th, iterations, invalid): the rules the
    kernel has to keep, each with its plain result."""
    cases = []
    # ties: bins 7 and 3 hold 10 votes each; the lowest d wins
    d, m = _row_case([7.0] * 10 + [INF] + [3.0] * 10, 10, 10)
    cases.append(("tie", d, m, 8, 4.0, 0.4, 1, INF))
    # total == ts: 20 votes, ts 20: no fill; 21 votes: a fill
    d, m = _row_case([INF] + [2.0] * 20, 0, 20)
    cases.append(("total_at_ts", d, m, 4, 20.0, 0.4, 1, INF))
    d, m = _row_case([INF] + [2.0] * 21, 0, 21)
    cases.append(("total_above_ts", d, m, 4, 20.0, 0.4, 1, INF))
    # bestv == th * total: 10 of 20 at th 0.5 stays, 11 of 20 fills
    d, m = _row_case([INF] + [1.0] * 10 + [2.0, 3.0] * 5, 0, 20)
    cases.append(("best_at_th", d, m, 4, 4.0, 0.5, 1, INF))
    d, m = _row_case([INF] + [1.0] * 11 + [2.0, 3.0, 0.0] * 3, 0, 20)
    cases.append(("best_above_th", d, m, 4, 4.0, 0.5, 1, INF))
    # no invalid pixel; no valid pixel
    cases.append(("none_invalid", voting_map(30, 40, 16, 11, holes=0.0),
                  voting_arms(30, 40, 6, 11), 16, 4.0, 0.4, 5, INF))
    cases.append(("none_valid", np.full((30, 40), INF, np.float32),
                  voting_arms(30, 40, 6, 12), 16, 4.0, 0.4, 5, INF))
    # a chain: A (x=3) fills from three votes in iteration 1; B (x=4) sees
    # one vote then, A's and one in iteration 2
    d, _ = _row_case([5.0, 5.0, 5.0, INF, INF], 0, 0)
    m = [np.int32([[0, 0, 0, 3, 2]]), np.zeros((1, 5), np.int32),
         np.zeros((1, 5), np.int32), np.zeros((1, 5), np.int32)]
    for iters in (0, 1, 2, 5):
        cases.append((f"chain_{iters}", d, m, 8, 1.0, 0.4, iters, INF))
    # an invalid value the votes can hit (3.4 votes 3): a fill with it leaves
    # the pixel invalid (it neither votes nor stops being a target)
    d, m = _row_case([3.4] * 5 + [3.0] * 3 + [1.0] * 2, 6, 6)
    cases.append(("fill_with_invalid", d, m, 4, 2.0, 0.4, 5, 3.0))
    return cases


EDGE_CASES = edge_cases()


@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_kernel_model_edge_cases(case):
    name, disp, maps, nd, ts, th, iters, invalid = case
    got, counts = model_voting(disp, maps, nd, ts, th, iters, invalid)
    want = plain(disp, maps, nd, ts, th, iters, invalid).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert counts == host_targets(disp, maps, nd, ts, th, iters, invalid)
    expect = {"tie": (0, 10, 3.0), "total_at_ts": (0, 0, INF), "total_above_ts": (0, 0, 2.0),
              "best_at_th": (0, 0, INF), "best_above_th": (0, 0, 1.0),
              "chain_1": (0, 4, INF), "chain_2": (0, 4, 5.0), "fill_with_invalid": (0, 6, 3.0)}
    if name in expect:
        _, x, value = expect[name]
        assert got[0, x] == value, (name, got)


def test_voting_scratch_words_covers_the_c_layout():
    """The C entry's layout: num_iters + 1 counts rounded up to 4 words,
    four words a pixel (span, two lists, decision), an int16 bin a pixel."""
    for h, w, iters in [(1, 1, 1), (375, 1242, 5), (3, 5, 4), (2160, 3840, 7)]:
        n = h * w
        counts = -(-(iters + 1) // 4) * 4
        assert post_cuda.voting_scratch_words(h, w, iters) == counts + 4 * n + -(-n // 2)


def test_kernel_model_lists_the_chain_an_iteration_at_a_time():
    """The chain of two pixels at five iterations: both listed in the
    first, B alone in the second (A filled), none after; a map that fills
    nothing lists its targets in every iteration."""
    name, disp, maps, nd, ts, th, iters, invalid = next(c for c in EDGE_CASES
                                                         if c[0] == "chain_5")
    assert model_voting(disp, maps, nd, ts, th, iters, invalid)[1] == [2, 1, 0, 0, 0]
    name, disp, maps, nd, ts, th, iters, invalid = next(c for c in EDGE_CASES
                                                         if c[0] == "none_valid")
    assert model_voting(disp, maps, nd, ts, th, iters, invalid)[1] == [disp.size] * iters


def test_cpu_map_runs_the_plain_body(monkeypatch):
    """A CPU map takes the plain body, with ``d_chunk``, and never the
    wrapper's C entry."""
    disp = voting_map(20, 30, 12, 3)
    maps = voting_arms(20, 30, 5, 3)
    seen = []
    real = post._iterative_region_voting_plain

    def spy(*a, **k):
        seen.append(a[-1])
        return real(*a, **k)

    monkeypatch.setattr(post, "_iterative_region_voting_plain", spy)
    before = post_cuda.LAUNCHES["region_voting_f32"]
    got = post.iterative_region_voting(torch.from_numpy(disp), as_arms(maps), 12, 4.0, 0.4, 3,
                                       d_chunk=5)
    assert seen == [5] and post_cuda.LAUNCHES["region_voting_f32"] == before
    assert torch.equal(got, real(torch.from_numpy(disp), as_arms(maps), 12, 4.0, 0.4, 3))


# -- the kernel on the card ----------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _hold(disp, maps, nd, ts, th, iters, invalid=INF):
    """The kernel's map against the plain body's on the card, bit for bit;
    its launches and its targets counter against the host's count."""
    d = torch.from_numpy(disp).cuda()
    arms = as_arms(maps, "cuda")
    before = post_cuda.LAUNCHES["region_voting_f32"]
    with profiling.record_spans() as rec:
        got = post.iterative_region_voting(d, arms, nd, ts, th, iters, invalid)
    torch.cuda.synchronize()
    want = post._iterative_region_voting_plain(d, arms, nd, ts, th, iters, invalid)
    assert got.dtype == torch.float32 and got.shape == d.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert post_cuda.LAUNCHES["region_voting_f32"] == before + (iters >= 1)
    host = sum(host_targets(disp, maps, nd, ts, th, iters, invalid, "cuda"))
    assert rec.counters.get("region_voting.targets", 0) == host
    return got


# (h, w, D): one row, one column, Teddy, KITTI, 720p, and D from 1 to 290
CARD_SHAPES = [(1, 3000, 60), (3000, 1, 60), (375, 450, 60), (375, 1242, 128),
               (720, 1280, 128), (96, 200, 1), (96, 200, 256), (120, 300, 290)]


@pytest.mark.cuda
@pytest.mark.parametrize("top", [0, CAP, 255])
@pytest.mark.parametrize("h,w,nd", CARD_SHAPES)
def test_region_voting_kernel_bit_exact_on_card(h, w, nd, top):
    _need_card()
    seed = h * 7 + w + nd + top
    for outside in (False, True):
        _hold(voting_map(h, w, nd, seed, outside=outside), voting_arms(h, w, top, seed), nd,
              20.0, 0.4, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 5])
@pytest.mark.parametrize("ts,th", [(20.0, 0.4), (4.0, 0.3), (0.0, 0.0)])
def test_region_voting_kernel_iterations_on_card(iters, ts, th):
    _need_card()
    disp = voting_map(200, 300, 64, 5, holes=0.6)
    _hold(disp, voting_arms(200, 300, 12, 5), 64, ts, th, iters)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES, ids=[c[0] for c in EDGE_CASES])
def test_region_voting_kernel_edge_cases_on_card(case):
    _need_card()
    name, disp, maps, nd, ts, th, iters, invalid = case
    got = _hold(disp, maps, nd, ts, th, iters, invalid)
    model, _ = model_voting(disp, maps, nd, ts, th, iters, invalid)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), model.view(np.int32))


@pytest.mark.cuda
def test_region_voting_counts_nothing_outside_a_record_on_card(monkeypatch):
    """Outside ``record_spans()`` the wrapper reads nothing back."""
    _need_card()
    disp = torch.from_numpy(voting_map(64, 96, 32, 9)).cuda()
    arms = as_arms(voting_arms(64, 96, 8, 9), "cuda")

    def refuse(*a, **k):
        raise AssertionError("counted outside a record")

    monkeypatch.setattr(profiling, "count", refuse)
    assert not profiling.recording()
    post.iterative_region_voting(disp, arms, 32, 4.0, 0.4, 5)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d", [(48, 80, 16), (375, 1242, 128)])
def test_canonical_full_launches_voting_kernel_on_card(h, w, d, monkeypatch):
    """Canonical FULL votes by one kernel launch a call, never by the plain
    body, and holds no [D, H, W] tensor while it votes; its maps equal
    those of the plain body on the same inputs."""
    _need_card()
    seen = []
    real = post.iterative_region_voting

    def spy(disp, arms, *a, **k):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = real(disp, arms, *a, **k)
        torch.cuda.synchronize()
        seen.append((disp.clone(), arms, a, k, torch.cuda.max_memory_allocated() - base, out))
        return out

    def refuse(*a, **k):
        raise AssertionError("the plain body ran on the card")

    monkeypatch.setattr(post, "iterative_region_voting", spy)
    monkeypatch.setattr(post, "_iterative_region_voting_plain", refuse)
    L, R, _ = make_pair(h, w, d, seed=3)
    lt, rt = pair_to_torch(L, R, "cuda")
    cfg = ADCensusConfig(disp_range=d, aggregation="cross_two_pass", scanline=ScanlineConfig(),
                         run_post=True)
    before = post_cuda.LAUNCHES["region_voting_f32"]
    get_pipeline("ad_census")[0](lt, rt, cfg)
    torch.cuda.synchronize()
    assert post_cuda.LAUNCHES["region_voting_f32"] == before + 1 and len(seen) == 1
    monkeypatch.undo()
    disp, arms, a, k, peak, out = seen[0]
    # the scratch and the output, each in a cached block the allocator may
    # leave up to 1 MiB larger; far below a one-hot (4 D H W bytes)
    assert peak <= 4 * (post_cuda.voting_scratch_words(h, w, 5) + h * w) + (2 << 20), peak
    want = post._iterative_region_voting_plain(disp, arms, *a, **k)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "arms_dtype", "arms_shape", "disp_range"])
def test_region_voting_checks_inputs_on_card(bad):
    _need_card()
    disp = torch.from_numpy(voting_map(16, 24, 8, 1)).cuda()
    maps = voting_arms(16, 24, 3, 1)
    arms = as_arms(maps, "cuda")
    nd = 8
    if bad == "dtype":
        disp = disp.double()
    elif bad == "arms_dtype":
        arms = arms._replace(up=arms.up.long())
    elif bad == "arms_shape":
        arms = arms._replace(left=arms.left[:, :-1])
    else:
        nd = post_cuda.VOTE_MAX_DISPARITIES + 1
    with pytest.raises(ValueError):
        post_cuda.region_voting_cuda(disp, arms, nd, 4.0, 0.4, 2)
