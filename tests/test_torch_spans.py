"""The port's span and counter recorder (``utils.profiling``) and the spans
of its serving loop, pair loader and pipelines: nesting, pair indices,
self time, counters, the cap, recording off, the profiler trace's clock,
``serve_pairs``' and ``PairLoader``'s spans and the legacy post's ranges.
No JAX here: the card test runs with ``--noconftest``."""

import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch import config as cfgs
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
from stereo_match_traditional_tpu_torch.utils import profiling
from stereo_match_traditional_tpu_torch.utils.profiling import (
    Record, Span, StageTimer, annotate, count, profile, record_spans, span, stage_scope,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

SERVE = ["stereo/serve_next", "stereo/serve_upload", "stereo/serve_run", "stereo/serve_download"]
SAD = cfgs.SADConfig(max_disparity=8, winsize=1)


def _pairs(n, h=24, w=40, d=8):
    return [make_pair(h, w, d, seed=s)[:2] for s in range(n)]


def _names(rec, parent=-1):
    return [s.name for s in rec.spans if s.parent == parent]


def test_recording_is_off_by_default_and_a_span_is_the_profiler_range_alone():
    """Off, a span is the profiler range while a profiler runs, and one
    shared empty context while none does."""
    assert profiling._record is None
    assert span("a") is profiling._OFF and stage_scope("b") is profiling._OFF
    with torch.profiler.profile():
        assert type(span("a")) is torch.profiler.record_function
        assert type(stage_scope("a")) is torch.profiler.record_function
    count("x", 3)                                   # no record: nothing to count into
    assert profiling._record is None


def test_recording_without_a_profiler_opens_no_range():
    with record_spans() as rec:
        sp = span("a", pair=1)
        with sp:
            pass
    assert sp._range is profiling._OFF and [s.name for s in rec.spans] == ["a"]


def test_recording_off_keeps_nothing():
    """With the recorder off, spans and counts leave no memory behind in the
    recorder's module."""
    for _ in range(10):                             # first-call caches
        with span("warm"):
            count("warm")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for k in range(2000):
            with span("stereo/off", pair=k):
                count("serve.pairs")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    mine = tracemalloc.Filter(True, profiling.__file__)
    grown = sum(d.size_diff for d in after.filter_traces([mine]).compare_to(
        before.filter_traces([mine]), "filename"))
    assert grown <= 0


def test_nesting_parents_and_pair_indices():
    with record_spans() as rec:
        assert profiling._record is rec
        with span("a", pair=4) as a:
            with span("b") as b:
                with span("c", pair=9) as c:
                    pass
            with span("d"):
                pass
        with span("e"):
            pass
    assert profiling._record is None
    assert [s.name for s in rec.spans] == ["a", "b", "c", "d", "e"]
    assert [s.index for s in rec.spans] == [0, 1, 2, 3, 4]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 0, -1]
    assert [s.pair for s in rec.spans] == [4, 4, 9, 4, None]
    assert (a, b, c) == tuple(rec.spans[:3])
    for s in rec.spans:
        assert s.end_ns >= s.start_ns
    assert a.start_ns <= b.start_ns <= c.start_ns <= c.end_ns <= b.end_ns <= a.end_ns
    assert rec._children() == {0: [rec.spans[1], rec.spans[3]], 1: [rec.spans[2]]}


def test_self_time_is_the_span_less_what_its_children_cover():
    rec = Record()
    rec.spans = [Span(0, "p", 0, -1, None, end_ns=1000),
                 Span(1, "k", 100, 0, None, end_ns=300),
                 Span(2, "k", 250, 0, None, end_ns=400),     # overlaps its sibling
                 Span(3, "g", 260, 2, None, end_ns=270),     # a grandchild: not p's
                 Span(4, "k", 900, 0, None, end_ns=1200)]    # runs past its parent
    assert rec.self_seconds(rec.spans[0]) == pytest.approx((1000 - 300 - 100) / 1e9)
    assert rec.self_seconds(rec.spans[2]) == pytest.approx(140 / 1e9)
    tot = rec.totals()
    assert tot["k"]["count"] == 3 and tot["k"]["total_s"] == pytest.approx(650 / 1e9)
    assert tot["p"]["self_s"] == pytest.approx(600 / 1e9)
    rec.spans.append(Span(5, "open", 1300, -1, None))           # not closed: not counted
    assert set(rec.totals()) == {"p", "k", "g"}


def test_counters():
    with record_spans() as rec:
        count("serve.pairs")
        count("serve.pairs", 2)
        count("serve.bytes_up", 1 << 40)
    count("serve.pairs")                            # after the record closed
    assert rec.counters == {"serve.pairs": 3, "serve.bytes_up": 1 << 40}


def test_the_cap_drops_spans_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "CAP", 3)
    with record_spans() as rec:
        for k in range(2):
            with span("outer", pair=k):
                with span("inner"):
                    count("n")
    assert [s.name for s in rec.spans] == ["outer", "inner", "outer"]
    assert rec.dropped == 1 and rec.counters == {"n": 2}
    assert all(s.end_ns is not None for s in rec.spans)


def test_recordings_nest_and_restore():
    with record_spans() as outer:
        with span("before"):
            pass
        with record_spans() as inner:
            with span("inside"):
                pass
        with span("after"):
            pass
    assert [s.name for s in outer.spans] == ["before", "after"]
    assert [s.name for s in inner.spans] == ["inside"]
    assert profiling._record is None


def test_threads_keep_their_own_nesting():
    seen = {}

    def work(name):
        with span(name) as top:
            barrier.wait(timeout=10)
            with span(name + "/child") as child:
                seen[name] = (top, child)

    barrier = threading.Barrier(4)
    with record_spans() as rec:
        threads = [threading.Thread(target=work, args=(f"t{k}",)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(rec.spans) == 8 and len({s.index for s in rec.spans}) == 8
    for top, child in seen.values():
        assert child.parent == top.index and top.parent == -1


def test_stage_timer_and_annotate_record_through_spans():
    timer = StageTimer()

    @annotate("outer")
    def call():
        with stage_scope("inner"):
            return 1

    with record_spans() as rec:
        with timer.stage("pipeline"):
            assert call() == 1
    assert [s.name for s in rec.spans] == ["pipeline", "outer", "stereo/inner"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1]
    assert set(json.loads(timer.report())["stages_ms"]) == {"pipeline"}


def test_the_profiler_trace_holds_each_span_at_its_recorded_start(tmp_path):
    """The trace's ``ts`` plus ``baseTimeNanoseconds`` is the record's clock:
    every recorded span is a range of its name, whose start lies within 50 us
    of the recorded one at the 95th percentile (the card's criterion; a
    thread the host preempts between the two stamps can stray further).
    The trace's first ranges, which the profiler's set-up delays, are not
    recorded, as the benchmark's own ranges open its traces."""

    def calls(k):
        with span("stereo/outer", pair=k):
            with span("stereo/inner"):
                torch.ones(64).sum()

    with profile(str(tmp_path)):
        for k in range(3):
            calls(k)
        with record_spans() as rec:
            for k in range(40):
                calls(k)
    data = json.load(open(tmp_path / "trace.json"))
    base = data["baseTimeNanoseconds"]
    ranges = {}
    for e in data["traceEvents"]:
        if e.get("ph") == "X" and e.get("name", "").startswith("stereo/"):
            ranges.setdefault(e["name"], []).append(base + e["ts"] * 1e3)
    assert {k: len(v) for k, v in ranges.items()} == {"stereo/outer": 43, "stereo/inner": 43}
    assert len(rec.spans) == 80
    offsets = sorted(min(abs(t - s.start_ns) for t in ranges[s.name]) / 1e3
                     for s in rec.spans)
    assert offsets[len(offsets) // 2] <= 10.0 and offsets[int(0.95 * len(offsets))] <= 50.0


@pytest.mark.parametrize("batch_size", [1, 3])
def test_serve_pairs_spans_each_batch_in_order(batch_size):
    """next / upload / run / download a batch, a last ``serve_next`` that
    finds no pair, each batch's spans under the stream index of its first
    pair, and the counters; no ``serve_wait`` off the card."""
    pairs = _pairs(5)
    with record_spans() as rec:
        maps = list(serve_pairs("sad", pairs, SAD, batch_size=batch_size, device="cpu"))
    assert len(maps) == 5
    batches = -(-5 // batch_size)
    assert _names(rec) == SERVE * batches + ["stereo/serve_next"]
    firsts = list(range(0, 5, batch_size))
    tops = [s for s in rec.spans if s.parent == -1]
    assert [s.pair for s in tops] == [f for f in firsts for _ in SERVE] + [5]
    for s in rec.spans:
        assert s.parent == -1 or s.pair == rec.spans[s.parent].pair
    assert {s.name for s in rec.spans if s.parent >= 0} == {"stereo/cost_volume", "stereo/wta"}
    h, w = pairs[0][0].shape
    assert rec.counters == {"serve.pairs": 5, "serve.bytes_up": 5 * 2 * h * w,
                            "serve.bytes_down": sum(m.nbytes for m in maps)}
    starts = [s.start_ns for s in tops]
    assert starts == sorted(starts)


def test_serve_pairs_stops_counting_where_the_consumer_stops():
    with record_spans() as rec:
        gen = serve_pairs("sad", _pairs(5), SAD, batch_size=2, device="cpu")
        next(gen)
        gen.close()
    assert rec.counters["serve.pairs"] == 2
    assert _names(rec) == SERVE


@pytest.mark.cuda
def test_serve_pairs_waits_on_the_card_stream_in_its_own_span():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    pairs = _pairs(3)
    with record_spans() as rec:
        maps = list(serve_pairs("sad", pairs, SAD, batch_size=2, device="cuda"))
    served = ["stereo/serve_next", "stereo/serve_upload", "stereo/serve_run",
              "stereo/serve_wait", "stereo/serve_download"]
    assert _names(rec) == served * 2 + ["stereo/serve_next"]
    assert rec.counters["serve.pairs"] == 3
    for got, (left, right) in zip(maps, pairs):
        fn, _ = get_pipeline("sad")
        want = fn(torch.from_numpy(left), torch.from_numpy(right), SAD).disp_left.numpy()
        assert np.array_equal(got, want)


def test_pair_loader_spans(tmp_path):
    from stereo_match_traditional_tpu_torch.utils import native

    if not native.available():
        pytest.skip("the native host library does not build here (no C++ compiler)")
    pairs = _pairs(3)
    paths = []
    for k, (left, right) in enumerate(pairs):
        lp, rp = tmp_path / f"l{k}.pgm", tmp_path / f"r{k}.pgm"
        native.write_pnm(str(lp), left)
        native.write_pnm(str(rp), right)
        paths.append((lp, rp))
    with record_spans() as rec:
        got = list(native.PairLoader(paths, threads=2, depth=2))
    assert all(np.array_equal(a, b) for g, p in zip(got, pairs) for a, b in zip(g, p))
    names = [s.name for s in rec.spans]
    assert names == ["stereo/loader_wait", "stereo/loader_copy"] * 3 + ["stereo/loader_wait"]
    assert [s.pair for s in rec.spans] == [0, 0, 1, 1, 2, 2, 3]


def test_pair_loader_spans_nest_under_serve_next(tmp_path):
    from stereo_match_traditional_tpu_torch.utils import native

    if not native.available():
        pytest.skip("the native host library does not build here (no C++ compiler)")
    paths = []
    for k, (left, right) in enumerate(_pairs(2)):
        paths.append((tmp_path / f"l{k}.pgm", tmp_path / f"r{k}.pgm"))
        native.write_pnm(str(paths[-1][0]), left)
        native.write_pnm(str(paths[-1][1]), right)
    with record_spans() as rec:
        list(serve_pairs("sad", native.PairLoader(paths, threads=1, depth=2), SAD,
                         device="cpu"))
    for s in rec.spans:
        if s.name.startswith("stereo/loader_"):
            assert rec.spans[s.parent].name == "stereo/serve_next"
            assert s.pair == rec.spans[s.parent].pair
    assert rec.totals()["stereo/loader_wait"]["count"] == 3


def _stage_tree(cfg, size=(24, 40)):
    left, right, _ = make_pair(*size, cfg.disp_range, seed=1)
    fn, _ = get_pipeline("ad_census")
    with record_spans() as rec:
        fn(torch.from_numpy(left), torch.from_numpy(right), cfg)
    return rec, {(s.name, rec.spans[s.parent].name if s.parent >= 0 else None)
                 for s in rec.spans}


def test_legacy_full_ranges_nest_arms_in_aggregate_and_the_post_chain_in_post():
    rec, tree = _stage_tree(cfgs.ADCensusConfig(disp_range=8, scanline=cfgs.ScanlineConfig(),
                                                run_post=True))
    assert tree == {("stereo/cost_volume", None), ("stereo/aggregate", None),
                    ("stereo/arms", "stereo/aggregate"), ("stereo/rect_mean", "stereo/aggregate"),
                    ("stereo/scanline", None),
                    ("stereo/wta", None), ("stereo/post", None),
                    ("stereo/lr_check", "stereo/post"), ("stereo/speckle", "stereo/post"),
                    ("stereo/fill", "stereo/post"), ("stereo/median", "stereo/post")}
    post = [s.name for s in rec.spans if s.parent >= 0 and rec.spans[s.parent].name
            == "stereo/post"]
    assert post == ["stereo/lr_check", "stereo/speckle", "stereo/fill", "stereo/median"]


def test_canonical_ranges_are_unchanged():
    cfg = cfgs.ADCensusConfig(disp_range=8, aggregation="cross_two_pass",
                              scanline=cfgs.ScanlineConfig(), run_post=True)
    _, tree = _stage_tree(cfg)
    assert tree == {("stereo/cost_volume", None), ("stereo/arms", None),
                    ("stereo/aggregate", None), ("stereo/scanline", None),
                    ("stereo/wta", None), ("stereo/post", None),
                    ("stereo/lr_check", "stereo/post"), ("stereo/region_voting", "stereo/post"),
                    ("stereo/median", "stereo/post")}


def _full(d):
    return cfgs.ADCensusConfig(disp_range=d, scanline=cfgs.ScanlineConfig(), run_post=True)


@pytest.mark.parametrize("d", [8, 300])
def test_full_counts_its_volume_elements_a_pair(d):
    pairs = _pairs(3, d=d)
    with record_spans() as rec:
        maps = list(serve_pairs("ad_census", pairs, _full(d), device="cpu"))
    assert len(maps) == 3 and rec.counters["ad_census.volume_elements"] == 3 * d * 24 * 40
    rect = [s for s in rec.spans if s.name == "stereo/rect_mean"]
    assert [s.pair for s in rect] == [0, 1, 2]
    assert all(rec.spans[s.parent].name == "stereo/aggregate" for s in rect)


@pytest.mark.parametrize("d", [8, 300])
def test_full_maps_are_unchanged_while_recording(d):
    left, right, _ = make_pair(24, 40, d, seed=4)
    fn, _ = get_pipeline("ad_census")
    args = (torch.from_numpy(left), torch.from_numpy(right), _full(d))
    off = fn(*args)
    with record_spans():
        on = fn(*args)
    for a, b in zip(off, on):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("canonical", [False, True])
def test_the_composed_route_spans_its_rows_and_columns_and_counts_its_passes(canonical,
                                                                             monkeypatch):
    """The composed route above 256 disparities, its launches stood in for
    by the plain passes on CPU tensors (``banded_on_cpu``)."""
    from banded_on_cpu import plain_launch
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    monkeypatch.setattr(banded, "_launch", plain_launch)
    gen = torch.Generator().manual_seed(5)
    cost = torch.rand((9, 7, 10), generator=gen) * 4
    grey = [torch.randint(0, 256, (7, 10), generator=gen, dtype=torch.uint8) for _ in range(2)]
    with record_spans() as rec:
        with span("stereo/scanline"):
            if canonical:
                banded.scanline_canonical_composed(cost, *grey, 1.0, 3.0, 15.0, "left")
            else:
                banded.scanline_optimize_composed(cost, grey[0], 10.0, 150.0, True, False)
    tree = [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None) for s in rec.spans]
    assert tree == [("stereo/scanline", None), ("stereo/scanline_rows", "stereo/scanline"),
                    ("stereo/scanline_columns", "stereo/scanline")]
    assert rec.counters == {"scanline.wide_passes": 4}
