"""The metric arithmetic on fixed inputs: the readers, the trace's
reduction, the stages' bounds and the sample of delivered maps."""

import random

import numpy as np
import pytest

from cardbench import manifest, serve, tracing, work


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", tracing.TRACED, 0, 1000),
    _x("user_annotation", "stereo/aggregate", 100, 200),
    _x("cuda_runtime", "cudaLaunchKernel", 150, 5, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 400, 5, corr=2),
    _x("cpu_op", "aten::item", 700, 250),
    _x("cuda_runtime", "cudaLaunchKernel", 1500, 5, corr=3),      # a lead, after the range
    _x("kernel", "rect_walker_kernel", 200, 300, corr=1),
    _x("gpu_memcpy", "Memcpy DtoH", 450, 150, corr=2),
    _x("kernel", "lead", 1600, 50, corr=3),
    _x("user_annotation", "stereo/aggregate", 120, 10, tid=2),     # another thread
]


def test_trace_reduction_on_a_synthetic_trace():
    s = tracing.summarize(EVENTS, pairs=2)
    assert s["window_s"] == pytest.approx(1e-3)
    assert s["busy_s"] == pytest.approx(4e-4)                       # [200, 600] us
    assert s["device_ops"] == 2
    assert s["stage_device_s"] == {"aggregate": pytest.approx(3e-4)}
    ops = dict(s["breakdown"]["device_ops"])
    assert ops == {"rect_walker_kernel": pytest.approx(3e-4), "Memcpy DtoH": pytest.approx(1.5e-4)}
    assert s["breakdown"]["idle_gaps"] == [["aten::item", pytest.approx(4e-4)],
                                           ["stereo/aggregate", pytest.approx(2e-4)]]


def test_trace_readers():
    summary = {"trace": tracing.summarize(EVENTS, pairs=2), "stage_bound_s": {"aggregate": 7.5e-5}}
    assert manifest.reader("device_idle_pct")(summary) == pytest.approx(60.0)
    assert manifest.reader("launches_per_pair")(summary) == pytest.approx(1.0)
    assert manifest.reader("aggregate_device_ms")(summary) == pytest.approx(0.15)
    assert manifest.reader("aggregate_roofline_pct")(summary) == pytest.approx(50.0)
    # a stage the trace does not hold, or no trace at all: nothing to read
    for name in ("post_device_ms", "scanline_roofline_pct"):
        assert manifest.reader(name)(summary) is None
        assert manifest.reader(name)({}) is None


def test_a_trace_without_its_range_is_refused():
    with pytest.raises(RuntimeError):
        tracing.summarize(EVENTS[1:], pairs=2)


def test_host_labels_take_the_innermost_event_under_its_stage():
    host = [_x("user_annotation", "stereo/post", 0, 100), _x("cpu_op", "aten::sort", 10, 20),
            _x("cpu_op", "aten::item", 50, 40)]
    assert tracing._host_labels(host, [5, 15, 40, 60, 200]) == [
        "stereo/post", "stereo/post:aten::sort", "stereo/post", "stereo/post:aten::item",
        "(no host event)"]


def test_p95_is_over_every_pair():
    lat = [k / 1e3 for k in range(1, 101)]
    got = manifest.reader("latency_p95_ms")({"latencies_s": lat})
    assert got == pytest.approx(np.percentile(np.arange(1, 101), 95))
    assert manifest.reader("latency_p95_ms")({"latencies_s": [0.1]}) is None


def test_rate_wait_and_setup():
    s = {"pairs": 300, "served_s": 12.0, "loader_wait_s": [0.001, 0.003], "setup_s": 9.5}
    assert manifest.reader("pairs_per_s")(s) == pytest.approx(25.0)
    assert manifest.reader("loader_wait_ms")(s) == pytest.approx(2.0)
    assert manifest.reader("setup_s")(s) == 9.5


def test_stage_bounds_at_kitti():
    h, w, d = 375, 1242, 128
    full = manifest.config("ad_census_full")["work"]
    b = work.stage_bounds(full, {"H": h, "W": w, "D": d}, "NVIDIA H100 80GB HBM3")
    # bytes bound both: the volumes in and out, the images in
    assert b["aggregate"] == pytest.approx((2 * h * w + 16 * d * h * w) / 3.35e12)
    assert b["scanline"] == pytest.approx((h * w + 8 * d * h * w) / 3.35e12)
    assert work.stage_bounds(full, {"H": h, "W": w, "D": d}, "some other card") == {}


@pytest.mark.parametrize("expr", ["__import__('os')", "H ** 2", "X * 2", "[1][0]"])
def test_work_expressions_are_arithmetic_only(expr):
    with pytest.raises(ValueError):
        work.evaluate(expr, {"H": 2})


def test_the_sample_keeps_first_and_last_and_follows_the_seed():
    def sample(seed, n=100):
        r = serve.Reservoir(5, random.Random(seed))
        for k in range(n):
            r.offer(k, k)
        return r.items()

    a = sample(7)
    assert 0 in a and 99 in a and 5 <= len(a) <= 7
    assert a == sample(7) and a != sample(8)
    assert sample(7, n=3) == {0: 0, 1: 1, 2: 2}
