"""The program's serving spans as the benchmark reads them: the idle gaps'
labels under the new spans, the existing readers unchanged, and
``cardbench.program_spans``' reductions on fixed inputs."""

import pytest

from cardbench import manifest, program_spans, tracing
from stereo_match_traditional_tpu_torch.utils.profiling import Record, Span, record_spans


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# one served pair: the upload's pageable copy, the run's kernel, the
# download's copy; the card idle from 0 to 200, 250 to 300 and 700 to 1000
EVENTS = [
    _x("user_annotation", tracing.TRACED, 0, 1000),
    _x("user_annotation", "stereo/serve_next", 10, 90),
    _x("user_annotation", "stereo/loader_wait", 20, 60),
    _x("user_annotation", "stereo/serve_upload", 100, 180),
    _x("cuda_runtime", "cudaMemcpyAsync", 110, 160, corr=1),
    _x("user_annotation", "stereo/serve_run", 280, 20),
    _x("cuda_runtime", "cudaLaunchKernel", 285, 5, corr=2),
    _x("user_annotation", "stereo/serve_download", 650, 300),
    _x("cuda_runtime", "cudaMemcpyAsync", 660, 280, corr=3),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200, 50, corr=1),
    _x("kernel", "census_kernel", 300, 300, corr=2),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 100, corr=3),
]


def test_idle_gaps_are_put_down_to_the_serving_spans():
    """A gap inside the upload's copy is ``stereo/serve_upload:cudaMemcpyAsync``;
    the trace's reduction is otherwise what it was."""
    host = [e for e in EVENTS
            if e["cat"] in tracing.HOST_EVENTS and e["name"] != tracing.TRACED]
    assert tracing._host_labels(host, [50, 150, 290, 800, 990]) == [
        "stereo/loader_wait", "stereo/serve_upload:cudaMemcpyAsync",
        "stereo/serve_run:cudaLaunchKernel", "stereo/serve_download:cudaMemcpyAsync",
        "(no host event)"]
    s = tracing.summarize(EVENTS, pairs=1)
    assert s["busy_s"] == pytest.approx(4.5e-4) and s["device_ops"] == 3
    assert dict(s["breakdown"]["idle_gaps"]) == {                   # by each gap's middle
        "stereo/serve_upload": pytest.approx(2.5e-4),
        "stereo/serve_download:cudaMemcpyAsync": pytest.approx(3e-4)}
    assert s["stage_device_s"]["serve_run"] == pytest.approx(3e-4)
    assert s["stage_device_s"]["serve_upload"] == pytest.approx(5e-5)


def test_the_existing_readers_read_the_same_trace_as_before():
    summary = {"trace": tracing.summarize(EVENTS, pairs=1)}
    assert manifest.reader("device_idle_pct")(summary) == pytest.approx(55.0)
    assert manifest.reader("launches_per_pair")(summary) == pytest.approx(3.0)
    assert manifest.reader("aggregate_device_ms")(summary) is None


def _record():
    rec = Record()
    rec.spans = [Span(0, "stereo/serve_next", 0, -1, 0, end_ns=1_000_000),
                 Span(1, "stereo/loader_wait", 100_000, 0, 0, end_ns=900_000),
                 Span(2, "stereo/serve_upload", 1_000_000, -1, 0, end_ns=3_000_000),
                 Span(3, "stereo/serve_run", 3_000_000, -1, 0, end_ns=9_000_000),
                 Span(4, "stereo/serve_wait", 9_000_000, -1, 0, end_ns=19_000_000),
                 Span(5, "stereo/serve_download", 19_000_000, -1, 0, end_ns=20_000_000)]
    rec.counters = {"serve.pairs": 2, "serve.bytes_up": 4_000_000, "serve.bytes_down": 1_000_000}
    return rec


def test_the_record_reduces_to_the_host_metrics():
    got = program_spans.reduce_record(_record(), [0.010, 0.010], [0.0004, 0.0006])
    assert got["loader_block_ms"] == pytest.approx(0.4)
    assert got["upload_ms"] == pytest.approx(1.0)
    assert got["enqueue_ms"] == pytest.approx(3.0)
    assert got["download_ms"] == pytest.approx(0.5)
    assert got["loop"]["spans_ms"] == pytest.approx(10.0)
    assert got["loop"]["share"] == pytest.approx(1.0)
    assert got["loop"]["bench_loader_wait_ms"] == pytest.approx(0.5)
    assert got["spans_ms_a_pair"]["stereo/serve_next"]["self"] == pytest.approx(0.1)
    assert got["copy_up_gb_per_s"] == pytest.approx(2.0)
    assert got["copy_down_gb_per_s"] == pytest.approx(1.0)
    assert program_spans.reduce_record(Record(), [], [])["pairs"] == 0


def test_an_off_books_cell_is_named_in_the_bench_dict():
    bench = manifest.load()
    got = program_spans.off_books(bench, "ad_census_full.kitti2015_b1")
    cell = manifest.workload(got, "ad_census_full.kitti2015_b1")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("ad_census_full",
                                                                "kitti2015_b1", 1)
    assert all("ad_census_full.kitti2015_b1" in m["workloads"]
               for m in got["per_layer"] if "workloads" in m)
    assert "ad_census_full.kitti2015_b1" not in {w["name"] for w in bench["workloads"]}


def test_a_record_of_a_served_stream_on_the_cpu_reduces():
    from stereo_match_traditional_tpu_torch import config as cfgs
    from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    pairs = [make_pair(24, 40, 8, seed=s)[:2] for s in range(3)]
    with record_spans() as rec:
        maps = list(serve_pairs("sad", pairs, cfgs.SADConfig(max_disparity=8, winsize=1),
                                device="cpu"))
    got = program_spans.reduce_record(rec, [], [])
    assert got["pairs"] == len(maps) == 3 and got["dropped"] == 0
    assert "stereo/serve_wait" not in got["spans_ms_a_pair"]
    for name in ("upload_ms", "enqueue_ms", "download_ms"):
        assert got[name] > 0
    assert got["loader_block_ms"] == 0.0 and got["loop"]["share"] is None
    assert got["counters"]["serve.bytes_up"] == 3 * 2 * 24 * 40
