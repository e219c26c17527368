"""The program's own spans and counters over a served window, reduced.

``models.batch.serve_pairs`` and ``utils.native.PairLoader`` open the spans
``stereo/serve_next``, ``serve_upload``, ``serve_run``, ``serve_wait``,
``serve_download``, ``loader_wait`` and ``loader_copy`` and count
``serve.pairs``, ``serve.bytes_up`` and ``serve.bytes_down`` into the
recorder of ``utils.profiling`` (``record_spans()``), which is off unless a
caller turns it on.  ``reduce_record`` turns a window's record into

* each span's milliseconds a pair over the window (total and self time),
  the counters, and the copies' bandwidth;
* ``loader_block_ms``, ``upload_ms``, ``enqueue_ms`` and ``download_ms``:
  ``loader_wait``, ``serve_upload``, ``serve_run`` and ``serve_download``
  over ``serve.pairs``;
* the loop's account: the five serving spans a pair against the window's
  mean latency, and ``serve_next`` against the benchmark's own loader wait.

``off_books`` names a cell that ``BENCHMARK.json`` does not hold
(``<config>.<traffic>``, such as ``ad_census_full.kitti2015_b1``) in a bench
dict, for ``run.run_cell(..., bench=...)``.
"""

from __future__ import annotations

import copy
import statistics
from typing import List

SERVE_SPANS = ("stereo/serve_next", "stereo/serve_upload", "stereo/serve_run",
               "stereo/serve_wait", "stereo/serve_download")
HOST_METRICS = {"loader_block_ms": "stereo/loader_wait", "upload_ms": "stereo/serve_upload",
                "enqueue_ms": "stereo/serve_run", "download_ms": "stereo/serve_download"}


def reduce_record(record, latencies_s: List[float], waits_s: List[float]) -> dict:
    """The window's record reduced (see the module's docstring);
    ``latencies_s`` and ``waits_s`` are the benchmark's own, a pair each."""
    pairs = record.counters.get("serve.pairs", 0)
    totals = record.totals()
    if not pairs:
        return {"pairs": 0, "dropped": record.dropped}

    def ms(name, key="total_s"):
        return 1e3 * totals.get(name, {}).get(key, 0.0) / pairs

    out = {"pairs": pairs, "spans": len(record.spans), "dropped": record.dropped,
           "counters": dict(record.counters)}
    out.update({metric: ms(name) for metric, name in HOST_METRICS.items()})
    out["spans_ms_a_pair"] = {n: {"count": t["count"], "total": ms(n), "self": ms(n, "self_s")}
                              for n, t in sorted(totals.items())}
    loop = sum(ms(n) for n in SERVE_SPANS)
    lat = 1e3 * statistics.fmean(latencies_s) if latencies_s else None
    out["loop"] = {"spans_ms": loop, "latency_mean_ms": lat,
                   "share": loop / lat if lat else None,
                   "serve_next_ms": ms("stereo/serve_next"),
                   "bench_loader_wait_ms": 1e3 * statistics.fmean(waits_s) if waits_s else None}
    for side, name in (("up", "stereo/serve_upload"), ("down", "stereo/serve_download")):
        s = totals.get(name, {}).get("total_s", 0.0)
        b = record.counters.get(f"serve.bytes_{side}", 0)
        out[f"copy_{side}_gb_per_s"] = b / s / 1e9 if s > 0 else None
    return out


def off_books(bench: dict, name: str) -> dict:
    """``bench`` with the cell ``<config>.<traffic>`` added, and added to every
    metric that lists its cells: a bench dict that names a cell
    ``BENCHMARK.json`` does not hold."""
    config, traffic = name.split(".", 1)
    out = copy.deepcopy(bench)
    out["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1,
                             "why": "off the books"})
    for m in out["end_to_end"] + out["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    return out
