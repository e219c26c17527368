"""The traced part of a ``--trace 1`` run and its reduction to a summary.

A ``torch.profiler`` trace (host and card) is taken around the first
``trace_pairs`` pairs of the window, inside a ``cardbench/traced`` range
between two leads of small kernels: the profiler has been seen to lose a
trace's first kernels, and a loss then falls on a lead.  After the window
the trace is reduced to numbers the per-layer readers take:

* the range's length and the union of the card's kernels, copies and fills
  in it (busy seconds), and their count;
* each ``stereo/<stage>`` range's device seconds: the card events whose
  launches (by correlation id) the host made inside it;
* the breakdown: the card's operations by total time, and the idle gaps
  by what the host was doing then (the innermost host event, under its
  ``stereo/<stage>`` range where it has one).
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
import time
from typing import Dict, Iterable, List, Tuple

import torch

DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_EVENTS = ("cuda_runtime", "cuda_driver")
HOST_EVENTS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TRACED = "cardbench/traced"
STAGE_PREFIX = "stereo/"
LEAD_KERNELS = 64
LEAD_PAUSE_S = 0.05
TOP = 10


class Tracer:
    """A profiler around the first pairs of the window: ``start()`` before
    the window, ``close()`` once the traced pairs are delivered, then
    ``events()`` after the window."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._range = torch.profiler.record_function(TRACED)
        self._lead = torch.zeros(1024, device="cuda")
        self.open = False

    def _lead_work(self) -> None:
        for pause in (LEAD_PAUSE_S, 0.0):
            for _ in range(LEAD_KERNELS):
                self._lead.add_(1.0)
            time.sleep(pause)
        torch.cuda.synchronize()

    def start(self) -> None:
        self._prof.start()
        self._lead_work()
        self._range.__enter__()
        self.open = True

    def close(self) -> None:
        """End the traced range once its work is done on the card."""
        if self.open:
            torch.cuda.synchronize()
            self._range.__exit__(None, None, None)
            self._lead_work()
            self._prof.stop()
            self.open = False

    def events(self) -> List[dict]:
        """The trace's complete events, through a file in ``TMPDIR`` that is
        deleted at once."""
        self.close()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged intervals of ``spans``, in order."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _host_labels(host: List[dict], points: List[float]) -> List[str]:
    """For each of the sorted ``points`` (us), the innermost host event
    around it, as ``<stage range>:<event>`` where it lies in a
    ``stereo/<stage>`` range.  The events of one thread nest, so a stack
    swept along the time holds those open at each point."""
    evs = sorted(host, key=lambda e: (e["ts"], -e["dur"]))
    stack: List[dict] = []
    labels, i = [], 0
    for p in points:
        while i < len(evs) and evs[i]["ts"] <= p:
            e = evs[i]
            i += 1
            while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
                stack.pop()
            stack.append(e)
        while stack and stack[-1]["ts"] + stack[-1]["dur"] < p:
            stack.pop()
        names = [e["name"] for e in stack]
        inner = names[-1] if names else "(no host event)"
        stage = next((n for n in reversed(names) if n.startswith(STAGE_PREFIX)), None)
        labels.append(inner if stage in (None, inner) else f"{stage}:{inner}")
    return labels


def summarize(events: List[dict], pairs: int) -> dict:
    """The traced range's numbers (see the module's docstring); ``pairs``
    is the number of pairs whose work the range holds."""
    spans = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == TRACED]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} {TRACED} ranges in the trace")
    rng = spans[0]
    t0, t1, tid = rng["ts"], rng["ts"] + rng["dur"], (rng["pid"], rng["tid"])

    def inside(e):
        return t0 <= e["ts"] <= t1

    launches = sorted((e for e in events if e.get("cat") in LAUNCH_EVENTS and inside(e)
                       and "correlation" in (e.get("args") or {})), key=lambda e: e["ts"])
    launched = {e["args"]["correlation"] for e in launches}
    device = [e for e in events if e.get("cat") in DEVICE_EVENTS
              and (e.get("args") or {}).get("correlation") in launched]
    busy = _union((max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in device
                  if e["ts"] + e["dur"] > t0 and e["ts"] < t1)

    by_corr: Dict[int, float] = collections.defaultdict(float)
    for e in device:
        by_corr[e["args"]["correlation"]] += e["dur"]
    thread = [e for e in launches if (e["pid"], e["tid"]) == tid]
    starts = [e["ts"] for e in thread]
    stage_us: Dict[str, float] = collections.defaultdict(float)
    for s in events:
        if (s.get("cat") == "user_annotation" and s["name"].startswith(STAGE_PREFIX)
                and inside(s) and (s["pid"], s["tid"]) == tid):
            lo = bisect.bisect_left(starts, s["ts"])
            hi = bisect.bisect_right(starts, s["ts"] + s["dur"])
            stage_us[s["name"][len(STAGE_PREFIX):]] += sum(
                by_corr.get(e["args"]["correlation"], 0.0) for e in thread[lo:hi])

    ops: Dict[str, float] = collections.defaultdict(float)
    for e in device:
        ops[e["name"]] += e["dur"] / 1e6
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    host = [e for e in events if e.get("cat") in HOST_EVENTS and (e["pid"], e["tid"]) == tid
            and e["ts"] < t1 and e["ts"] + e["dur"] > t0 and e is not rng]
    idle: Dict[str, float] = collections.defaultdict(float)
    mids = [(a + b) / 2 for a, b in gaps]
    for (a, b), label in zip(gaps, _host_labels(host, mids)):
        idle[label] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {
        "pairs_traced": pairs,
        "window_s": (t1 - t0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "device_ops": len(device),
        "stage_device_s": {k: v / 1e6 for k, v in stage_us.items()},
        "breakdown": {"device_ops": top(ops), "idle_gaps": top(idle)},
    }
