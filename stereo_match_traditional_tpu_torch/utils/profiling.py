"""Tracing and profiling: stage wall times, a `torch.profiler` trace of a
run, and named ``stereo/<stage>`` ranges (the counterpart of
``stereo_match_traditional_tpu.utils.profiling``)."""

from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates named stage wall times; prints one JSON line on report.

    A stage's wall time holds the card's work only where the stage waits
    for it (a copy to the host, a synchronize); this is coarse host-side
    observability.  Each stage is also a range of its name in a
    `torch.profiler` trace.
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        return json.dumps({"stages_ms": {k: round(v * 1e3, 3) for k, v in self.times.items()}})


@contextlib.contextmanager
def profile(log_dir: Optional[str] = None):
    """Trace the block with `torch.profiler` (host and, where there is a
    card, device activity) and write it to ``log_dir/trace.json``, a Chrome
    trace (Perfetto, chrome://tracing) in which the pipeline's
    ``stereo/<stage>`` ranges appear.  ``log_dir=None`` traces nothing."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Decorator adding a named trace range around a stage function."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)

        return wrapped

    return deco


def stage_scope(name: str):
    """Named ``stereo/<stage>`` range in a `torch.profiler` trace, the
    counterpart of the JAX package's ``jax.named_scope`` stage scopes
    (stage names: ``cost_volume``, ``wta``, ``post``)."""
    return torch.profiler.record_function(f"stereo/{name}")
