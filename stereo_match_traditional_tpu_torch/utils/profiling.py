"""Tracing and profiling: named spans and counters, stage wall times, and a
`torch.profiler` trace of a run (the counterpart of
``stereo_match_traditional_tpu.utils.profiling``).

The port's one span and counter recorder.  :func:`span` is a named range
in a `torch.profiler` trace while a profiler runs; inside
:func:`record_spans` it is also one entry of an in-memory :class:`Record`:
its name, start and end, the span that encloses it, and the index of the
pair it serves.  :func:`count` adds to a named counter of that record.
Recording is off by default; with it off and no profiler running, a span
is one shared empty context and a count does nothing.

Spans are stamped with ``time.time_ns()``, the clock of the exported
Chrome trace: an event's ``ts`` plus ``baseTimeNanoseconds / 1000`` is
the same microsecond, so a record can be laid over a trace of the same
run.  A span holds its range (it is stamped before the range opens and
after it closes, a few microseconds apart), but for a trace's first range,
which the profiler's set-up can delay by a millisecond.  The pipelines'
stages (:func:`stage_scope`), the serving loop (``models.batch.serve_pairs``)
and the native pair loader (``utils.native.PairLoader``) open spans named
``stereo/<what>``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

CAP = 1 << 18                                       # spans a record keeps
_OFF = contextlib.nullcontext()                     # a span with nothing to do


@dataclass
class Span:
    """One recorded span; times in ``time.time_ns()`` nanoseconds, ``end_ns``
    None while it is open.  ``parent`` is the enclosing span's ``index`` in
    its record (-1 at the top of its thread); ``pair`` the index of the
    first pair of what it serves, its own or its parent's."""

    index: int
    name: str
    start_ns: int
    parent: int
    pair: Optional[int]
    end_ns: Optional[int] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Record:
    """What :func:`record_spans` collected: at most :data:`CAP` spans in the
    order they opened (``dropped`` counts those refused past it) and the
    counters."""

    spans: List[Span] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    dropped: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._open = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _begin(self, name: str, pair: Optional[int]) -> Optional[Span]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if pair is None and parent is not None:
            pair = parent.pair
        with self._lock:
            if len(self.spans) >= CAP:
                self.dropped += 1
                sp = None
            else:
                sp = Span(len(self.spans), name, 0, -1 if parent is None else parent.index, pair)
                self.spans.append(sp)
        stack.append(sp)
        return sp

    def _end(self) -> None:
        self._stack().pop()

    def _children(self) -> Dict[int, List[Span]]:
        out: Dict[int, List[Span]] = {}
        for s in self.spans:
            if s.parent >= 0:
                out.setdefault(s.parent, []).append(s)
        return out

    def self_seconds(self, span: Span, children: Dict[int, List[Span]] = None) -> float:
        """The span's duration less the part of it its children cover."""
        kids = (self._children() if children is None else children).get(span.index, [])
        covered, reach = 0, span.start_ns
        for k in sorted((k for k in kids if k.end_ns is not None), key=lambda k: k.start_ns):
            a, b = max(k.start_ns, reach), min(k.end_ns, span.end_ns)
            if b > a:
                covered += b - a
                reach = b
        return (span.end_ns - span.start_ns - covered) / 1e9

    def totals(self) -> Dict[str, dict]:
        """``{name: {"count", "total_s", "self_s"}}`` of the closed spans."""
        kids = self._children()
        out: Dict[str, dict] = {}
        for s in self.spans:
            if s.end_ns is None:
                continue
            t = out.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += s.seconds
            t["self_s"] += self.self_seconds(s, kids)
        return out


_record: Optional[Record] = None


def _range(name: str):
    """The profiler range ``name`` while a profiler runs, else nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


class _RecordedSpan:
    """A span of ``record``, and a profiler range while a profiler runs."""

    __slots__ = ("_record", "_name", "_pair", "_range", "_span")

    def __init__(self, record: Record, name: str, pair: Optional[int]) -> None:
        self._record, self._name, self._pair = record, name, pair
        self._range = _range(name)

    def __enter__(self):
        self._span = self._record._begin(self._name, self._pair)
        if self._span is not None:
            self._span.start_ns = time.time_ns()
        self._range.__enter__()
        return self._span

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        if self._span is not None:
            self._span.end_ns = time.time_ns()
        self._record._end()
        return False


def span(name: str, pair: Optional[int] = None):
    """A named range in a `torch.profiler` trace, entered with ``with``.
    Inside :func:`record_spans` it is also recorded, with ``pair`` the index
    of the first pair it serves (else its parent's)."""
    rec = _record
    if rec is None:
        return _range(name)
    return _RecordedSpan(rec, name, pair)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the record, if one is open."""
    rec = _record
    if rec is not None:
        with rec._lock:
            rec.counters[name] = rec.counters.get(name, 0) + n


def recording() -> bool:
    """Whether a :func:`record_spans` record is open: a counter that costs
    a host sync to read (a word on the card) is read only then."""
    return _record is not None


@contextlib.contextmanager
def record_spans():
    """Record every span and count of the process while the block runs;
    yields the :class:`Record`.  Recordings nest: the inner one is the
    open one until it closes."""
    global _record
    rec, outer = Record(), _record
    _record = rec
    try:
        yield rec
    finally:
        _record = outer


class StageTimer:
    """Accumulates named stage wall times; prints one JSON line on report.

    A stage's wall time holds the card's work only where the stage waits
    for it (a copy to the host, a synchronize); this is coarse host-side
    observability.  Each stage is a :func:`span` of its name.
    """

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with span(name):
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
    """Decorator: a :func:`span` of ``name`` around each call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with span(name):
                return fn(*a, **k)

        return wrapped

    return deco


def stage_scope(name: str):
    """The :func:`span` ``stereo/<name>`` around a pipeline stage, the
    counterpart of the JAX package's ``jax.named_scope`` stage scopes
    (stage names: ``cost_volume``, ``wta``, ``post``)."""
    return span(f"stereo/{name}")
