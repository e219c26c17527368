"""The served window: a closed loop over the measured package's serving entry.

The cell's distinct pairs are staged as PGM files in a fresh temporary
directory; the package's native ``PairLoader`` decodes them ahead on its
C++ threads, cycled in order, and ``models.batch.serve_pairs`` runs each
batch on the card and hands back each map on the host.  The loop asks for
the next batch only once the last one's maps are in, and stops at the
first batch boundary after ``seconds``.

The benchmark's own spans: when each pair was asked of the loader, how
long ``next()`` waited for it, and when its map arrived.  A sample of the
delivered maps, drawn from the seed (reservoir sampling, so every map is
equally likely, with the first and the last always kept), is held for the
check after the window.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def write_pgm(path: str, img: np.ndarray) -> None:
    """A uint8 ``[H, W]`` image as a binary PGM."""
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def stage(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], directory: str) -> List[Tuple[str, str]]:
    """Write each pair as ``l<k>.pgm`` / ``r<k>.pgm``; their paths in order."""
    paths = []
    for k, (left, right) in enumerate(pairs):
        paths.append((os.path.join(directory, f"l{k}.pgm"), os.path.join(directory, f"r{k}.pgm")))
        write_pgm(paths[-1][0], left)
        write_pgm(paths[-1][1], right)
    return paths


class TimedFeed:
    """The iterator handed to ``serve_pairs``: each ``next()`` of the loader,
    with the time it was asked for and how long it waited; inside a
    ``cardbench/loader_next`` range when ``ranges`` is set."""

    def __init__(self, loader, ranges: bool = False) -> None:
        self.loader = loader
        self.ranges = ranges
        self.asked: List[float] = []
        self.waits: List[float] = []

    def __iter__(self):
        return self

    def __next__(self):
        t = time.perf_counter()
        if self.ranges:
            with torch.profiler.record_function("cardbench/loader_next"):
                pair = next(self.loader)
        else:
            pair = next(self.loader)
        self.asked.append(t)
        self.waits.append(time.perf_counter() - t)
        return pair


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn with ``rng``,
    plus its first and last item."""

    def __init__(self, size: int, rng: random.Random) -> None:
        self.size, self.rng = size, rng
        self.kept: List[Tuple[int, np.ndarray]] = []
        self.first = self.last = None
        self.seen = 0

    def offer(self, index: int, item: np.ndarray) -> None:
        if self.first is None:
            self.first = (index, item)
        self.last = (index, item)
        if len(self.kept) < self.size:
            self.kept.append((index, item))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.size:
                self.kept[j] = (index, item)
        self.seen += 1

    def items(self) -> Dict[int, np.ndarray]:
        """``{stream index: item}`` of the sample, the first and the last."""
        return dict(self.kept + [self.first, self.last]) if self.seen else {}


@dataclass
class Window:
    """What the served window measured."""

    t0: float
    delivered: List[float] = field(default_factory=list)
    asked: List[float] = field(default_factory=list)
    waits: List[float] = field(default_factory=list)
    sample: Dict[int, np.ndarray] = field(default_factory=dict)

    @property
    def pairs(self) -> int:
        return len(self.delivered)

    @property
    def seconds(self) -> float:
        return self.delivered[-1] - self.t0

    def latencies(self) -> List[float]:
        """Seconds from each pair's ask of the loader to its map on the host."""
        return [d - a for a, d in zip(self.asked, self.delivered)]


def feed_paths(paths: List[Tuple[str, str]], count: int) -> List[Tuple[str, str]]:
    """``count`` pairs cycling through ``paths`` in order."""
    return [paths[k % len(paths)] for k in range(count)]


def serve(pipeline: str, cfg, paths: List[Tuple[str, str]], traffic: dict, seconds: float,
          device, sample: Reservoir, tracer=None) -> Window:
    """Run the window: serve pairs cycling through ``paths`` until the first
    batch boundary after ``seconds`` (one batch at least); the first
    ``traffic['trace_pairs']`` pairs inside ``tracer``'s range where one is
    given."""
    from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
    from stereo_match_traditional_tpu_torch.utils import native

    batch = traffic["batch"]
    count = int(seconds * traffic["rate_cap_pairs_per_s"]) + batch
    loader = native.PairLoader(feed_paths(paths, count), threads=traffic["loader_threads"],
                               depth=traffic["loader_depth"])
    feed = TimedFeed(loader, ranges=tracer is not None)
    maps = serve_pairs(pipeline, feed, cfg, batch_size=batch, device=device)
    if tracer is not None:
        tracer.start()
    win = Window(t0=time.perf_counter())
    try:
        for k, disp in enumerate(maps):
            now = time.perf_counter()
            win.delivered.append(now)
            sample.offer(k, disp)
            if tracer is not None and k + 1 == traffic["trace_pairs"]:
                tracer.close()
            if (k + 1) % batch == 0 and now - win.t0 >= seconds:
                break
        else:
            raise RuntimeError(f"the feed of {count} pairs ran out before {seconds} s: "
                               "rate_cap_pairs_per_s is below the served rate")
    finally:
        maps.close()
        loader.close()
        if tracer is not None:
            tracer.close()
    win.asked, win.waits = feed.asked[:win.pairs], feed.waits[:win.pairs]
    win.sample = sample.items()
    return win
