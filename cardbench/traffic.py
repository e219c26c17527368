"""The one generator of traffic: a mix's file of parameters in, the cell's
distinct pairs out, made from the run's seed.

A mix (``traffic/<name>.json``) gives the geometry (``height``, ``width``),
the disparity range, ``feature_scale``, the number of ``distinct_pairs``
cycled through the window, the ``batch`` of the closed loop, the native
loader's ``loader_threads`` and ``loader_depth``, how many pairs a traced
run traces (``trace_pairs``), how many delivered maps the check samples
(``sample_maps``), ``warmup_seconds`` of serving before the window (so
that the card's clocks and the host's caches settle; one batch at least), and ``rate_cap_pairs_per_s``, a
ceiling far above the served rate that sizes the loader's list of pairs.
The same seed gives the same pairs; every seed gives the same sizes.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np

from cardbench.synthetic import make_pair

MAKE_THREADS = 4


def pair_seeds(traffic: dict, seed: int) -> List[int]:
    """One seed a distinct pair, drawn from the run's seed."""
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.integers(0, 2**63 - 1, size=traffic["distinct_pairs"])]


def make_pairs(traffic: dict, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The cell's distinct ``(left, right)`` uint8 pairs."""
    h, w, d = traffic["height"], traffic["width"], traffic["disp_range"]

    def one(s):
        return make_pair(h, w, d, s, traffic["feature_scale"])[:2]

    with ThreadPoolExecutor(MAKE_THREADS) as pool:
        return list(pool.map(one, pair_seeds(traffic, seed)))
