"""Run one cell of the benchmark once and print its result line.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m cardbench.run ...``), from the root of a checkout on a
machine with the card(s) the cell asks for.  The run makes the cell's
pairs from the seed, stages them as PGM files in a fresh temporary
directory, warms up the served path at the cell's own shape, serves pairs
for ``--seconds`` (``cardbench.serve``), and then checks a sample of the
delivered maps against the plain reference (``cardbench.check``).  With
``--trace 1`` the first pairs of the window are traced and the per-layer
metrics are printed in place of the end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number compared beside its
limit); standard error gives the card's power limit, the set-up's phases
and, as its last lines, the compared numbers again.
Without the card(s), without the measured package, or with JAX or the JAX
package loaded once the window has closed, the run prints no result and
exits with a code other than 0.
"""

from __future__ import annotations

import time

_T_FIRST = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

if __package__ in (None, ""):
    # run as a script: the checkout's root, not this folder, heads the path
    sys.path[0] = str(Path(__file__).resolve().parents[1])

FORBIDDEN = ("jax", "jaxlib", "flax", "stereo_match_traditional_tpu")
EXIT_NO_CARD, EXIT_NO_PACKAGE, EXIT_FORBIDDEN = 3, 2, 4


def _process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock, from
    ``/proc/self/stat``; where that cannot be read, this module's import."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_FIRST
    return time.perf_counter() - age


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"not read ({e.__class__.__name__})"
    return f"card (name, power limit): {out or 'not read'}"


def program_config(conf: dict, disp_range: int):
    """The measured package's config object of the configuration file
    ``conf`` at the mix's disparity range."""
    from stereo_match_traditional_tpu_torch import config as port_config
    from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict

    disp = port_config.disp_override_kw(getattr(port_config, conf["config_class"]), disp_range)
    return config_from_dict(conf["config_class"], {**conf["fields"], **disp})


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             traffic: dict = None, bench: dict = None, start: float = None) -> dict:
    """One run of the cell ``workload``; returns the result line's object.
    ``traffic`` replaces the cell's mix (the CPU tests' small sizes);
    ``start`` is the process's start for ``setup_s``."""
    import torch

    from cardbench import check, manifest, serve, tracing, work
    from cardbench.traffic import make_pairs

    bench = bench or manifest.load()
    cell = manifest.workload(bench, workload)
    conf = manifest.config(cell["config"])
    traf = traffic or manifest.traffic(cell["traffic"])
    limit = manifest.limits(workload)["pixels_off"]["limit"]
    if traf["loop"] != "closed" or traf["loader"] != "native":
        raise ValueError(f"only a closed loop over the native loader is served: {traf}")
    d = traf["disp_range"]
    cfg = program_config(conf, d)
    rng = random.Random(seed)
    origin = _T_FIRST if start is None else start
    phases = {"to_run_cell": time.perf_counter() - origin}
    t = time.perf_counter()
    pairs = make_pairs(traf, seed)
    phases["pairs"] = time.perf_counter() - t
    tmp = tempfile.mkdtemp(prefix="cardbench-")
    try:
        t = time.perf_counter()
        paths = serve.stage(pairs, tmp)
        phases["staging"] = time.perf_counter() - t
        t = time.perf_counter()
        serve.serve(conf["pipeline"], cfg, paths, traf, traf["warmup_seconds"], device,
                    serve.Reservoir(0, random.Random(0)))
        phases["warm_up"] = time.perf_counter() - t
        tracer = tracing.Tracer() if trace else None
        win = serve.serve(conf["pipeline"], cfg, paths, traf, seconds, device,
                          serve.Reservoir(traf["sample_maps"], rng), tracer)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"],
           "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
    summary = {"pairs": win.pairs, "served_s": win.seconds, "latencies_s": win.latencies(),
               "loader_wait_s": win.waits,
               "setup_s": win.t0 - origin,
               "stage_bound_s": work.stage_bounds(conf["work"], {"H": traf["height"],
                                                  "W": traf["width"], "D": d}, dev["kind"])}
    if tracer is not None:
        summary["trace"] = tracing.summarize(tracer.events(), min(traf["trace_pairs"], win.pairs))
        dev["busy_s"] = summary["trace"]["busy_s"]
        dev["window_s"] = summary["trace"]["window_s"]
    del tracer
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reads = check.readings(win.sample, pairs, conf, d, device)
    phases["check_after_window"] = time.perf_counter() - t
    failed = sum(r > limit for r in reads)
    out = {"correct": bool(reads) and failed == 0, "attempted": win.pairs, "failed": failed,
           "metrics": manifest.read_metrics(bench, "per_layer" if trace else "end_to_end",
                                            workload, summary),
           "device": dev}
    if trace:
        out["breakdown"] = summary["trace"]["breakdown"]
    lat = sorted(win.latencies())
    out["diagnostics"] = {"phases_s": phases, "pairs": win.pairs,
                          "loader_wait_mean_ms": 1e3 * sum(win.waits) / max(1, win.pairs),
                          "latency_p50_ms": 1e3 * lat[len(lat) // 2] if lat else None}
    out["compared"] = {"pixels_off": {"value": max(reads, default=1.0), "limit": limit,
                                      "maps": len(reads)}}
    return out


def main(argv=None) -> int:
    start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cardbench import manifest

    bench = manifest.load()
    chips = manifest.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: the cell needs {chips} CUDA card(s), {n} found; no result",
              file=sys.stderr)
        return EXIT_NO_CARD
    try:
        import stereo_match_traditional_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"cardbench: the measured package does not import ({e}); no result",
              file=sys.stderr)
        return EXIT_NO_PACKAGE
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                   bench=bench, start=start)
    found = forbidden_modules()
    if found:
        print(f"cardbench: JAX or the JAX package is loaded: {found}; no result", file=sys.stderr)
        return EXIT_FORBIDDEN
    print(card_line(), file=sys.stderr)
    print(f"diagnostics: {json.dumps(out.pop('diagnostics'))}", file=sys.stderr)
    for name, c in out["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r}, over {c['maps']} maps)",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
