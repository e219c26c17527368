#!/usr/bin/env python3
"""The banded scanline kernels of several checkouts on one card, at the
shapes the executors give them.

    python3 -m stereo_match_traditional_tpu_torch.tools.banded_ab OUT.json ROOT [ROOT ...]

Runs, for each checkout root in the order given (for two commits: parent,
change, change, parent), a child process that imports that root's
``stereo_match_traditional_tpu_torch``, builds its kernels and calls its
``directional_pass_banded_cuda`` and ``canonical_pass_banded_cuda`` on
the same seeded inputs: the tiled executor's whole-column passes ([D, H, W]
= [128, 720, 1280], a four-rank slab of it, [128, 720, 320], and Teddy,
[60, 375, 450]; the volume ``[H, D, W]`` contiguous), the streamed
executor's 4K bands (a halo-cropped ``[D, t, W]`` band's ``permute(1, 0,
2)``; legacy [256, 1184, 3840], canonical [256, 800, 3840]) and a
[256, 64, 3840] band, each with and without the output (``store``).  Each
case reports the median ms of CUDA-event-timed calls (the wrapper's host
part and its output allocation included), its bound (the band, the
penalties and the output once at 3.35 TB/s) and a SHA-256 of the output and
the outgoing carry, so that the roots' results can be held equal bit for
bit.  ``OUT.json`` gets every case of every run and, per case, whether all
runs' hashes agree.  Prints one line a run.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12
HALO = 38        # the 4K legacy FULL band's halo rows (ad_census receptive field)
# (label, family, D, steps, lanes, layout, timed calls)
CASES = [
    ("tiled 720p", "legacy", 128, 720, 1280, "columns", 10),
    ("tiled 720p", "canonical", 128, 720, 1280, "columns", 10),
    ("tiled 720p slab of 4", "legacy", 128, 720, 320, "columns", 10),
    ("tiled 720p slab of 4", "canonical", 128, 720, 320, "columns", 10),
    ("tiled Teddy", "legacy", 60, 375, 450, "columns", 10),
    ("tiled Teddy", "canonical", 60, 375, 450, "columns", 10),
    ("4K-wide band", "legacy", 256, 64, 3840, "band", 10),
    ("4K-wide band", "canonical", 256, 64, 3840, "band", 10),
    ("4K legacy FULL band", "legacy", 256, 1184, 3840, "band", 4),
    ("4K canonical FULL band", "canonical", 256, 800, 3840, "band", 4),
]


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    t0 = time.perf_counter()
    from stereo_match_traditional_tpu_torch.ops.kernels import build
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    build.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
    for label, family, d, n, m, layout, reps in CASES:
        g = torch.Generator(device="cuda").manual_seed(d + n + m)
        if layout == "columns":
            cost = torch.rand((n, d, m), device="cuda", generator=g) * 4
        else:
            band = torch.rand((d, n + 2 * HALO, m), device="cuda", generator=g) * 4
            cost = band.narrow(1, HALO, n).permute(1, 0, 2)
        if family == "legacy":
            pen = torch.rand((n, m), device="cuda", generator=g) * 3 + 0.5
            pen_bytes = 4 * n * m

            def call(store, c=cost, p=pen, cr=None):
                return banded.directional_pass_banded_cuda(c, p, cr, None, 0.5, True,
                                                           store=store)
        else:
            pen = levels[torch.randint(0, 3, (n, d, m), device="cuda", generator=g)]
            pen_bytes = 4 * n * d * m

            def call(store, c=cost, p=pen, cr=None):
                return banded.canonical_pass_banded_cuda(c, p, cr, None, 1.0, 3.0, store=store)
        prev = torch.rand((d, m), device="cuda", generator=g) * 5
        carry = (prev, prev.amin(0))
        for store in (True, False):
            out, (cp, cm) = call(store, cr=carry)
            torch.cuda.synchronize()
            digest = hashlib.sha256()
            for x in ((out,) if store else ()) + (cp, cm):
                digest.update(x.contiguous().cpu().numpy().tobytes())
            del out
            times = []
            for _ in range(reps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                call(store, cr=carry)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            values = n * d * m
            moved = 4 * values * (2 if store else 1) + pen_bytes + 8 * (d * m + m)
            rec = {"case": label, "family": family, "shape": [d, n, m], "layout": layout,
                   "store": store, "ms": statistics.median(times), "ms_all": times,
                   "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "sha256": digest.hexdigest(),
                   "launches": dict(banded.LAUNCHES)}
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
            print(json.dumps(rec), flush=True)
        del cost, pen, carry, prev
        if layout == "band":
            del band
        torch.cuda.empty_cache()


def run(root: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                           os.path.abspath(root)], cwd=root, env=env, capture_output=True,
                          text=True)
    recs = []
    for line in proc.stdout.splitlines():
        try:
            recs.append(json.loads(line))
        except ValueError:
            pass
    return {"root": root, "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "records": recs, "stderr": proc.stderr[-4000:]}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--child":
        child(argv[1])
        return 0
    if len(argv) < 2:
        raise SystemExit(__doc__)
    out, roots = argv[0], argv[1:]
    runs = []
    for root in roots:
        runs.append(run(root))
        print(json.dumps({k: runs[-1][k] for k in ("root", "rc", "seconds")}), flush=True)
    agree = {}
    for r in runs:
        for rec in r["records"]:
            if "sha256" in rec:
                key = f"{rec['case']} | {rec['family']} | store={rec['store']}"
                agree.setdefault(key, set()).add(rec["sha256"])
    summary = {key: len(hashes) == 1 for key, hashes in agree.items()}
    with open(out, "w") as f:
        json.dump({"runs": runs, "bit_equal_across_runs": summary}, f, indent=1)
    print(json.dumps({"bit_equal_across_runs": all(summary.values()) and bool(summary)}))
    return int(any(r["rc"] for r in runs) or not all(summary.values()))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
