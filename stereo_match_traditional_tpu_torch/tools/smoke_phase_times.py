#!/usr/bin/env python3
"""Seconds per phase of ``chip_smoke.py`` runs, to compare checkouts on one
card.

    python3 smoke_phase_times.py OUT.json ROOT [ROOT ...]

Runs ``python3 chip_smoke.py`` from each checkout root in the order given
(for two commits: parent, change, change, parent), stamps each line of its
output with the seconds since the run started, and writes to ``OUT.json``,
for each run, its exit code, its total seconds and the seconds of each
phase: the time from the line before to the line that reports it, summed
by the line's ``phase`` (and, for the surfaces phase, its ``part``).
Prints one line a run.  Each run's output and errors go beside
``OUT.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


def run(root: str, log_stem: str) -> dict:
    t0 = time.perf_counter()
    with open(log_stem + ".err", "w") as err, open(log_stem + ".log", "w") as log:
        proc = subprocess.Popen([sys.executable, "chip_smoke.py"], cwd=root, text=True,
                                stdout=subprocess.PIPE, stderr=err)
        phases: dict = {}
        last = 0.0
        for line in proc.stdout:
            now = time.perf_counter() - t0
            log.write(f"{now:.3f} {line}")
            try:
                rec = json.loads(line)
            except ValueError:
                rec = None
            key = "other"
            if isinstance(rec, dict) and "phase" in rec:
                key = rec["phase"] + (f" / {rec['part']}" if "part" in rec else "")
            phases[key] = phases.get(key, 0.0) + now - last
            last = now
        rc = proc.wait()
    return {"root": root, "rc": rc, "seconds": time.perf_counter() - t0, "phase_seconds": phases}


def main(argv) -> int:
    if len(argv) < 2:
        raise SystemExit(__doc__)
    out, roots = argv[0], argv[1:]
    runs = []
    for k, root in enumerate(roots):
        stem = os.path.splitext(out)[0] + f".run{k}"
        runs.append(run(root, stem))
        print(json.dumps({key: runs[-1][key] for key in ("root", "rc", "seconds")}), flush=True)
    with open(out, "w") as f:
        json.dump(runs, f, indent=1)
    return max(r["rc"] for r in runs) != 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
