"""The readings that a cell's limit on ``pixels_off`` is set from, taken on
the card at the cell's own size, in one process:

* the lower reading: the program, run as the benchmark runs it
  (``run.run_cell``, a short window), on each ``--seeds`` seed;
* the upper reading: the control, the plain reference computed with its
  volumes in bfloat16 (the step below the configuration's float32 that a
  faster program would be tempted by; the pipeline has no matrix product,
  so TF32 would change nothing), put in the program's place on the same
  number of pairs a run samples, on each ``--control-seeds`` seed.

    python3 cardbench/control.py --workload <name> --seeds 1 2 ... \\
        --control-seeds 7 8 9 --seconds 3 --out chiprun_out/control.jsonl

Each reading is one JSON line in ``--out``; a last line gives each side's
extreme: the program's largest, the control's smallest.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):
    sys.path[0] = str(Path(__file__).resolve().parents[1])


def control_reading(workload: str, seed: int, device: str = "cuda", traffic: dict = None) -> dict:
    """The control's ``pixels_off``: the bfloat16 reference against the
    float32 one on ``sample_maps + 2`` of the cell's pairs drawn from the
    seed (as many maps as a run compares)."""
    import random

    import torch

    from cardbench import check, manifest
    from cardbench.traffic import make_pairs

    cell = manifest.workload(manifest.load(), workload)
    conf = manifest.config(cell["config"])
    traf = traffic or manifest.traffic(cell["traffic"])
    pairs = make_pairs(traf, seed)
    picks = random.Random(seed).sample(range(len(pairs)), min(len(pairs), traf["sample_maps"] + 2))
    args = (pairs, picks, conf, traf["disp_range"], device)
    ref = check.reference_maps(*args)
    low = check.reference_maps(*args, dtype=torch.bfloat16)
    reads = [check.pixels_off(low[k], ref[k]) for k in picks]
    return {"side": "control", "seed": seed, "value": max(reads), "maps": reads}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from cardbench.run import run_cell

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    lines = []
    with open(args.out, "a") as f:
        def emit(rec):
            lines.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            print(json.dumps(rec)[:300], flush=True)

        for seed in args.seeds:
            t = time.perf_counter()
            out = run_cell(args.workload, seed, args.seconds, False)
            emit({"side": "program", "workload": args.workload, "seed": seed,
                  "value": out["compared"]["pixels_off"]["value"], "correct": out["correct"],
                  "attempted": out["attempted"], "metrics": out["metrics"],
                  "seconds": time.perf_counter() - t})
        for seed in args.control_seeds:
            t = time.perf_counter()
            rec = control_reading(args.workload, seed)
            rec.update(workload=args.workload, seconds=time.perf_counter() - t)
            emit(rec)
        prog = [r["value"] for r in lines if r["side"] == "program"]
        ctrl = [r["value"] for r in lines if r["side"] == "control"]
        emit({"side": "summary", "workload": args.workload,
              "program_max": max(prog, default=None), "control_min": min(ctrl, default=None),
              "program_seeds": len(prog), "control_seeds": len(ctrl)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
