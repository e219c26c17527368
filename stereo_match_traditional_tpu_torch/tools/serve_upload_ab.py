#!/usr/bin/env python3
"""``serve_pairs``'s plain upload against a copy stream with pinned staging,
timed on the card in one process.

    python3 -m stereo_match_traditional_tpu_torch.tools.serve_upload_ab [--pairs 240] [--windows 3]

Serves the ad_census active path at Teddy size (375x450, D=60) in batches
of 3 over `utils.loader.PairLoader`, from 8 PGM pairs (``make_pair`` seeds
0-7) cycled to ``--pairs`` pairs a window, ``--windows`` windows of each
way in turns (A, B, B, A, ...).  The copy-stream way uploads the next batch
on a second stream from pinned memory while the current batch runs; both
ways must yield the same maps.  Prints one JSON line: the card, and each
way's ms a pair (host clock) by window, with median, min and max.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import tempfile
import time

SEEDS = 8
BATCH = 3


def copy_stream_serve(run, pairs):
    """A serving loop that uploads each next batch on a copy stream from
    pinned host memory while the current batch runs."""
    import numpy as np
    import torch

    stream = torch.cuda.Stream()
    it = iter(pairs)

    def upload():
        batch = list(itertools.islice(it, BATCH))
        if not batch:
            return None
        with torch.cuda.stream(stream):
            dev = [torch.from_numpy(np.stack(side)).pin_memory().to("cuda", non_blocking=True)
                   for side in zip(*batch)]
            done = torch.cuda.Event()
            done.record(stream)
        return dev, done

    nxt = upload()
    while nxt is not None:
        (ls, rs), done = nxt
        torch.cuda.current_stream().wait_event(done)
        for t in (ls, rs):
            t.record_stream(torch.cuda.current_stream())
        res = run(ls, rs)
        nxt = upload()
        yield from res.disp_left.cpu().numpy()


def main() -> None:
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import ADCensusConfig
    from stereo_match_traditional_tpu_torch.models.batch import batched_pipeline, serve_pairs
    from stereo_match_traditional_tpu_torch.utils import loader
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=240)
    ap.add_argument("--windows", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_upload_ab: no CUDA device")

    cfg = ADCensusConfig()
    run = batched_pipeline("ad_census", cfg)
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k in range(SEEDS):
            a, b, _ = make_pair(375, 450, 60, seed=k)
            paths.append((os.path.join(tmp, f"l{k}.pgm"), os.path.join(tmp, f"r{k}.pgm")))
            loader.write_pnm(paths[-1][0], a)
            loader.write_pnm(paths[-1][1], b)
        stream = (paths * -(-args.pairs // SEEDS))[:args.pairs]
        ways = {
            "serve_pairs (plain upload)": lambda: list(serve_pairs(
                "ad_census", loader.PairLoader(stream), cfg, batch_size=BATCH)),
            "copy stream, pinned": lambda: list(copy_stream_serve(
                run, loader.PairLoader(stream))),
        }
        want = ways["serve_pairs (plain upload)"]()              # warm-up and reference
        ms = {k: [] for k in ways}
        for k in range(args.windows):
            for way in (list(ways) if k % 2 == 0 else list(ways)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = ways[way]()
                ms[way].append((time.perf_counter() - t0) * 1e3 / args.pairs)
                if not all(np.array_equal(g, w) for g, w in zip(got, want, strict=True)):
                    raise RuntimeError(f"{way}: maps differ")
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "pairs_a_window": args.pairs, "batch_size": BATCH,
                      "ms_a_pair": {k: {"median": statistics.median(v), "min": min(v),
                                        "max": max(v), "windows": v} for k, v in ms.items()}}))


if __name__ == "__main__":
    main()
