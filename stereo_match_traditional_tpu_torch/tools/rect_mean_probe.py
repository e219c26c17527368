#!/usr/bin/env python3
"""Time the rect-mean kernel (``rect_mean_f32``) of the package found from
the current directory, one view at 375x450/D=60 and 720x1280/D=128, on one
NVIDIA GPU.

    python3 stereo_match_traditional_tpu_torch/tools/rect_mean_probe.py

Run from a checkout's root; to compare two trees, run it from each root in
turn on the same card (A, B, B, A).  For each shape it holds
the kernel to its plain version on an AD-Census volume (``torch.equal``),
counts the values that differ on a random volume, and prints one JSON line:
the wrapper's median ms over 10 calls (CUDA events) and the device ms of
each of its kernels from ``torch.profiler`` over 5 calls.
"""

from __future__ import annotations

import json
import os
import statistics
import sys


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_match_traditional_tpu_torch.config import ADCensusConfig
    from stereo_match_traditional_tpu_torch.ops import aggregate
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, build
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    if not torch.cuda.is_available():
        raise SystemExit("rect_mean_probe.py: no CUDA device")
    build.library()
    out = {"root": os.getcwd(), "device": torch.cuda.get_device_name(0)}
    for h, w, d in ((375, 450, 60), (720, 1280, 128)):
        L, R, _ = make_pair(h, w, d, seed=1)
        lt, rt = pair_to_torch(L, R, "cuda")
        vol = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)[0]
        arms = aggregate.cross_arms(lt, ADCensusConfig().arms)

        def call():
            return aggregate.rect_mean_aggregate(vol, arms)

        if not torch.equal(call(), aggregate._rect_mean_aggregate_plain(vol, arms, True)):
            raise SystemExit(f"rect mean differs from its plain version at {h}x{w}/D={d}")
        gen = torch.Generator(device="cuda").manual_seed(3)
        rnd = torch.rand(vol.shape, device="cuda", generator=gen) * 3
        off = int((aggregate.rect_mean_aggregate(rnd, arms)
                   != aggregate._rect_mean_aggregate_plain(rnd, arms, True)).sum())
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        kernels = {e.key[:60]: e.device_time_total / 5 / 1e3 for e in prof.key_averages()
                   if e.device_time_total > 0}
        out[f"{h}x{w}/D={d}"] = {"ms": statistics.median(times), "kernels_ms": kernels,
                                 "random_values_off": off}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
