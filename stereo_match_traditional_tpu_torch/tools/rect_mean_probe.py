#!/usr/bin/env python3
"""Time the rect mean and the speckle filter of the package found from the
current directory, at 375x450/D=60 and 720x1280/D=128, on one NVIDIA GPU,
with the device time of each of their kernels.

    python3 stereo_match_traditional_tpu_torch/tools/rect_mean_probe.py

Run from a checkout's root; to compare two trees, run this script from each
root in turn on the same card (A, B, B, A): it imports the package of the
root it runs in, so one copy of it times both.  For each shape it builds
ad_census FULL's real inputs with the package's own kernels (the left
AD-Census volume and arms; the LR check's map), and for each call:

* the rect mean of one view as the main path calls it (``max_span`` = the
  arms' cap: the strip walker where the package has one) and without a cap
  (the chunked-table kernels): held to the plain version (``torch.equal``),
  the values off on a random volume counted, and the arms over the cap (the
  walker's device word, where the package has it);
* the speckle filter on the LR map: held to its plain version;

it prints one JSON line: the wrapper's median ms over 10 calls (CUDA
events) and the device ms of each kernel and memset of one call from
``torch.profiler`` over 5 calls.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def main() -> None:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stereo_match_traditional_tpu_torch.config import ADCensusConfig, ScanlineConfig
    from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, aggregate_cuda, build, scanline_cuda,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    if not torch.cuda.is_available():
        raise SystemExit("rect_mean_probe.py: no CUDA device")
    build.library()
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"root": os.getcwd(), "device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi.strip()}
    over_cap = getattr(aggregate_cuda, "arms_over_cap", None)

    def timed(call):
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
        return {"ms": statistics.median(times), "kernels_ms": kernels}

    for h, w, d in ((375, 450, 60), (720, 1280, 128)):
        cfg = ADCensusConfig(disp_range=d, scanline=ScanlineConfig(), run_post=True)
        span = cfg.arms.max_length
        L, R, _ = make_pair(h, w, d, seed=1)
        lt, rt = pair_to_torch(L, R, "cuda")
        vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
        arms_l = aggregate.cross_arms(lt, cfg.arms)
        arms_r = aggregate.cross_arms(rt, cfg.arms)
        agg_l = aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=span)
        agg_r = aggregate.rect_mean_aggregate(vol_r, arms_r, max_span=span)
        opt = scanline_cuda.scanline_optimize_cuda(agg_l, lt, cfg.scanline)
        lr = post.lr_check_consistency(wta.wta(opt), wta.wta(agg_r), cfg.lr_gate, post.INVALID)
        del vol_r, agg_l, agg_r, opt
        gen = torch.Generator(device="cuda").manual_seed(3)
        rnd = torch.rand(vol_l.shape, device="cuda", generator=gen) * 3
        rec = {}
        for label, cap in (("main path (max_span)", span), ("no cap", None)):
            if over_cap:
                over_cap("cuda", reset=True)

            def call(cap=cap):
                return aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=cap)

            if not torch.equal(call(), aggregate._rect_mean_aggregate_plain(vol_l, arms_l, True)):
                raise SystemExit(f"rect mean ({label}) differs from plain at {h}x{w}/D={d}")
            got = aggregate.rect_mean_aggregate(rnd, arms_l, max_span=cap)
            want = aggregate._rect_mean_aggregate_plain(rnd, arms_l, True)
            rec[f"rect mean, {label}"] = {
                **timed(call), "random_values_off": int((got != want).sum()),
                "random_max_ulps": int((got.view(torch.int32) - want.view(torch.int32))
                                       .abs().max()),
                "arms_over_cap": over_cap("cuda") if over_cap else None}

        def speckles():
            return post.remove_speckles(lr.disp, cfg.speckle_diff, cfg.speckle_area,
                                        invalid_value=post.INVALID)

        if not torch.equal(speckles(), post._remove_speckles_plain(
                lr.disp, cfg.speckle_diff, cfg.speckle_area, post.INVALID, None, None, 8)):
            raise SystemExit(f"speckle filter differs from plain at {h}x{w}")
        rec["remove_speckles"] = timed(speckles)
        out[f"{h}x{w}/D={d}"] = rec
        del vol_l, rnd, lr
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
