#!/usr/bin/env python3
"""Time the 8-direction fill and the cross arms of the package found from
the current directory on ad_census FULL's real inputs, and profile, by
``clock64``, the per-pixel walks of their first designs, on one NVIDIA GPU.

    python3 stereo_match_traditional_tpu_torch/tools/fill_arms_probe.py [--walks] [OUT.json]

Run from a checkout's root; to compare two trees, run it from each root in
turn on the same card (A, B, B, A): it imports the package of the root it
runs in.  Inputs, at 375x450/D=60 and 720x1280/D=128: FULL's
speckle-filtered LR map with its occlusion and mismatch masks (the fill's
rays capped at D - 1 axis steps, as FULL calls it, and to the border, as
sad's post does) and the left image (the arms, max_length 34).  For each
shape one JSON line: each call's median ms over 20 calls (CUDA events, a
synchronize a call), back to back (20 enqueued at once), and the device ms
of each kernel of one call (``torch.profiler``, 5 calls).

``--walks`` adds the profile: copies of the first designs' kernels (one
thread a pixel stepping along a ray or an arm, one cached load a step,
stopping at the first hit) with a cycle and a step counter a thread, built
by nvcc from the source below into the package's gitignored
``ops/kernels/_build/probe/``; for each input one JSON line: the share of
threads that walk, their mean steps and the mean of each warp's longest
walk, a warp's slowest lane against its mean walking lane (cycles), and
the cycles a step of each warp's slowest lane (median).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The first design's fill pass (a target pixel walks 8 rays to the first
// finite value within the cap), timed a thread.
__global__ void __launch_bounds__(256)
walk_fill(const float* __restrict__ in, const uint8_t* __restrict__ mask, float* out, int h,
          int w, int cap_axis, int cap_diag, long long* cycles, int* steps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long t0 = clock64();
  const long long p = (long long)i * w + j;
  const float v = __ldg(in + p);
  const bool target = __ldg(mask + p) != 0 && !isfinite(v);
  float res = v;
  int n = 0;
  if (target) {
    const int di[8] = {0, 0, 1, -1, 1, -1, 1, -1};
    const int dj[8] = {1, -1, 0, 0, 1, -1, -1, 1};
    float cand[8];
    int k = 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int cap = r < 4 ? cap_axis : cap_diag;
      int ii = i, jj = j;
      for (int t = 1; t <= cap; ++t) {
        ii += di[r];
        jj += dj[r];
        if (ii < 0 || ii >= h || jj < 0 || jj >= w) break;
        const float u = __ldg(in + (long long)ii * w + jj);
        ++n;
        if (isfinite(u)) {
          int m = k++;
          while (m > 0 && cand[m - 1] > u) {
            cand[m] = cand[m - 1];
            --m;
          }
          cand[m] = u;
          break;
        }
      }
    }
    if (k > 0) res = cand[k > 1 ? 1 : 0];
  }
  out[p] = res;
  cycles[p] = clock64() - t0;
  steps[p] = n;
}

// The first design's arms of a grey u8 image: four walks of up to
// max_length steps, each stopping at its first refused offset.
__global__ void __launch_bounds__(256)
walk_arms(const uint8_t* __restrict__ img, int h, int w, int max_length, int sec_length,
          float tao1, float tao2, int* out, long long* cycles, int* steps) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= h || j >= w) return;
  const long long t0 = clock64();
  const long long p = (long long)i * w + j;
  const float c = (float)__ldg(img + p);
  int n = 0, total = 0;
  for (int a = 0; a < 4; ++a) {
    const bool vertical = a >= 2;
    const int sign = (a & 1) ? 1 : -1;
    const int pos = vertical ? i : j, size = vertical ? h : w;
    int leading = 0;
    for (int o = 1; o <= max_length; ++o) {
      const int t = pos + sign * o;
      if (t < 0 || t > size - 1) break;
      const long long q = vertical ? (long long)t * w + j : (long long)i * w + t;
      ++n;
      const float diff = fabsf((float)__ldg(img + q) - c);
      if (!(diff <= (o <= sec_length ? tao1 : tao2))) break;
      ++leading;
    }
    total += leading;
  }
  out[p] = total;
  cycles[p] = clock64() - t0;
  steps[p] = n;
}

extern "C" int probe_fill(const void* in, const void* mask, void* out, int h, int w,
                          int cap_axis, int cap_diag, void* cycles, void* steps) {
  walk_fill<<<dim3((w + 31) / 32, (h + 7) / 8), dim3(32, 8)>>>(
      (const float*)in, (const uint8_t*)mask, (float*)out, h, w, cap_axis, cap_diag,
      (long long*)cycles, (int*)steps);
  return (int)cudaGetLastError();
}

extern "C" int probe_arms(const void* img, int h, int w, int max_length, int sec_length,
                          float tao1, float tao2, void* out, void* cycles, void* steps) {
  walk_arms<<<dim3((w + 31) / 32, (h + 7) / 8), dim3(32, 8)>>>(
      (const uint8_t*)img, h, w, max_length, sec_length, tao1, tao2, (int*)out,
      (long long*)cycles, (int*)steps);
  return (int)cudaGetLastError();
}
"""


def _library(build_dir: Path) -> ctypes.CDLL:
    from stereo_match_traditional_tpu_torch.ops.kernels import build

    digest = hashlib.sha256(SOURCE.encode()).hexdigest()[:16]
    lib = build_dir / f"libfill_arms_probe_{digest}.so"
    if not lib.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        src = build_dir / f"fill_arms_probe_{digest}.cu"
        src.write_text(SOURCE)
        cmd = [build._nvcc(), *build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-o", str(lib), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    so = ctypes.CDLL(str(lib))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.probe_fill.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp, vp]
    so.probe_arms.argtypes = [vp, i32, i32, i32, i32, f32, f32, vp, vp, vp]
    so.probe_fill.restype = so.probe_arms.restype = i32
    return so


def _warp_stats(cycles, steps, walking):
    """The numbers of one input: a warp is 32 consecutive columns of a row
    (blocks of 32 x 8 threads); ratios are taken within each warp that
    holds a walking lane, then averaged over those warps."""
    import torch

    h, w = cycles.shape
    pad = -w % 32

    def warps(x, fill):
        return torch.nn.functional.pad(x, (0, pad), value=fill).reshape(h, -1, 32)

    c = warps(cycles.double(), 0.0)
    s = warps(steps.double(), 0.0)
    walk = warps(walking, False)
    busy = walk.any(-1)
    c, s, walk = c[busy], s[busy], walk[busy]
    n = walk.sum(-1)
    mean_cycles = torch.where(walk, c, 0.0).sum(-1) / n
    mean_steps = torch.where(walk, s, 0.0).sum(-1) / n
    slow = c.argmax(-1, keepdim=True)
    slow_cycles = c.gather(-1, slow).squeeze(-1)
    slow_steps = s.gather(-1, slow).squeeze(-1)
    per_step = (slow_cycles / slow_steps.clamp(min=1))[slow_steps > 0]
    return {
        "walking_share": float(walking.double().mean()),
        "warps_with_a_walker": int(busy.sum()), "warps": int(busy.numel()),
        "walking_lanes_a_warp_mean": float(n.double().mean()),
        "walking_lane_steps_mean": float(s[walk].mean()),
        "warp_longest_walk_steps_mean": float(s.amax(-1).mean()),
        "warp_longest_over_mean_walk_steps": float((s.amax(-1) / mean_steps.clamp(min=1)).mean()),
        "warp_slowest_lane_cycles_mean": float(slow_cycles.mean()),
        "warp_slowest_over_mean_walking_lane_cycles": float((slow_cycles / mean_cycles).mean()),
        "steps_max": int(s.max()),
        "cycles_a_step_of_the_slowest_lane_median": float(per_step.median()),
    }


def _timed(call, reps=20):
    """The median ms of ``reps`` synchronized calls, and of one call of
    ``reps`` enqueued back to back (CUDA events)."""
    import torch

    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        call()
    b.record()
    torch.cuda.synchronize()
    times.sort()
    return times[reps // 2], a.elapsed_time(b) / reps


def _kernels(call, reps=5):
    """Device ms of each kernel of one call (summed by name), from a
    trace of ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key[:60]: e.device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_time_total > 0}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    walks = "--walks" in argv
    argv = [a for a in argv if a != "--walks"]
    sys.path.insert(0, os.getcwd())
    import torch

    from stereo_match_traditional_tpu_torch.config import ADCensusConfig, ScanlineConfig
    from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, build, scanline_cuda,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    if not torch.cuda.is_available():
        raise SystemExit("fill_arms_probe.py: no CUDA device")
    build.library()
    so = _library(build.BUILD_DIR / "probe") if walks else None
    smi = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    head = {"root": os.getcwd(), "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi.strip()}
    lines = []
    for (h, w, d), seed in (((375, 450, 60), 0), ((720, 1280, 128), 1)):
        cfg = ADCensusConfig(disp_range=d, scanline=ScanlineConfig(), run_post=True)
        L, R, _ = make_pair(h, w, d, seed=seed)
        lt, rt = pair_to_torch(L, R, "cuda")
        vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
        arms_l, arms_r = aggregate.cross_arms(lt, cfg.arms), aggregate.cross_arms(rt, cfg.arms)
        span = cfg.arms.max_length
        agg_l = aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=span)
        agg_r = aggregate.rect_mean_aggregate(vol_r, arms_r, max_span=span)
        opt = scanline_cuda.scanline_optimize_cuda(agg_l, lt, cfg.scanline)
        lr = post.lr_check_consistency(wta.wta(opt), wta.wta(agg_r), cfg.lr_gate, post.INVALID)
        spk = post.remove_speckles(lr.disp, cfg.speckle_diff, cfg.speckle_area,
                                   invalid_value=post.INVALID)
        fill = lambda: post.fill_holes_8dir(spk, lr.occlusion, lr.mismatch,  # noqa: E731
                                            post.INVALID, d)
        fill_sad = lambda: post.fill_holes_8dir(spk, lr.occlusion,  # noqa: E731
                                                lr.mismatch, post.INVALID)
        arms = lambda: aggregate.cross_arms(lt, cfg.arms)  # noqa: E731
        want = post._fill_holes_8dir_plain(spk, lr.occlusion, lr.mismatch, post.INVALID, d)
        rec = {**head, "part": "timing", "shape": [h, w], "disp_range": d,
               "fill_equal_to_plain": bool(torch.equal(fill(), want)),
               "arms_equal_to_plain": all(torch.equal(a, b) for a, b in zip(
                   arms(), aggregate._cross_arms_plain(lt, cfg.arms)))}
        for name, call in (("fill_holes_8dir, caps D - 1", fill),
                           ("fill_holes_8dir, rays to the border", fill_sad),
                           ("cross_arms, one image", arms)):
            ms, b2b = _timed(call)
            rec[name] = {"ms": ms, "back_to_back_ms": b2b, "kernels_ms": _kernels(call)}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
        if not walks:
            continue
        first = torch.where(spk == post.INVALID, float("inf"), spk).contiguous()
        mask = lr.occlusion.contiguous()
        axis = d - 1
        for label, caps in ((f"fill pass 1, caps {axis} / {round(axis * 0.70710678)}",
                             (axis, int(round(axis * 0.70710678)))),
                            ("fill pass 1, rays to the border", (max(h, w), max(h, w)))):
            out = torch.empty_like(first)
            cycles = torch.empty((h, w), dtype=torch.int64, device="cuda")
            steps = torch.empty((h, w), dtype=torch.int32, device="cuda")
            for _ in range(3):  # the last call's counts: caches warm
                err = so.probe_fill(first.data_ptr(), mask.data_ptr(), out.data_ptr(), h, w,
                                    caps[0], caps[1], cycles.data_ptr(), steps.data_ptr())
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"probe_fill: CUDA error {err}")
            walking = mask & ~torch.isfinite(first)
            lines.append({**head, "part": "walks", "input": label, "shape": [h, w],
                          "disp_range": d, **_warp_stats(cycles, steps, walking)})
            print(json.dumps(lines[-1]), flush=True)
        out = torch.empty((h, w), dtype=torch.int32, device="cuda")
        cycles = torch.empty((h, w), dtype=torch.int64, device="cuda")
        steps = torch.empty((h, w), dtype=torch.int32, device="cuda")
        a = cfg.arms
        for _ in range(3):
            err = so.probe_arms(lt.contiguous().data_ptr(), h, w, a.max_length, a.sec_length,
                                float(a.tao1), float(a.tao2), out.data_ptr(), cycles.data_ptr(),
                                steps.data_ptr())
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"probe_arms: CUDA error {err}")
        lines.append({**head, "part": "walks",
                      "input": "arms of the left image (grey u8, max_length 34)",
                      "shape": [h, w], **_warp_stats(cycles, steps,
                                                     torch.ones_like(steps, dtype=torch.bool))})
        print(json.dumps(lines[-1]), flush=True)
    if argv:
        Path(argv[0]).write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()
