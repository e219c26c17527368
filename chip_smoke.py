#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
the sources in the checkout, holds each kernel against its plain PyTorch
version on the card, drives the ``asw`` pipeline through
``get_pipeline("asw")`` at the reference driver's size (375x450, D=60,
win_size=11) and checks its output, then times kernel, plain version and
pipeline with CUDA events.  Each phase prints one JSON line; any failure
raises and exits non-zero.  The last three lines are the card's
``nvidia-smi`` name and power limit, the kernel summary
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# (h, w, D, win_size, seed, view) for the kernel-against-plain check:
# tests/test_kernels.py's three, test_tpu_smoke.py's compiled-kernel
# geometry, the serving range D=128 and the reference driver's size.
KERNEL_GEOMETRIES = [
    (14, 18, 5, 2, 2, "left"),
    (12, 20, 4, 1, 5, "right"),
    (20, 30, 6, 11, 1, "left"),
    (48, 140, 12, 3, 1, "left"),
    (48, 140, 12, 3, 1, "right"),
    (96, 256, 128, 11, 3, "left"),
    (375, 450, 60, 11, 0, "left"),
]
RTOL, ATOL = 1e-4, 1e-3          # the tolerance of tests/test_kernels.py
TEDDY = (375, 450, 60)
MIN_ARGMIN_AGREE = 0.999          # kernel vs plain WTA at Teddy size
MAX_BAD2 = 0.15                   # tests/test_tpu_smoke.py:36
MIN_FINAL_AGREE = 0.99            # disp_final, kernel path vs plain path
MAIN_PATH_CALLS = 3
# (h, w, D, seed) timed at win_size 11: the reference size and the serving range
TIMING_SHAPES = [(375, 450, 60, 0), (96, 256, 128, 3)]


def check(ok: bool, what) -> None:
    """Raise (also under ``python -O``) when a check fails."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> list:
    """Per-call device times in ms, by CUDA events around each call."""
    import torch

    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def alternate(plain, kernel, plain_reps: int, kernel_reps: int):
    """Median ms of each side, timed in turns plain, kernel, kernel, plain
    after one warm-up call each."""
    import torch

    plain()
    kernel()
    torch.cuda.synchronize()
    p = cuda_ms(plain, plain_reps)
    k = cuda_ms(kernel, kernel_reps) + cuda_ms(kernel, kernel_reps)
    p += cuda_ms(plain, plain_reps)
    return statistics.median(k), statistics.median(p)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")

    import numpy as np

    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.asw import _minmax_u8, asw_post
    from stereo_match_traditional_tpu_torch.ops import post, volume, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import asw_cuda, build
    from stereo_match_traditional_tpu_torch.utils.convert import (
        pair_to_torch, result_to_numpy,
    )
    from stereo_match_traditional_tpu_torch.utils.synthetic import (
        bad_pixel_rate, make_pair,
    )

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.library_path()
    build.library()
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "ptxas info" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib_path.name, "ptxas": ptxas})

    # -- 3. kernel against its plain version ------------------------------
    max_abs = 0.0
    for h, w, d, win, seed, view in KERNEL_GEOMETRIES:
        L, R, _ = make_pair(h, w, d, seed=seed)
        lt, rt = pair_to_torch(L, R, "cuda")
        got = asw_cuda.asw_volume_cuda(lt, rt, d, win, view=view)
        want = volume.asw_volume(lt, rt, d, win, view=view)
        torch.cuda.synchronize()
        err = (got - want).abs()
        rec = {"phase": "kernel_check", "geometry": [h, w, d, win, view],
               "max_abs_err": err.max().item(),
               "max_rel_err": (err / want.abs().clamp(min=1e-6)).max().item(),
               "finite": bool(torch.isfinite(got).all())}
        if (h, w, d) == TEDDY:
            rec["argmin_agree"] = (wta.wta(got) == wta.wta(want)).float().mean().item()
        emit(rec)
        max_abs = max(max_abs, rec["max_abs_err"])
        check(got.shape == (d, h, w) and rec["finite"], rec)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        check(rec.get("argmin_agree", 1.0) >= MIN_ARGMIN_AGREE, rec)

    # -- 4. the slice through its entry point ------------------------------
    h, w, d = TEDDY
    L, R, gt = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    fn, cfg_cls = get_pipeline("asw")
    cfg = cfg_cls()
    check((cfg.disp_range, cfg.win_size) == (d, 11), cfg)
    asw_cuda.LAUNCHES = 0
    for _ in range(MAIN_PATH_CALLS):
        res = fn(lt, rt, cfg)
    torch.cuda.synchronize()
    launches = asw_cuda.LAUNCHES
    check(launches == MAIN_PATH_CALLS, ("launches", launches, MAIN_PATH_CALLS))
    out = result_to_numpy(res)
    plain = result_to_numpy(fn(lt, rt, cfg_cls(use_pallas=False)))
    for f in ("disp_left", "disp_right", "disp_final"):
        v = getattr(out, f)
        check(v.shape == (h, w) and np.isfinite(v).all(), f)
    check(out.disp_left.min() >= 0 and out.disp_left.max() <= d - 1, "disp_left range")
    bad2 = bad_pixel_rate(out.disp_left, gt)
    agree = {f: float((getattr(out, f) == getattr(plain, f)).mean())
             for f in ("disp_left", "disp_right", "disp_final")}
    emit({"phase": "slice", "pipeline": "asw", "shape": [h, w], "disp_range": d,
          "launches": launches, "calls": MAIN_PATH_CALLS, "bad2_left": bad2,
          "agree_with_plain_path": agree})
    check(bad2 <= MAX_BAD2, ("bad2", bad2))
    check(agree["disp_final"] >= MIN_FINAL_AGREE, agree)

    # -- 5. timing (CUDA events, after warm-up) ----------------------------
    timing = {}
    for th, tw, td, seed in TIMING_SHAPES:
        L2, R2, _ = make_pair(th, tw, td, seed=seed)
        l2, r2 = pair_to_torch(L2, R2, "cuda")
        k_ms, p_ms = alternate(
            lambda: volume.asw_volume(l2, r2, td, 11),
            lambda: asw_cuda.asw_volume_cuda(l2, r2, td, 11),
            plain_reps=2, kernel_reps=10,
        )
        lf, rf = l2.float(), r2.float()
        raw_ms = statistics.median(cuda_ms(
            lambda: asw_cuda._launch_left(lf, rf, td, 12, 50.0, 30.0, 40.0), 20))
        timing[th, tw, td] = {"kernel_ms": k_ms, "plain_ms": p_ms}
        emit({"phase": "timing_volume", "shape": [th, tw], "disp_range": td,
              "kernel_ms": k_ms, "launch_only_ms": raw_ms, "plain_ms": p_ms,
              "speedup": p_ms / k_ms})

    fn(lt, rt, cfg)
    pipe_ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 10))
    vol_l = asw_cuda.asw_volume_cuda(lt, rt, d, 11)
    vol_r = volume.right_volume_from_left(vol_l)
    dl, dr = wta.wta(vol_l), wta.wta(vol_r)
    scaled = _minmax_u8(post.lr_check_simple(dl, dr, cfg.lr_gate, invalid_value=0.0).disp)
    stages = {
        "cost_volume_left": lambda: asw_cuda.asw_volume_cuda(lt, rt, d, 11),
        "right_volume_from_left": lambda: volume.right_volume_from_left(vol_l),
        "wta_both": lambda: (wta.wta(vol_l), wta.wta(vol_r)),
        "post": lambda: asw_post(dl, dr, cfg),
        "post.remove_speckles": lambda: post.remove_speckles(
            scaled, cfg.speckle_diff, cfg.speckle_area + 1, invalid_value=0.0,
            connectivity=4),
    }
    stage_ms = {k: statistics.median(cuda_ms(f, 10)) for k, f in stages.items()}
    emit({"phase": "timing_pipeline", "pipeline": "asw", "shape": [h, w],
          "disp_range": d, "pipeline_ms": pipe_ms,
          "mpixdisp_per_s": h * w * d / (pipe_ms / 1e3) / 1e6,
          "stage_ms": stage_ms,
          "speckle_share": stage_ms["post.remove_speckles"] / pipe_ms})

    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")
    teddy = timing[TEDDY]
    print(smi, flush=True)
    emit({"kernels": [{
        "name": "asw_volume_left_f32",
        "route": "cuda",
        "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/asw_volume.cu",
        "replaces": "stereo_match_traditional_tpu/ops/kernels/asw_pallas.py:131",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": teddy["kernel_ms"],
        "plain_ms": teddy["plain_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
