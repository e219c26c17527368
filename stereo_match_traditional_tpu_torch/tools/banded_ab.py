#!/usr/bin/env python3
"""The banded scanline kernels of several checkouts on one card, at the
shapes the executors give them.

    python3 -m stereo_match_traditional_tpu_torch.tools.banded_ab [--wide] OUT.json ROOT [ROOT ...]

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

``--wide`` runs the set above 256 disparities instead: each root's wide
banded kernel (through ``_launch``: one vertical pass of a ``[D, H, W]``
volume's ``permute(1, 0, 2)``; through ``_rows``: both horizontal passes of
the volume, as the band entries and the composed routes run them, a copy
included where the root makes one) at [300, 375, 450], at the Middlebury
2014 full-size geometry [290, 1988, 2880] and on a [800, 256, 2880] band,
with each root's own penalties (scales) of random images; then ad_census
FULL and canonical FULL through ``get_pipeline`` on ``make_pair(994, 1440,
320)`` and streamed (``run_streamed``, ``streamed_canonical_staged``) on
``make_pair(1988, 2880, 290)``: ms a pair (median of 2 calls after one),
peak allocated and reserved memory, a SHA-256 of the maps and, streamed,
the device ms of each ``stereo/`` range (``chip_smoke.profiled_stages`` of
the root).
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


# (label, D, H, W, timed calls) of the wide set, and its pipelines
WIDE_CASES = [("Teddy", 300, 375, 450, 10), ("full size", 290, 1988, 2880, 4),
              ("D=800 band", 800, 256, 2880, 4)]
WIDE_HALF = (994, 1440, 320)
WIDE_FULL = (1988, 2880, 290)


def _sha(xs, chunk: int = 1 << 26) -> str:
    """A SHA-256 of the tensors' values, by chunks of ``chunk`` values summed
    on the card (as 32-bit words, plainly and position-weighted), so that a
    volume of several GB is not copied to the host."""
    import torch

    digest = hashlib.sha256()
    for x in xs:
        flat = x.contiguous().reshape(-1)
        digest.update(str((x.dtype, tuple(x.shape))).encode())
        for i in range(0, flat.numel(), chunk):
            words = flat[i:i + chunk].view(torch.int32).to(torch.int64)
            weights = torch.arange(words.numel(), device=words.device) % 65521 + 1
            digest.update(f"{words.sum().item()} {(words * weights).sum().item()}".encode())
    return digest.hexdigest()


def _median_ms(fn, reps: int):
    import torch

    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times


def wide_child(root: str) -> None:
    sys.path.insert(0, root)
    os.environ["TEARDOWN_CUPTI"] = "0"
    import torch

    t0 = time.perf_counter()
    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import build
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
    from stereo_match_traditional_tpu_torch.parallel import (
        run_streamed, streamed_canonical_staged,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    build.library()
    print(json.dumps({"build_seconds": time.perf_counter() - t0}), flush=True)
    for label, d, h, w, reps in WIDE_CASES:
        g = torch.Generator(device="cuda").manual_seed(d + h + w)
        vol = torch.rand((d, h, w), device="cuda", generator=g) * 20
        base, match = (torch.randint(0, 256, (h, w), device="cuda", generator=g,
                                     dtype=torch.uint8) for _ in range(2))
        for canonical in (False, True):
            a, b = (1.0, 3.0) if canonical else (0.5, 0.0)
            family = "canonical" if canonical else "legacy"
            for layout in ("vertical", "rows"):
                if layout == "vertical":
                    pen = (scanline.vertical_scales(d, base, match, 15.0, False)[:-1]
                           if canonical else scanline.vertical_p2(base, a, 4.0)[0])
                    zero = (torch.zeros((d, w), device="cuda"), torch.zeros((w,), device="cuda"))

                    def call():
                        return banded._launch(canonical, vol.permute(1, 0, 2), pen, zero, None,
                                              a, b, True, False, True)[:1]
                    moved = 8 * d * h * w + 4 * pen.numel()
                else:
                    s_ = scanline.horizontal_scales(d, base, match, 15.0, False) if canonical \
                        else None
                    lr, rl = (s_[:-1], s_[1:]) if canonical \
                        else scanline.horizontal_p2(base, a, 4.0)

                    def call():
                        return banded._rows(canonical, vol, lr, rl, a, b)
                    moved = 2 * 8 * d * h * w + 4 * (lr.numel() + rl.numel())
                out = call()
                torch.cuda.synchronize()
                sha = _sha(out)
                del out
                ms, times = _median_ms(call, reps)
                rec = {"case": label, "family": family, "layout": layout, "shape": [d, h, w],
                       "ms": ms, "ms_all": times, "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                       "sha256": sha, "store": True, "launches": dict(banded.LAUNCHES)}
                rec["share_of_bound"] = rec["bound_ms"] / ms
                print(json.dumps(rec), flush=True)
                if layout == "vertical":
                    del pen, zero
                else:
                    del lr, rl, s_
                torch.cuda.empty_cache()
        del vol
        torch.cuda.empty_cache()

    import chip_smoke  # the root's: its profiled_stages

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        res = fn()
        torch.cuda.synchronize()
        return res, torch.cuda.max_memory_allocated() - before, torch.cuda.max_memory_reserved()

    fn = get_pipeline("ad_census")[0]
    for how, (h, w, d) in (("direct", WIDE_HALF), ("streamed", WIDE_FULL)):
        L, R, _ = make_pair(h, w, d, seed=0)
        lt, rt = pair_to_torch(L, R, "cuda")
        for label, cfg in (
                ("FULL", C.ADCensusConfig(disp_range=d, scanline=C.ScanlineConfig(),
                                          run_post=True)),
                ("canonical FULL", C.ADCensusConfig(disp_range=d, aggregation="cross_two_pass",
                                                    scanline=C.ScanlineConfig(),
                                                    run_post=True))):
            if how == "direct":
                call = lambda: fn(lt, rt, cfg)  # noqa: E731
            elif label == "FULL":
                call = lambda: run_streamed("ad_census", lt, rt, cfg)  # noqa: E731
            else:
                staged = streamed_canonical_staged(cfg)
                call = lambda: staged(lt, rt)  # noqa: E731
            rec = {"case": f"{how} {label}", "shape": [h, w], "disp_range": d,
                   "store": True, "family": "pipeline"}
            try:
                res, peak, reserved = peak_of(call)
                rec["sha256"] = _sha([x for x in res if x is not None])
                del res
                ms, times = _median_ms(call, 2)
                rec.update(ms_a_pair=ms, ms_all=times, peak_bytes=peak,
                           peak_reserved_bytes=reserved)
                if how == "streamed":
                    rec["stage_ms"] = chip_smoke.profiled_stages(call, 1, warm_up=False)
            except torch.cuda.OutOfMemoryError as e:  # a result of its own: the root needs more
                rec["out_of_memory"] = str(e).splitlines()[0]
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
        del lt, rt
        torch.cuda.empty_cache()


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


def run(root: str, wide: bool = False) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--wide-child" if wide else "--child", os.path.abspath(root)],
                          cwd=root, env=env, capture_output=True, text=True)
    recs = []
    for line in proc.stdout.splitlines():
        try:
            recs.append(json.loads(line))
        except ValueError:
            pass
    return {"root": root, "rc": proc.returncode, "seconds": time.perf_counter() - t0,
            "records": recs, "stderr": proc.stderr[-4000:]}


def main(argv) -> int:
    if len(argv) == 2 and argv[0] in ("--child", "--wide-child"):
        (child if argv[0] == "--child" else wide_child)(argv[1])
        return 0
    wide = bool(argv) and argv[0] == "--wide"
    argv = argv[1:] if wide else argv
    if len(argv) < 2:
        raise SystemExit(__doc__)
    out, roots = argv[0], argv[1:]
    runs = []
    for root in roots:
        runs.append(run(root, wide))
        print(json.dumps({k: runs[-1][k] for k in ("root", "rc", "seconds")}), flush=True)
    agree = {}
    for r in runs:
        for rec in r["records"]:
            if "sha256" in rec:  # (a case that ran out of memory has none)
                key = (f"{rec['case']} | {rec['family']} | {rec.get('layout', '')} | "
                       f"store={rec['store']}")
                agree.setdefault(key, set()).add(rec["sha256"])
    summary = {key: len(hashes) == 1 for key, hashes in agree.items()}
    with open(out, "w") as f:
        json.dump({"runs": runs, "bit_equal_across_runs": summary}, f, indent=1)
    print(json.dumps({"bit_equal_across_runs": all(summary.values()) and bool(summary)}))
    return int(any(r["rc"] for r in runs) or not all(summary.values()))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
