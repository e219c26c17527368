#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's CUDA kernels from
the sources in the checkout and holds each kernel against its plain
PyTorch version on the card; drives the ``asw`` pipeline through
``get_pipeline("asw")`` at the reference driver's size (375x450, D=60,
win_size=11) and the flagship ``ad_census`` pipeline through
``get_pipeline("ad_census")`` in the FULL configuration of
``__graft_entry__.entry()`` at the same size, then ``sad`` (active and with
its post chain), ``ncc`` (the committed D=200 and D=60) and ``cblsm``
(active and with its post chain) at the same size, and the canonical
AD-Census family (``aggregation='cross_two_pass'``: ad_census active and
FULL at the same size and at 720x1280, D=128, cblsm at the same size),
each with its kernels' launch counts set to 0 just before and read just
after, and checks their
output against the ground truth and the port's CPU plain path; then times
kernels, plain versions, pipelines and stages with CUDA events (the
canonical family's stages by the pipeline's own ``stereo/<stage>`` ranges
under ``torch.profiler``).  Then the serving surfaces: each pipeline's
``return_stages`` and its re-entry from the saved stages
(``finish_from_volumes``), the command line as a subprocess, and
``serve_pairs`` over the two prefetching pair loaders (``utils.loader``'s
Python threads and ``utils.native``'s C++ threads, the native host library
built from ``native/stereo_host`` beside the kernels) with their launch
counts, their ms a pair over a served stream of 240 pairs beside the pairs
in memory, and the card's idle share under each.  Then the dormant
variants: the SAD kernel's colour mode against its plain version, and
every variant configuration (ncc ``shifted``, asw ``lab`` and ``grid``,
cblsm's ``sad_mean``, ``sad_mean_v4``, ``local_mean`` and ``rect_mean_v4``,
the speckle filter's block form, the bilateral filter) at the same size
against the port's CPU plain path.  Then the streamed executor
(``parallel.streamed``, phase 21): its banded scanline kernels
and the band entries that run both horizontal passes of a band in one
launch against their plain versions and timed (the band entries also
against the strided banded pair that ran them before, at a 4K-wide band and
at the 4K calls' own band), the five reference configurations
streamed at the same size against the direct path on the card (legacy and
canonical FULL also equal to the strided horizontal passes' maps), legacy
and canonical FULL at 720p with each path's peak memory (and the same
equality, every banded pass also on the wide kernel), the direct path's peak
at 1080x1920, D=256, and 2160x3840, D=256 on the JAX package's
representative pair (active, legacy FULL with penalty_scale='auto',
canonical FULL in two stages), each held to the JAX package's bad-2.0 and
timed, with its band, peak memory, launches and stages; and, one untimed
call each, legacy FULL with the reference's penalties on that pair and the
four paths on the legacy 4K pair, each held to the JAX package's bad-2.0.
Then the tiled executor (``parallel.tiled``, phase 22): the cost kernels'
disparity slices (``d_offset``) against their plain versions and joined
against the whole volume, and timed; the banded vertical kernels at its whole-column shapes
against plain and the wide kernel, and timed; the five reference
configurations at Teddy, the ``(tile, disp)`` runners and legacy and
canonical FULL at 720x1280, D=128 over a world of one in this process
(NCCL; the 720p maps also equal to those with every banded pass on the wide
kernel) and over two processes sharing the card (gloo, ``chip_smoke.py
--tiled-rank``), each against the direct path, with ms a pair, launches and
peak memory.  Then above 256 disparities (phase 23, D=300): every scanline
wrapper's wide route against the CPU plain path bit for bit, the wide
kernel timed against plain at Teddy's size, the Middlebury 2014 full-size
volume and a D=800 band, and ad_census FULL and canonical FULL through
``get_pipeline`` with their launch counts, on a small pair, direct at
994x1440/D=320 and streamed at 1988x2880/D=290 (their scanline passes held
to plain on the card), and ad_census FULL served at 1988x2880/D=290 through
``serve_pairs`` (its route, peak memory, ms a pair and ``stereo/`` ranges).  Then the port's two examples
(phase 24) in this process at 375x450, D=60: ``examples/demo_torch.py``
(the five pipelines, each bad-2.0 within its limit and equal to a direct
call's) and ``examples/serving_torch.py`` (ad_census FULL over the native
``PairLoader``, the maps ``serve_pairs``'), the asw, AD-Census, scanline and
window kernels each launched.  Last the aggregation and post kernels (phase
25: cross arms, the rect mean, the 8-direction fill, the speckle filter):
each against its plain version at five geometries from one row to 720p and
on the real inputs of ad_census FULL at 375x450/D=60 and 720x1280/D=128 and
of the sad, asw and cblsm post chains, timed against it beside its bound;
ad_census FULL at both sizes with its launch counts, device kernels and
stage times beside the same calls on the plain bodies, whose maps it
equals bit for bit, as do sad, asw and cblsm with post there, the 4K
legacy FULL call of phase 21 (its peak memory not above) and the tiled
legacy FULL calls of phase 22.  Then the region voting kernel (phase 26)
on the maps and arms the canonical post hands it at 375x450/D=60,
375x1242/D=128, 720x1280/D=128 and the 4K streamed canonical call's whole
map: bit for bit against the plain body, its targets and launches, timed
in turns with the plain body, back to back and by kernel.  Each
phase prints one JSON line; any failure raises and exits non-zero.  The
last three lines are the card's ``nvidia-smi`` name and power limit, the
kernel summary ``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.
Each kernel of the summary carries its time, its plain version's, and its
bound: the least time the card could take for the same function at the
same shape, the larger of its bytes (every input once, the output once)
over the card's memory rate and its operations (by the cheapest exact
algorithm known) over the card's float32 rate.  No single PyTorch call
computes any of the nineteen entries' functions, so ``library_ms`` is null.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time

# (h, w, D, win_size, seed, view) for the kernel-against-plain check: a
# window above the reference's, tests/test_kernels.py's three,
# test_tpu_smoke.py's compiled-kernel geometry, the serving range D=128 and
# the reference driver's size.
KERNEL_GEOMETRIES = [
    (40, 70, 20, 16, 3, "left"),     # a 35x35 window: 99 KB of shared memory
    (14, 18, 5, 2, 2, "left"),
    (12, 20, 4, 1, 5, "right"),
    (20, 30, 6, 11, 1, "left"),
    (48, 140, 12, 3, 1, "left"),
    (48, 140, 12, 3, 1, "right"),
    (96, 256, 128, 11, 3, "left"),
    (375, 450, 60, 11, 0, "left"),
]
# The tolerance of tests/test_kernels.py.  The kernel's weight is the
# product of two exponentials (ex2.approx, 2^-22) where the plain version
# takes one: a few ulp on a weight, ~2e-5 on a cost of up to 40.
RTOL, ATOL = 1e-4, 1e-3
# The card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TEDDY = (375, 450, 60)
MIN_ARGMIN_AGREE = 0.999          # kernel vs plain WTA at Teddy size
MAX_BAD2 = 0.15                   # tests/test_tpu_smoke.py:36
MIN_FINAL_AGREE = 0.99            # disp_final, kernel path vs plain path
MAIN_PATH_CALLS = 3
# (h, w, D, seed) timed at win_size 11: the reference size and the serving range
TIMING_SHAPES = [(375, 450, 60, 0), (96, 256, 128, 3)]

# (h, w, D, seed) for the AD-Census kernels against their plain versions:
# small odd shapes, one with D > W, the reference size, and ROADMAP's
# serving range (720p, D=128).
AD_CENSUS_GEOMETRIES = [(13, 17, 5, 3), (9, 6, 10, 5), (375, 450, 60, 0), (720, 1280, 128, 1)]
# (h, w, D, seed) for the AD-Census kernel alone, both views from one launch:
# one row, one column, W < 32, W % 4 != 0 over two 128-column strips with a D
# that is no multiple of the 32-disparity chunk, D > W over three chunks, D=256
AD_CENSUS_EDGE_GEOMETRIES = [(1, 40, 7, 1), (33, 1, 9, 2), (9, 20, 12, 4), (20, 131, 33, 7),
                             (6, 9, 70, 8), (16, 300, 256, 9)]
# census windows other than the pipelines' 9 x 7 (the kernel's general census)
OTHER_WINDOWS = [(5, 5), (1, 63)]
# D * H * W above 2^31 (ROADMAP Queue 1 item 9's 4K size), left view: its row
# H - 5 against the plain version on the 9-row band around it
HUGE = (2160, 3840, 256)
# (h, w, D) for the scanline kernel alone, on random costs: one row, one
# column, one pixel, a D above the 32 lanes that is no multiple of them, and
# rows wide enough for its 16-column blocks (W a multiple of 4, and odd with
# D above 128)
SCANLINE_EDGE_GEOMETRIES = [(1, 40, 7), (33, 1, 9), (1, 1, 3), (21, 45, 100),
                            (3, 1100, 20), (2, 1061, 130)]
AD_CENSUS_RTOL = AD_CENSUS_ATOL = 1e-6   # expf's last ulp; AD and Hamming exact
SERVING = (720, 1280, 128)
KITTI = (375, 1242, 128)                 # the benchmark's size (cardbench/traffic/)
# The cross aggregation's later iterations against the plain version: within
# 2 float32 ulps or 2^-40 (tests/test_torch_kernels_cuda.py's CROSS_ULPS,
# CROSS_ATOL give the reason)
CROSS_ULPS, CROSS_ATOL = 2, 2.0**-40
WIDE_D = 200                             # a D above 128, timed for the scanline at Teddy's size
MIN_WTA_AGREE = 0.995                    # card vs the CPU plain path

# (h, w, D, winsize, seed) for the SAD kernel against its plain version:
# small odd shapes, one with D > W, a 61x61 window (above 48 KB of shared
# memory), the reference size (9x9 window); then the edges of the sliding
# design: fewer rows than one run and than the window (5 < 9) with several
# strips and a D that is no multiple of the 32-disparity chunk, one row, one
# column, a W that is no multiple of 4 with a ragged last strip, the largest
# radius taken (65x65), and the serving size (W a multiple of 4, 11 strips)
SAD_GEOMETRIES = [(13, 17, 5, 1, 3), (9, 6, 10, 3, 5), (40, 70, 8, 29, 4), (375, 450, 60, 3, 0),
                  (5, 150, 70, 3, 6), (1, 40, 7, 2, 1), (33, 1, 9, 2, 2), (20, 131, 40, 4, 7),
                  (70, 90, 12, 31, 8), (720, 1280, 128, 3, 1)]
# (h, w, D, win_size, seed) for the NCC kernel: a small odd shape, the
# reference size at D=60 and at the committed D=200, and a window above
# win_size 15, where the sums may round (held within NCC_WIDE_TOL); then the
# same edges as SAD's, D > W, the largest bit-exact window (31x31), the
# largest radius taken (65x65, within NCC_WIDE_TOL) and the serving size
NCC_GEOMETRIES = [(13, 17, 5, 2, 3), (375, 450, 60, 10, 0), (375, 450, 200, 10, 0),
                  (96, 128, 30, 17, 2), (5, 150, 70, 3, 6), (1, 40, 7, 2, 1), (33, 1, 9, 2, 2),
                  (20, 131, 40, 4, 7), (9, 6, 10, 3, 5), (70, 90, 12, 15, 8),
                  (70, 90, 12, 32, 8), (720, 1280, 128, 10, 1)]
NCC_WIDE_TOL = 1e-5
# (h, w, D, radius parameter, seed) for non-integer inputs, where the sliding
# float32 sums round along their walk (window_cost_cuda.FLOAT_RTOL): several
# runs of rows and strips
FLOAT_GEOMETRY = (150, 200, 40, 4, 5)
MAX_BAD2_WINDOW = {"sad": 0.30, "ncc": 0.30, "cblsm": 0.20}  # tests/test_tpu_smoke.py:34-38

# (h, w, D) for the canonical scanline kernel against its plain version, both
# views, on random costs and u8 images: one row, one column, W < 32, a W that
# is no multiple of 4, D > W, D = 256 (8 values a lane) with W % 4 == 0 and
# != 0, 4 values a lane over many tiles of both directions, the reference
# size and the serving size
CANONICAL_GEOMETRIES = [(1, 40, 7), (33, 1, 9), (9, 20, 12), (9, 21, 12), (6, 9, 70),
                        (16, 300, 256), (16, 301, 256), (40, 70, 100), (375, 450, 60),
                        (720, 1280, 128)]
# ... and on non-integer float32 images (the kernel's other image type)
CANONICAL_FLOAT_GEOMETRIES = [(9, 21, 12), (40, 70, 100)]
# (p1, p2, tso) other than the defaults (1, 3, 15), at the two geometries
# above: every edge bit set (tso 0, the clamp triangle's too), none set (tso
# 300), other penalties
CANONICAL_PARAMETERS = [(1.0, 3.0, 0.0), (1.0, 3.0, 300.0), (0.5, 2.0, 15.0)]
# bad-2.0 of the JAX package's canonical family on make_pair(h, w, D, seed=0)
# (BASELINE.md:672-675; hardware-independent): held within CANONICAL_BAD2_TOL
# at the reference size, printed beside the port's at 720p
CANONICAL_BAD2 = {("active", TEDDY): 0.0737, ("FULL", TEDDY): 0.0852,
                  ("active", SERVING): 0.2262, ("FULL", SERVING): 0.2425}
CANONICAL_BAD2_TOL = 0.005
# The stages each configuration's return_stages=True gives, by the JAX
# package's names (its models/*.py)
COST = ["cost_left", "cost_right"]
AGGREGATED = COST + ["aggregated_left", "aggregated_right"]
ARMS_LEFT = [f"arms_left_{k}" for k in ("left", "right", "up", "down")]
SURFACE_STAGES = {"asw": COST, "ad_census": AGGREGATED, "sad": COST[:1], "ncc": COST[:1],
                  "cblsm": AGGREGATED, "ad_census FULL": AGGREGATED,
                  "ad_census canonical FULL": AGGREGATED + ARMS_LEFT}
SERVED_PAIRS = 8                          # make_pair seeds 0-7, served in batches of 3
SERVE_BATCH = 3
# The timed served stream: the 8 PGM pairs cycled to SERVE_STREAM pairs a
# window, SERVE_WINDOWS rotations of one window of each way of serving (the
# ways' order reversed every other rotation); and one window of
# SERVE_TRACED pairs under torch.profiler for the idle share
SERVE_STREAM = 240
SERVE_WINDOWS = 9
SERVE_TRACED = 96
# The trace categories of the card's own work: kernels, copies, fills
# (h, w, D, radius) for the SAD kernel's colour mode (channel_min): one row,
# W % 4 != 0, D > W's share of a strip, CBLSM's win_size 1 (radius 2) at
# Teddy and at the serving size
COLOUR_SAD_GEOMETRIES = [(1, 40, 7, 1), (9, 21, 12, 2), (40, 70, 100, 5), (375, 450, 60, 2),
                         (720, 1280, 128, 2)]
GRID_BAD2 = 0.0858          # asw approx='grid', bins=12, at Teddy (BASELINE.md:435)
GRID_BAD2_TOL = 0.005
WALK_SHAPE = (96, 128, 16)  # where the 625-offset plain loops (Lab, bilateral) meet the CPU
VARIANT_REPS = 3
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_TRIES = 5
# Around the traced calls, each trace runs a lead of small kernels and a
# host pause, before and after: the profiler has lost the first kernels of a
# trace on the card (H100, torch 2.11), all of them in a trace of one short
# call.  The tries each trace took are kept for the "profiler" line
TRACE_LEAD_KERNELS = 64
TRACE_LEAD_SECONDS = 0.05
TRACED_RANGE = "traced_calls"
TRACE_TRIES_TAKEN: list = []
# The streamed executor (phase 21): the five reference configurations at
# Teddy in bands of 128 rows, legacy and canonical FULL at 720p in bands of
# 256, the whole-image path's peak at 1080p/D=256 (four times fewer pixels
# than 4K), and 4K/D=256 on the JAX package's representative pair, whose
# bad-2.0 the runs hold (BASELINE.md:904-909; hardware-independent)
STREAM_TEDDY_TILE = 128
STREAM_SERVING_TILE = 256
DENSE_PROBE = (1080, 1920, 256)
HUGE_PAIR_SCALE = 102
HUGE_BAD2 = {"active": 0.1002, "FULL auto": 0.0681, "canonical FULL": 0.0820}
# The accuracy cells of the same table, one untimed call each: legacy FULL
# with the reference's penalties (P1=10/P2=150) on the representative pair,
# and the four paths on the legacy pair (make_pair's default feature_scale)
HUGE_ACCURACY = {("representative", "FULL parity"): 0.1524, ("legacy", "active"): 0.4337,
                 ("legacy", "FULL parity"): 0.4924, ("legacy", "FULL auto"): 0.4085,
                 ("legacy", "canonical FULL"): 0.4107}
HUGE_BAD2_TOL = 0.005
HUGE_TIMED_CALLS = 2
# The region voting kernel's phase: the canonical post's own inputs at
# Teddy, KITTI (the benchmark's pairs: feature_scale 24 * D // 60) and 720p,
# and the 4K streamed canonical call's whole map
VOTING_SHAPES = [(*TEDDY, 24), (375, 1242, 128, 51), (720, 1280, 128, 51)]
VOTING_KERNELS = ("vote_prep_kernel", "vote_count_kernel", "vote_apply_kernel")
# The tiled executor (phase 22): the d-slices of the two kernels with
# d_offset at Teddy (D=60 in three slices, ncc's committed D=200 in four),
# two ranks on the one card for the two-rank run, timed calls a Teddy run
TILED_OFFSETS = (0, 15, 45)
TILED_NCC_OFFSETS = (0, 50, 100, 150)
TILED_RANKS = 2
TILED_REPS = 3
TILED_TIMEOUT = 420.0
STREAM_AGREE = 0.995        # tests/test_streamed.py's envelope: <= 0.5 % of pixels differ
# (t, D, W) bands for the banded kernels against their plain versions: a
# Teddy band and a 4K-wide band at D=256; the second is also timed
BANDED_CHECKS = [(128, 60, 450), (64, 256, 3840)]
# (t, D, W, cropped) bands for the band entries (both horizontal passes in
# one launch) against their plain versions: BANDED_CHECKS' two (the first
# with W % 4 != 0), a halo-cropped view (not contiguous) with W % 4 != 0,
# and one row; BAND_HALO rows are cropped from each side
HORIZONTAL_CHECKS = [(*BANDED_CHECKS[0], False), (*BANDED_CHECKS[1], False), (48, 200, 301, True),
                     (1, 128, 257, False)]
BAND_HALO = 4
BAND_ENTRIES = ("scanline_horizontal_band_f32", "scanline_canonical_horizontal_band_f32")
# The banded vertical kernels at the tiled executor's whole-column shapes
# (phase 22a'): [D, H, W] = 720p over a world of one and a rank's slab of
# four cards, and Teddy; bit for bit against plain and the wide kernel, timed
TILED_VERTICAL = [(128, 720, 1280), (128, 720, 320), (60, 375, 450)]
# Above 256 disparities (phase 23): the wide route of every scanline wrapper
# on a [D, H, W] volume; ad_census FULL and canonical FULL through
# get_pipeline on a small pair; the wide kernel timed at [D, H, W] = a
# Teddy-sized volume, the Middlebury 2014 full-size geometry (pairs of about
# 2880x1988 whose calib.txt ndisp runs from 260 to several hundred;
# Adirondack's is 290) and a band of the top of ROADMAP's 300-800 range;
# ad_census FULL and canonical FULL direct at the half-size geometry and
# streamed at the full-size one, their scanline passes held to plain
WIDE_ROUTE_D = 300
WIDE_IMAGE = (64, 96)
WIDE_TIMED = {"Teddy": (300, 375, 450), "full size": (290, 1988, 2880),
              "D=800 band": (800, 256, 2880)}
WIDE_PAIR = (24, 320)
WIDE_HALF = (994, 1440, 320)
WIDE_FULL = (1988, 2880, 290)
WIDE_ENTRIES = ("scanline_banded_wide_f32", "scanline_banded_wide_canonical_f32")
# ad_census FULL served at WIDE_FULL through serve_pairs (phase 23c): pairs timed
SERVED_PAIRS = 8
# The port's examples (phase 24): the serving example's pairs and batch
EXAMPLE_PAIRS = 16
EXAMPLE_BATCH = 4
# The aggregation and post kernels (phase 25): (h, w, D, seed) one row, one
# column, W % 4 != 0, the reference size and the serving size; their C
# entries; the FULL calls timed a turn (kernels, plain bodies, twice each)
AGG_POST_GEOMETRIES = [(1, 67, 9, 1), (53, 1, 7, 2), (37, 61, 13, 3), (*TEDDY, 0),
                       (*SERVING, 1)]
AGG_POST_ENTRIES = ("cross_arms_i32", "rect_mean_f32", "rect_mean_walker_f32", "fill_pass_f32",
                    "fill_holes_8dir_f32", "remove_speckles_f32")
AGG_POST_FULL_REPS = 5
# The fill's tiles and the arms' blocks at their edges: (h, w) one row and
# one column at a 4K frame's width and height, sides that 32 and the arms'
# 128-column blocks do not divide, a 4K-wide strip; the fill's max_search
# (caps 0, 1, a word and more, beyond max(H, W), none) and one pass's caps
# (axis, diagonal); the arms' max_length (one offset, the main path's 34,
# groups of offsets past the first 64)
FILL_ARMS_EDGES = [(1, 3840), (2160, 1), (33, 65), (17, 31), (8, 3840)]
FILL_EDGE_SEARCH = [1, 2, 34, 4000, None]
FILL_PASS_CAPS = [(0, 0), (1, 0), (32, 23), (5000, 5000)]
ARM_EDGE_LENGTHS = [1, 34, 65]
# The rect mean's strip walker (rect_mean_walker_f32) at the edges of its
# strips and ring, on integer volumes (exact sums) with arms at the cap:
# (n, h, w, cap) widths 128 does not divide, h < 2L + 2, one row, one
# column, one pixel, the cap 0 and the largest the walker takes (48)
WALKER_EDGES = [(5, 40, 65, 34), (4, 33, 255, 34), (6, 30, 200, 34), (7, 1, 300, 34),
                (7, 300, 1, 34), (3, 1, 1, 34), (4, 26, 95, 0), (3, 140, 301, 48)]
# The speckle filter's tile-local labelling at the edges of its tiles: (h,
# w) of maps that are one component, a checkerboard of single pixels, and
# diagonal stripes that cross many tiles
SPECKLE_EDGES = [(375, 450), (720, 1280), (33, 65), (1, 300), (300, 1)]
# The rect mean on volumes whose float64 sums are not exact: the kernel's
# table is summed in the plain version's order (rows, then down each column
# one row after another), so its means are held within a float32 ulp of the
# plain version's; where the two differ, both are compared with the
# rectangle's direct float64 sum (at most RECT_DIRECT_CHECKS values a
# volume), and the counts are reported
RECT_ULPS = 1
RECT_DIRECT_CHECKS = 2000


def check(ok: bool, what) -> None:
    """Raise (also under ``python -O``) when a check fails."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(bytes_moved: float, flops: float) -> dict:
    """``bound_ms``/``bound_by`` of a function that must move ``bytes_moved``
    and do ``flops`` float32 operations: the larger of the two times at the
    card's published peaks."""
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


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


def back_to_back_ms(fn, reps: int = 20) -> float:
    """Device ms per call: ``reps`` calls enqueued back to back between two
    CUDA events, after a warm-up call, so that the host's part of a call
    hides behind the kernels of the calls before it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def traced_events(fn, reps: int) -> list:
    """The complete events ("X") of a ``torch.profiler`` trace of ``reps``
    calls of ``fn``, host and card, as the exported trace holds them (its
    kernels carry their names and the correlation ids of their launches,
    also of launches made through a C entry).

    The calls run in a ``TRACED_RANGE`` range between two leads
    (``TRACE_LEAD_KERNELS`` small kernels, a host pause of
    ``TRACE_LEAD_SECONDS``, the kernels again, a synchronise), so that a
    loss at either end of the trace falls on a lead; of the card's events
    only those launched inside the range are returned.  A
    trace in which a kernel launched in the range has no kernel event is
    taken again, up to TRACE_TRIES times; the last one is returned, and
    the callers check what they read of it."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    lead = torch.zeros(1024, device="cuda")

    def lead_work():
        for pause in (TRACE_LEAD_SECONDS, 0.0):
            for _ in range(TRACE_LEAD_KERNELS):
                lead.add_(1.0)
            time.sleep(pause)
        torch.cuda.synchronize()

    for tries in range(1, TRACE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead_work()
            with record_function(TRACED_RANGE):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            lead_work()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
        spans = [e for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == TRACED_RANGE]
        check(len(spans) == 1, (TRACED_RANGE, "ranges in the trace", len(spans)))
        span = spans[0]
        launches = [e for e in events if e.get("cat", "").startswith("cuda_")
                    and "correlation" in (e.get("args") or {})
                    and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
        launched = {e["args"]["correlation"] for e in launches}
        events = [e for e in events if e.get("cat") not in DEVICE_EVENTS
                  or (e.get("args") or {}).get("correlation") in launched]
        seen = {e["args"]["correlation"] for e in events if e.get("cat") == "kernel"}
        if all(e["args"]["correlation"] in seen for e in launches
               if "LaunchKernel" in e["name"]):
            break
    TRACE_TRIES_TAKEN.append(tries)
    return events


def profiled_stages(fn, reps: int, warm_up: bool = True) -> dict:
    """Per-call ms of each ``stereo/<stage>`` range that the pipeline marks
    (``utils.profiling.stage_scope``) over ``reps`` calls of ``fn`` under
    ``torch.profiler``, after a warm-up call, read from its trace: of the
    device work launched inside the range (by torch or through a C entry),
    ``device_ms`` its kernels', copies' and fills' time summed and
    ``device_span_ms`` from the first start to the last end; ``host_ms`` the
    range on the host (with the profiler's own overhead)."""
    import torch

    if warm_up:
        fn()
        torch.cuda.synchronize()
    events = traced_events(fn, reps)
    ranges, launches, work = [], [], {}
    for e in events:
        cat, args = e.get("cat", ""), e.get("args") or {}
        if cat == "user_annotation" and e["name"].startswith("stereo/"):
            ranges.append(e)
        elif cat.startswith("cuda_") and "correlation" in args:  # the launching API calls
            launches.append(e)
        elif cat in DEVICE_EVENTS and "correlation" in args:
            work.setdefault(args["correlation"], []).append(e)
    stages = {}
    for r in ranges:
        # one host thread launches all the work, so a launch inside the span
        # of the range is a launch of the range
        done = [w for e in launches if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]
                for w in work.get(e["args"]["correlation"], ())]
        rec = stages.setdefault(r["name"][len("stereo/"):],
                                {"device_ms": 0.0, "device_span_ms": 0.0, "host_ms": 0.0})
        rec["host_ms"] += r["dur"] / 1e3 / reps
        if done:
            rec["device_ms"] += sum(w["dur"] for w in done) / 1e3 / reps
            rec["device_span_ms"] += (max(w["ts"] + w["dur"] for w in done)
                                      - min(w["ts"] for w in done)) / 1e3 / reps
    check(stages and all(r["device_ms"] > 0 for r in stages.values()),
          ("profiled stages", stages, sorted({e.get("cat", "") for e in events})))
    return stages


def cuda_pair(h, w, d, seed):
    """A synthetic scene on the card, or random u8 images where it is too
    small for one."""
    import torch

    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    if min(h, w) == 1:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return tuple(torch.randint(0, 256, (h, w), device="cuda", generator=gen,
                                   dtype=torch.uint8) for _ in range(2))
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    return pair_to_torch(L, R, "cuda")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)")

    import numpy as np

    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.asw import _minmax_u8, asw_post
    from stereo_match_traditional_tpu_torch.ops import post, volume, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import asw_cuda, build
    from stereo_match_traditional_tpu_torch.utils import native
    from stereo_match_traditional_tpu_torch.utils.convert import (
        pair_to_torch, result_to_numpy,
    )
    from stereo_match_traditional_tpu_torch.utils.synthetic import (
        bad_pixel_rate, make_pair,
    )

    # the profiler keeps CUPTI between traces (torch's own setting under CUDA
    # graphs): traces after the first have lost their first kernels, or all
    # of them, and the teardown between traces is the suspect
    os.environ["TEARDOWN_CUPTI"] = "0"

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build: the kernels (nvcc), and the native host library (g++) in
    # a thread beside them
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.library_path)
        lib_path = build.library_path()
        build.library()
        host_lib = host.result()
    log = lib_path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "ptxas info" in ln] if log.exists() else []
    check(native.available(), "the native host library does not load")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": lib_path.name, "ptxas": ptxas, "native_host_library": host_lib.name})

    # -- 3. kernel against its plain version ------------------------------
    max_abs = 0.0
    for h, w, d, win, seed, view in KERNEL_GEOMETRIES:
        L, R, _ = make_pair(h, w, d, seed=seed)
        lt, rt = pair_to_torch(L, R, "cuda")
        got = volume.asw_volume(lt, rt, d, win, view=view)
        want = volume._asw_volume_plain(lt, rt, d, win, view=view)
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
            lambda: volume._asw_volume_plain(l2, r2, td, 11),
            lambda: volume.asw_volume(l2, r2, td, 11),
            plain_reps=2, kernel_reps=10,
        )
        lf, rf = l2.float(), r2.float()
        raw_ms = statistics.median(cuda_ms(
            lambda: asw_cuda.asw_volume_left_cuda(lf, rf, td, 12, 50.0, 30.0, 40.0), 20))
        timing[th, tw, td] = {"kernel_ms": k_ms, "plain_ms": p_ms}
        emit({"phase": "timing_volume", "shape": [th, tw], "disp_range": td,
              "kernel_ms": k_ms, "launch_only_ms": raw_ms, "plain_ms": p_ms,
              "speedup": p_ms / k_ms})

    fn(lt, rt, cfg)
    pipe_ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 10))
    vol_l = volume.asw_volume(lt, rt, d, 11)
    vol_r = volume.right_volume_from_left(vol_l)
    dl, dr = wta.wta(vol_l), wta.wta(vol_r)
    scaled = _minmax_u8(post.lr_check_simple(dl, dr, cfg.lr_gate, invalid_value=0.0).disp)
    stages = {
        "cost_volume_left": lambda: volume.asw_volume(lt, rt, d, 11),
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

    ad = ad_census_phases()
    win = window_phases()
    canon = canonical_phases()
    surfaces_phase(kind)
    var = variants_phase()
    streamed = streamed_phase()
    tiled = tiled_phase(kind)
    wide = wide_phase()
    examples_phase()
    agg = agg_post_phase()
    voting = region_voting_phase()

    for banned in ("jax", "stereo_match_traditional_tpu"):   # the name or a dotted prefix
        loaded = [m for m in sys.modules if m == banned or m.startswith(banned + ".")]
        check(not loaded, (banned, "was imported", loaded[:5]))
    teddy = timing[TEDDY]
    emit({"phase": "profiler", "traces": len(TRACE_TRIES_TAKEN),
          "tries_taken": TRACE_TRIES_TAKEN, "teardown_cupti": os.environ["TEARDOWN_CUPTI"]})
    print(smi, flush=True)
    emit({"kernels": [
        {
            "name": "asw_volume_left_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/asw_volume.cu",
            "replaces": "stereo_match_traditional_tpu/ops/kernels/asw_pallas.py:131",
            "launches": launches,
            "launches_per_call": launches / MAIN_PATH_CALLS,
            "max_abs_err": max_abs,
            "ms": teddy["kernel_ms"],
            "plain_ms": teddy["plain_ms"],
            # two u8 images in, the volume out; per window term a subtract,
            # min(|.|, T), a multiply, an FMA and an add (the factored weight)
            **bound(2 * h * w + 4 * d * h * w, 6.0 * d * h * w * (2 * 12 + 1) ** 2),
            "library_ms": None,
        },
        {
            "name": "ad_census_volume_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/ad_census_cost.cu",
            "replaces": "stereo_match_traditional_tpu/ops/volume.py:554",
            **ad["cost"],
        },
        {
            "name": "scanline_optimize_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:377",
            **ad["scanline"],
        },
        {
            "name": "sad_volume_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/window_cost.cu",
            "replaces": "stereo_match_traditional_tpu/ops/volume.py:224",
            **win["sad_volume_f32"],
            "channel_min": var["channel_min"],
        },
        {
            "name": "ncc_volume_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/window_cost.cu",
            "replaces": "stereo_match_traditional_tpu/ops/volume.py:296",
            **win["ncc_volume_f32"],
        },
        {
            "name": "scanline_canonical_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline_canonical.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:326",
            **{k: v for k, v in canon.items()
               if k not in ("cross_aggregate_f32", "region_voting_f32")},
        },
        {
            "name": "cross_aggregate_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/cross_aggregate.cu",
            "replaces": "stereo_match_traditional_tpu/ops/aggregate.py:792",
            **canon["cross_aggregate_f32"],
        },
        {
            "name": "scanline_banded_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline_banded.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:126",
            **streamed["scanline_banded_f32"],
            "tiled_whole_columns": tiled["vertical"]["scanline_banded_f32"],
        },
        {
            "name": "scanline_banded_canonical_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline_banded.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:266",
            **streamed["scanline_banded_canonical_f32"],
            "tiled_whole_columns": tiled["vertical"]["scanline_banded_canonical_f32"],
        },
        {
            "name": "scanline_banded_wide_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline_banded.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:126",
            **wide["scanline_banded_wide_f32"],
        },
        {
            "name": "scanline_banded_wide_canonical_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline_banded.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:266",
            **wide["scanline_banded_wide_canonical_f32"],
        },
        {
            "name": "scanline_horizontal_band_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:164",
            **streamed["scanline_horizontal_band_f32"],
        },
        {
            "name": "scanline_canonical_horizontal_band_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/scanline_canonical.cu",
            "replaces": "stereo_match_traditional_tpu/ops/scanline.py:298",
            **streamed["scanline_canonical_horizontal_band_f32"],
        },
        {
            "name": "ad_census_volume_f32 (d_offset)",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/ad_census_cost.cu",
            "replaces": "stereo_match_traditional_tpu/ops/volume.py:554",
            **tiled["ad_census_volume_f32"],
        },
        {
            "name": "ncc_volume_f32 (d_offset)",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/window_cost.cu",
            "replaces": "stereo_match_traditional_tpu/ops/volume.py:296",
            **tiled["ncc_volume_f32"],
        },
        *({"name": entry, "route": "cuda",
           "source": f"stereo_match_traditional_tpu_torch/ops/kernels/csrc/{src}",
           "replaces": f"stereo_match_traditional_tpu/ops/{where}", **agg[entry]}
          for entry, src, where in (
              ("cross_arms_i32", "aggregate.cu", "aggregate.py:119"),
              ("rect_mean_f32", "aggregate.cu", "aggregate.py:486"),
              ("rect_mean_walker_f32", "aggregate.cu", "aggregate.py:486"),
              ("fill_pass_f32", "post.cu", "post.py:629"),
              ("fill_holes_8dir_f32", "post.cu", "post.py:658"),
              ("remove_speckles_f32", "post.cu", "post.py:169"))),
        {
            "name": "region_voting_f32",
            "route": "cuda",
            "source": "stereo_match_traditional_tpu_torch/ops/kernels/csrc/region_voting.cu",
            "replaces": "stereo_match_traditional_tpu/ops/post.py:886",
            **canon["region_voting_f32"],
            **voting,
        },
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def ad_census_phases() -> dict:
    """The flagship's phases: its two kernels against their plain versions,
    the FULL slice through ``get_pipeline("ad_census")``, and timings.
    Returns each kernel's summary fields."""
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import ScanlineConfig
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.ad_census import ad_census_post
    from stereo_match_traditional_tpu_torch.ops import aggregate, post, scanline, volume, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, scanline_cuda
    from stereo_match_traditional_tpu_torch.utils.convert import (
        pair_to_torch, result_to_numpy,
    )
    from stereo_match_traditional_tpu_torch.utils.synthetic import (
        bad_pixel_rate, make_pair,
    )

    # -- 6. the two kernels against their plain versions ------------------
    cost_err = scan_err = 0.0
    flags = [ScanlineConfig(faithful_vertical_l2=l2, faithful_vertical_p2=p2)
             for l2 in (False, True) for p2 in (False, True)]
    for h, w, d, seed in AD_CENSUS_GEOMETRIES + AD_CENSUS_EDGE_GEOMETRIES:
        lt, rt = cuda_pair(h, w, d, seed)
        # one launch, both views: the cost, its two integer parts, the u8
        # images against the same integers as float32 (tables against the
        # direct formula), and the single-view entries (one null output)
        got = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
        want = volume._ad_census_volumes_plain(lt, rt, d)
        ad = ad_census_cuda.ad_volumes_cuda(lt, rt, d)
        cen = ad_census_cuda._launch(lt, rt, d, 9, 7, 1.0, 1.0, "both", "census")
        as_float = ad_census_cuda.ad_census_volumes_cuda(lt.float(), rt.float(), d)
        single = [ad_census_cuda.ad_census_volume_cuda(lt, rt, d, view=v) for v in ("left", "right")]
        torch.cuda.synchronize()
        rec = {"phase": "kernel_check", "kernel": "ad_census_volume_f32", "geometry": [h, w, d]}
        for i, view in enumerate(("left", "right")):
            rec[view] = {
                "ad_exact": torch.equal(ad[i], volume._ad_volume_plain(lt, rt, d, view)),
                "census_exact": torch.equal(cen[i],
                                            volume._census_volume_plain(lt, rt, d, view=view)),
                "u8_equals_float32": torch.equal(got[i], as_float[i]),
                "single_view_equal": torch.equal(got[i], single[i]),
                "max_abs_err": (got[i] - want[i]).abs().max().item(),
                "argmin_agree": (wta.wta(got[i]) == wta.wta(want[i])).float().mean().item()}
        emit(rec)
        for i, view in enumerate(("left", "right")):
            r = rec[view]
            cost_err = max(cost_err, r["max_abs_err"])
            check(got[i].shape == (d, h, w) and r["ad_exact"] and r["census_exact"]
                  and r["u8_equals_float32"] and r["single_view_equal"], rec)
            torch.testing.assert_close(got[i], want[i], rtol=AD_CENSUS_RTOL, atol=AD_CENSUS_ATOL)
            if (h, w, d) == TEDDY:
                check(r["argmin_agree"] >= MIN_ARGMIN_AGREE, rec)
        del got, want, ad, cen, as_float, single
    # a census window other than 9 x 7 takes the kernel's general census
    h, w, d = TEDDY
    lt, rt = cuda_pair(h, w, d, 0)
    for rows, cols in OTHER_WINDOWS:
        cen = ad_census_cuda._launch(lt, rt, d, rows, cols, 1.0, 1.0, "both", "census")
        got = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d, 10.0, 30.0, rows, cols)
        want = volume._ad_census_volumes_plain(lt, rt, d, 10.0, 30.0, rows, cols)
        torch.cuda.synchronize()
        rec = {"phase": "kernel_check", "kernel": "ad_census_volume_f32",
               "geometry": [h, w, d, f"census {rows}x{cols}"],
               "census_exact": [torch.equal(c, volume._census_volume_plain(lt, rt, d, rows, cols,
                                                                           v))
                                for c, v in zip(cen, ("left", "right"))],
               "max_abs_err": max((g - x).abs().max().item() for g, x in zip(got, want))}
        emit(rec)
        check(all(rec["census_exact"]), rec)
        for g, x in zip(got, want):
            torch.testing.assert_close(g, x, rtol=AD_CENSUS_RTOL, atol=AD_CENSUS_ATOL)
        cost_err = max(cost_err, rec["max_abs_err"])
    cost_err = max(cost_err, huge_check())
    for h, w, d, seed in AD_CENSUS_GEOMETRIES:
        lt, rt = cuda_pair(h, w, d, seed)
        vol = volume._ad_census_volume_plain(lt, rt, d)
        for cfg in flags:
            got = scanline_cuda.scanline_optimize_cuda(vol, lt, cfg)
            want = scanline._scanline_optimize_plain(vol, lt, cfg)
            torch.cuda.synchronize()
            rec = {"phase": "kernel_check", "kernel": "scanline_optimize_f32",
                   "geometry": [h, w, d], "faithful_vertical_l2": cfg.faithful_vertical_l2,
                   "faithful_vertical_p2": cfg.faithful_vertical_p2,
                   "bit_exact": torch.equal(got, want),
                   "max_abs_err": (got - want).abs().max().item()}
            emit(rec)
            scan_err = max(scan_err, rec["max_abs_err"])
            check(rec["bit_exact"], rec)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for h, w, d in SCANLINE_EDGE_GEOMETRIES:
        vol = torch.rand((d, h, w), device="cuda", generator=gen) * 3.0
        img = torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
        exact = []
        for cfg in flags:
            got = scanline_cuda.scanline_optimize_cuda(vol, img, cfg)
            want = scanline._scanline_optimize_plain(vol, img, cfg)
            torch.cuda.synchronize()
            exact.append(torch.equal(got, want))
            scan_err = max(scan_err, (got - want).abs().max().item())
        emit({"phase": "kernel_check", "kernel": "scanline_optimize_f32",
              "geometry": [h, w, d], "bit_exact_four_flag_combinations": exact})
        check(all(exact), (h, w, d, exact))

    # -- 7. the FULL slice through its entry point --------------------------
    h, w, d = TEDDY
    L, R, gt = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    fn, cfg_cls = get_pipeline("ad_census")
    full = cfg_cls(disp_range=d, scanline=ScanlineConfig(), run_post=True)  # entry()'s
    ad_census_cuda.LAUNCHES = scanline_cuda.LAUNCHES = 0
    for _ in range(MAIN_PATH_CALLS):
        res = fn(lt, rt, full)
    torch.cuda.synchronize()
    launches = {"ad_census_volume_f32": ad_census_cuda.LAUNCHES,
                "scanline_optimize_f32": scanline_cuda.LAUNCHES}
    check(launches == {"ad_census_volume_f32": MAIN_PATH_CALLS,
                       "scanline_optimize_f32": MAIN_PATH_CALLS}, launches)
    out = result_to_numpy(res)
    plain = result_to_numpy(fn(*pair_to_torch(L, R, "cpu"), full))
    for f in ("disp_left", "disp_right", "disp_final"):
        v = getattr(out, f)
        check(v.shape == (h, w) and np.isfinite(v).all(), f)
        check(v.min() >= 0 and v.max() <= d - 1, (f, "range"))
    bad2 = {f: bad_pixel_rate(getattr(out, f), gt) for f in ("disp_left", "disp_final")}
    agree = {f: float((getattr(out, f) == getattr(plain, f)).mean())
             for f in ("disp_left", "disp_right", "disp_final")}
    # columns x <= W - D: outside the right view's clamp triangle (exact
    # ties there are broken alike only while every sum is exact)
    agree["disp_right_outside_triangle"] = float(
        (out.disp_right[:, : w - d + 1] == plain.disp_right[:, : w - d + 1]).mean())
    emit({"phase": "slice", "pipeline": "ad_census", "config": "FULL (entry())",
          "shape": [h, w], "disp_range": d, "launches": launches, "calls": MAIN_PATH_CALLS,
          "bad2": bad2, "agree_with_cpu_plain_path": agree})
    check(max(bad2.values()) <= MAX_BAD2, bad2)
    check(agree["disp_left"] >= MIN_WTA_AGREE and agree["disp_right_outside_triangle"]
          >= MIN_WTA_AGREE and agree["disp_final"] >= MIN_FINAL_AGREE, agree)

    # -- 8. timing (CUDA events, after warm-up) ----------------------------
    cost_ms = cost_timing()
    emit({"phase": "timing_kernels", "ad_census_volume_f32 (both views)": cost_ms})
    sh, sw, sd = SERVING
    l2, r2 = cuda_pair(sh, sw, sd, 1)
    teddy_cost = cost_ms[f"{h}x{w}/D={d}"]
    vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
    arms_l = aggregate.cross_arms(lt, full.arms)
    arms_r = aggregate.cross_arms(rt, full.arms)
    agg_l = aggregate.rect_mean_aggregate(vol_l, arms_l)
    agg_r = aggregate.rect_mean_aggregate(vol_r, arms_r)
    sk_ms, sp_ms = alternate(lambda: scanline._scanline_optimize_plain(agg_l, lt, full.scanline),
                             lambda: scanline_cuda.scanline_optimize_cuda(agg_l, lt, full.scanline),
                             plain_reps=1, kernel_reps=10)
    emit({"phase": "timing_kernels", "shape": [h, w], "disp_range": d,
          "scanline_optimize_f32": {"kernel_ms": sk_ms, "plain_ms": sp_ms,
                                    "speedup": sp_ms / sk_ms}})

    active = cfg_cls(disp_range=d)
    pipe = {}
    for name, cfg in (("active", active), ("FULL", full)):
        fn(lt, rt, cfg)
        ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 10))
        pipe[name] = {"pipeline_ms": ms, "mpixdisp_per_s": h * w * d / (ms / 1e3) / 1e6}
    opt = scanline_cuda.scanline_optimize_cuda(agg_l, lt, full.scanline)
    dl, dr = wta.wta(opt), wta.wta(agg_r)
    lr = post.lr_check_consistency(dl, dr, full.lr_gate, post.INVALID)
    stages = {
        "cost": lambda: ad_census_cuda.ad_census_volumes_cuda(lt, rt, d),
        "arms": lambda: (aggregate.cross_arms(lt, full.arms), aggregate.cross_arms(rt, full.arms)),
        "rect": lambda: (aggregate.rect_mean_aggregate(vol_l, arms_l),
                         aggregate.rect_mean_aggregate(vol_r, arms_r)),
        "scanline": lambda: scanline_cuda.scanline_optimize_cuda(agg_l, lt, full.scanline),
        "wta": lambda: (wta.wta(opt), wta.wta(agg_r)),
        "post": lambda: ad_census_post(dl, dr, full),
        "post.remove_speckles": lambda: post.remove_speckles(
            lr.disp, full.speckle_diff, full.speckle_area, invalid_value=post.INVALID),
    }
    stage_ms = {k: statistics.median(cuda_ms(f, 10)) for k, f in stages.items()}
    emit({"phase": "timing_pipeline", "pipeline": "ad_census", "shape": [h, w],
          "disp_range": d, **pipe, "stage_ms_FULL": stage_ms})

    full2 = cfg_cls(disp_range=sd, scanline=ScanlineConfig(), run_post=True)
    res2 = fn(l2, r2, full2)
    ms2 = statistics.median(cuda_ms(lambda: fn(l2, r2, full2), 3))
    final2 = res2.disp_final
    check(bool(torch.isfinite(final2).all()) and final2.shape == (sh, sw), "720p disp_final")
    emit({"phase": "timing_pipeline", "pipeline": "ad_census", "config": "FULL",
          "shape": [sh, sw], "disp_range": sd, "pipeline_ms": ms2,
          "mpixdisp_per_s": sh * sw * sd / (ms2 / 1e3) / 1e6})
    vol2 = ad_census_cuda.ad_census_volume_cuda(l2, r2, sd)
    scan2 = statistics.median(cuda_ms(
        lambda: scanline_cuda.scanline_optimize_cuda(vol2, l2, full2.scanline), 5))
    emit({"phase": "timing_kernels", "shape": [sh, sw], "disp_range": sd,
          "scanline_optimize_f32": {"kernel_ms": scan2,
                                    **bound(8 * sd * sh * sw + 4 * sh * sw, 40.0 * sd * sh * sw)}})
    del vol2
    # D above 128 takes the kernel's 8-values-a-lane instance
    wide = torch.rand((WIDE_D, h, w), device="cuda", generator=gen) * 3.0
    scanline_cuda.scanline_optimize_cuda(wide, lt, full.scanline)
    wide_ms = statistics.median(cuda_ms(
        lambda: scanline_cuda.scanline_optimize_cuda(wide, lt, full.scanline), 5))
    emit({"phase": "timing_kernels", "shape": [h, w], "disp_range": WIDE_D,
          "scanline_optimize_f32": {"kernel_ms": wide_ms,
                                    **bound(8 * WIDE_D * h * w + 4 * h * w,
                                            40.0 * WIDE_D * h * w)}})
    del wide
    volume_bytes = 4 * d * h * w
    return {
        # both views at Teddy from one launch: two u8 images in, two volumes
        # out; per value, computed once, ~12 operations (AD, XOR, popcount,
        # two table lookups or exponentials, an add)
        "cost": {"launches": launches["ad_census_volume_f32"],
                 "launches_per_call": launches["ad_census_volume_f32"] / MAIN_PATH_CALLS,
                 "max_abs_err": cost_err, "ms": teddy_cost["kernel_ms"],
                 "plain_ms": teddy_cost["plain_ms"],
                 "bound_ms": teddy_cost["bound_ms"], "bound_by": teddy_cost["bound_by"],
                 "library_ms": None, "ms_covers": "both views, one launch",
                 "back_to_back_ms": teddy_cost["kernel_back_to_back_ms"],
                 "at_720p": cost_ms[f"{sh}x{sw}/D={sd}"]},
        # the volume in and out and the gray image; four directions of ~10
        # operations a value
        "scanline": {"launches": launches["scanline_optimize_f32"],
                     "launches_per_call": launches["scanline_optimize_f32"] / MAIN_PATH_CALLS,
                     "max_abs_err": scan_err, "ms": sk_ms, "plain_ms": sp_ms,
                     **bound(2 * volume_bytes + 4 * h * w, 40.0 * d * h * w),
                     "library_ms": None},
    }


def cost_timing() -> dict:
    """The AD-Census cost kernel's wrapper, both views from one launch, at
    Teddy and at 720p: the cost one call at a time (median, CUDA events)
    against its plain version in turns, and 20 calls back to back; the AD
    part (cblsm's) one call at a time and back to back."""
    import torch

    from stereo_match_traditional_tpu_torch.ops import volume
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda as ac

    out = {}
    for hh, ww, dd, seed in ((*TEDDY, 0), (*SERVING, 1)):
        a, b = cuda_pair(hh, ww, dd, seed)
        rec = {}
        rec["kernel_ms"], rec["plain_ms"] = alternate(
            lambda: volume._ad_census_volumes_plain(a, b, dd),
            lambda: ac.ad_census_volumes_cuda(a, b, dd),
            plain_reps=3 if hh == TEDDY[0] else 2, kernel_reps=10)
        rec["kernel_back_to_back_ms"] = back_to_back_ms(lambda: ac.ad_census_volumes_cuda(a, b, dd))
        ac.ad_volumes_cuda(a, b, dd)
        torch.cuda.synchronize()
        rec["ad_part_ms"] = statistics.median(cuda_ms(lambda: ac.ad_volumes_cuda(a, b, dd), 20))
        rec["ad_part_back_to_back_ms"] = back_to_back_ms(lambda: ac.ad_volumes_cuda(a, b, dd))
        # two u8 images in, two volumes out; per value, computed once, ~12
        # operations (AD, XOR, popcount, two table lookups, an add)
        rec.update(bound(2 * a.numel() + 8 * dd * a.numel(), 12.0 * dd * a.numel()))
        out[f"{hh}x{ww}/D={dd}"] = rec
    return out


def huge_check() -> float:
    """D * H * W above 2^31: the left view of a random u8 pair at ``HUGE``
    (2.12e9 values, 8.5 GB), its row H - 5 against the 9-row band around it.
    A row's census reads four rows up and down, so the band's middle row has
    the same signatures: the AD and Hamming parts equal the plain version's,
    the cost equals the kernel's on the band bit for bit and the plain
    version within ``AD_CENSUS_RTOL``.  Each volume is freed before the next.
    Returns the cost's largest difference from the plain version."""
    import torch

    from stereo_match_traditional_tpu_torch.ops import volume
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda

    h, w, d = HUGE
    gen = torch.Generator(device="cuda").manual_seed(11)
    lt, rt = (torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
              for _ in range(2))
    y = h - 5
    bl, br = lt[y - 4 : y + 5].contiguous(), rt[y - 4 : y + 5].contiguous()
    plain = {"ad": volume._ad_volume_plain, "census": volume._census_volume_plain,
             "cost": volume._ad_census_volume_plain}
    rec = {"phase": "kernel_check", "kernel": "ad_census_volume_f32", "geometry": [h, w, d, "left"],
           "values": d * h * w, "row": y}
    for part, fn in plain.items():
        vol = ad_census_cuda._launch(lt, rt, d, 9, 7, 10.0, 30.0, "left", part)
        row = vol[:, y].clone()
        del vol
        if part == "cost":
            # the left view alone: two u8 images in, one float32 volume out
            rec["ms"] = statistics.median(cuda_ms(lambda: ad_census_cuda._launch(
                lt, rt, d, 9, 7, 10.0, 30.0, "left", "cost"), 3))
            rec.update(bound(2 * h * w + 4 * d * h * w, 0.0))
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        on_band = ad_census_cuda._launch(bl, br, d, 9, 7, 10.0, 30.0, "left", part)[:, 4]
        want = fn(bl, br, d)[:, 4]
        torch.cuda.synchronize()
        rec[part] = {"equals_kernel_on_band": torch.equal(row, on_band),
                     "equals_plain": torch.equal(row, want),
                     "max_abs_err": (row - want).abs().max().item()}
        if part == "cost":
            check(rec[part]["equals_kernel_on_band"], rec)
            torch.testing.assert_close(row, want, rtol=AD_CENSUS_RTOL, atol=AD_CENSUS_ATOL)
        else:
            check(rec[part]["equals_plain"], rec)
    emit(rec)
    torch.cuda.empty_cache()
    return rec["cost"]["max_abs_err"]


def window_phases() -> dict:
    """The sad, ncc and cblsm phases: the window kernel's two entry points
    against their plain versions, the three pipelines through
    ``get_pipeline`` at the reference size, and timings.  Returns each
    entry point's summary fields."""
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import CBLSMConfig, NCCConfig, SADConfig
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.cblsm import cblsm_post
    from stereo_match_traditional_tpu_torch.models.sad import sad_post
    from stereo_match_traditional_tpu_torch.ops import aggregate, post, volume, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, build
    from stereo_match_traditional_tpu_torch.ops.kernels import window_cost_cuda as wc
    from stereo_match_traditional_tpu_torch.utils.convert import (
        pair_to_torch, result_to_numpy,
    )
    from stereo_match_traditional_tpu_torch.utils.synthetic import (
        bad_pixel_rate, make_pair,
    )

    # -- 9. the window kernel against its plain version --------------------
    err = {"sad_volume_f32": 0.0, "ncc_volume_f32": 0.0}
    for h, w, d, win, seed in SAD_GEOMETRIES:
        lt, rt = cuda_pair(h, w, d, seed)
        exact = {}
        for view in ("left", "right"):
            for mean in (False, True):
                got = wc.sad_volume_cuda(lt, rt, d, win, view, mean)
                want = volume._sad_volume_plain(lt, rt, d, win, view, mean)
                torch.cuda.synchronize()
                exact[f"{view}{'_mean' if mean else ''}"] = torch.equal(got, want)
                err["sad_volume_f32"] = max(err["sad_volume_f32"],
                                            (got - want).abs().max().item())
        emit({"phase": "kernel_check", "kernel": "sad_volume_f32",
              "geometry": [h, w, d, win], "bit_exact": exact})
        check(all(exact.values()), exact)
    for h, w, d, win, seed in NCC_GEOMETRIES:
        lt, rt = cuda_pair(h, w, d, seed)
        rec = {"phase": "kernel_check", "kernel": "ncc_volume_f32", "geometry": [h, w, d, win]}
        # the sums kernel alone: bit-exact while every sum is an exact integer
        sums = wc.ncc_sums_cuda(lt, rt, win)
        want_sums = volume._ncc_sums_plain(lt, rt, win)[2]
        rec["window_sums_bit_exact"] = [torch.equal(g, t) for g, t in zip(sums, want_sums)]
        if win <= 15:
            check(all(rec["window_sums_bit_exact"]), rec)
        else:   # sums of squares above 2^24 round along the horizontal walk
            for g, t in zip(sums, want_sums):
                torch.testing.assert_close(g, t, rtol=NCC_WIDE_TOL, atol=0.0)
        for mode in ("ignore", "sentinel"):
            got, interior = volume.ncc_volume(lt, rt, d, win, mode)
            want, want_in = volume._ncc_volume_plain(lt, rt, d, win, mode)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            err["ncc_volume_f32"] = max(err["ncc_volume_f32"], e)
            rec[mode] = {"bit_exact": torch.equal(got, want), "max_abs_err": e,
                         "argmax_agree": (wta.wta(got, "max") == wta.wta(want, "max"))
                         .float().mean().item()}
            check(torch.equal(interior, want_in), (rec, "interior"))
            if win <= 15:
                check(rec[mode]["bit_exact"], rec)
            else:
                torch.testing.assert_close(got, want, rtol=NCC_WIDE_TOL, atol=NCC_WIDE_TOL)
        emit(rec)
    # non-integer inputs: a u8 scene plus uniform noise for SAD, whose terms are
    # of one sign (relative tolerance); a texture uniform over [0, 255) and its
    # shifted, noisy copy for NCC, so that the cross sum's error, FLOAT_RTOL of
    # the sum of its terms' magnitudes, is ~FLOAT_RTOL of sqrt(var_l * var_r) too
    h, w, d, win, seed = FLOAT_GEOMETRY
    gen = torch.Generator(device="cuda").manual_seed(seed)
    lt, rt = (t.float() + torch.rand((h, w), device="cuda", generator=gen)
              for t in cuda_pair(h, w, d, seed))
    rec = {"phase": "kernel_check", "inputs": "non-integer float32", "geometry": [h, w, d, win],
           "rtol": wc.FLOAT_RTOL}
    for view in ("left", "right"):
        got = wc.sad_volume_cuda(lt, rt, d, win, view)
        want = volume._sad_volume_plain(lt, rt, d, win, view)
        rec[f"sad_{view}_max_rel_err"] = ((got - want).abs() / want).max().item()
        torch.testing.assert_close(got, want, rtol=wc.FLOAT_RTOL, atol=0.0)
    lt = torch.rand((h, w), device="cuda", generator=gen) * 255.0
    rt = torch.roll(lt, -3, 1) + torch.rand((h, w), device="cuda", generator=gen) * 8.0
    n = float((2 * win + 1) ** 2)
    for g, t, one_sign in zip(wc.ncc_sums_cuda(lt, rt, win),
                              volume._ncc_sums_plain(lt, rt, win)[2], (False, True, False, True)):
        torch.testing.assert_close(g, t, rtol=wc.FLOAT_RTOL,
                                   atol=0.0 if one_sign else wc.FLOAT_RTOL * n * 128.0)
    got = volume.ncc_volume(lt, rt, d, win)[0]
    want = volume._ncc_volume_plain(lt, rt, d, win)[0]
    rec["ncc_max_abs_err"] = (got - want).abs().max().item()
    emit(rec)
    torch.testing.assert_close(got, want, rtol=0.0, atol=2 * wc.FLOAT_RTOL)

    # -- 10. the three slices through their entry point --------------------
    h, w, d = TEDDY
    L, R, gt = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    lc, rc = pair_to_torch(L, R, "cpu")
    slices = [  # (pipeline, label, config, kernel launches per call)
        ("sad", "active", SADConfig(), {"sad_volume_f32": 1}),
        ("sad", "run_post", SADConfig(run_post=True), {"sad_volume_f32": 2}),
        ("ncc", "D=200 (committed)", NCCConfig(), {"ncc_volume_f32": 1}),
        ("ncc", "D=60", NCCConfig(disp_range=60), {"ncc_volume_f32": 1}),
        ("cblsm", "active", CBLSMConfig(), {"ad_census_volume_f32": 1}),
        ("cblsm", "run_post", CBLSMConfig(run_post=True), {"ad_census_volume_f32": 1}),
    ]
    # the summary's launches: those counted in each kernel's reference slice
    reference = {("sad", "active"): "sad_volume_f32",
                 ("ncc", "D=200 (committed)"): "ncc_volume_f32"}
    counted = {}
    for name, label, cfg, per_call in slices:
        fn, _ = get_pipeline(name)
        for k in wc.LAUNCHES:
            wc.LAUNCHES[k] = 0
        ad_census_cuda.LAUNCHES = 0
        for _ in range(MAIN_PATH_CALLS):
            res = fn(lt, rt, cfg)
        torch.cuda.synchronize()
        launches = {**wc.LAUNCHES, "ad_census_volume_f32": ad_census_cuda.LAUNCHES}
        check(launches == {k: per_call.get(k, 0) * MAIN_PATH_CALLS for k in launches},
              (name, label, launches))
        if (name, label) in reference:
            counted[reference[name, label]] = launches[reference[name, label]]
        out = result_to_numpy(res)
        plain = result_to_numpy(fn(lc, rc, cfg))
        dmax = cfg.max_disparity if name == "sad" else cfg.disp_range
        agree = {}
        for f in ("disp_left", "disp_right", "disp_final"):
            v, p = getattr(out, f), getattr(plain, f)
            if v is None:
                continue
            fin = np.isfinite(v)
            check(v.shape == (h, w) and (fin.all() or f == "disp_final"), (name, f))
            check(v[fin].min() >= 0 and v[fin].max() <= dmax - 1, (name, f, "range"))
            if name == "cblsm" and f == "disp_right":   # outside the clamp triangle
                v, p = v[:, : w - d + 1], p[:, : w - d + 1]
            agree[f] = float((v == p).mean())
            check(agree[f] >= (MIN_FINAL_AGREE if f == "disp_final" else MIN_WTA_AGREE),
                  (name, label, agree))
        bad2 = bad_pixel_rate(out.disp_left, gt)
        emit({"phase": "slice", "pipeline": name, "config": label, "shape": [h, w],
              "disp_range": dmax, "launches": launches, "calls": MAIN_PATH_CALLS,
              "bad2_left": bad2, "agree_with_cpu_plain_path": agree})
        if dmax == d:
            check(bad2 <= MAX_BAD2_WINDOW[name], (name, label, bad2))

    # -- 11. timing (CUDA events, after warm-up) ---------------------------
    versions = {  # (plain, kernel) at the reference windows, 9x9 and 21x21
        "sad_volume_f32": (lambda a, b, dd: volume._sad_volume_plain(a, b, dd, 3),
                           lambda a, b, dd: wc.sad_volume_cuda(a, b, dd, 3)),
        "ncc_volume_f32": (lambda a, b, dd: volume._ncc_volume_plain(a, b, dd, 10),
                           lambda a, b, dd: volume.ncc_volume(a, b, dd, 10)),
    }
    serving = cuda_pair(*SERVING, 1)

    kernel_ms = {}
    for kernel, (a, b), dd in (("sad_volume_f32", (lt, rt), d), ("ncc_volume_f32", (lt, rt), d),
                               ("ncc_volume_f32", (lt, rt), 200),
                               ("sad_volume_f32", serving, SERVING[2]),
                               ("ncc_volume_f32", serving, SERVING[2])):
        plain_fn, kernel_fn = versions[kernel]
        k_ms, p_ms = alternate(lambda: plain_fn(a, b, dd), lambda: kernel_fn(a, b, dd),
                               plain_reps=3, kernel_reps=10)
        # kernel_ms: the wrapper, one call at a time; back_to_back_ms: 20 calls
        # of it enqueued at once (the host's part of a call behind the kernels)
        kernel_ms[kernel, f"{a.shape[0]}x{a.shape[1]}/D={dd}"] = {
            "kernel_ms": k_ms, "back_to_back_ms": back_to_back_ms(lambda: kernel_fn(a, b, dd)),
            "plain_ms": p_ms, "speedup": p_ms / k_ms}
    emit({"phase": "timing_kernels", "kernel_vs_plain_ms":
          {f"{k} @ {s}": v for (k, s), v in kernel_ms.items()}})
    # The sums kernel alone: its C entry into a scratch allocated once (its
    # wrapper's host time, ~30 us a call, is longer than the kernel).
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    sums_ms = {}
    for a, b in ((lt, rt), serving):
        hh, ww = a.shape
        planes = torch.empty((8, hh, ww), device="cuda")

        def sums_entry():
            rc = lib.ncc_window_sums_f32(a.data_ptr(), b.data_ptr(), 1, planes.data_ptr(),
                                         hh, ww, 10, stream)
            check(rc == 0, ("ncc_window_sums_f32", "CUDA error", rc))
        sums_ms[f"{hh}x{ww}"] = back_to_back_ms(sums_entry)
    emit({"phase": "timing_kernels", "ncc_window_sums_f32 (C entry alone, back to back) ms":
          sums_ms})

    pipe_ms = {}
    for name, label, cfg, _ in slices:
        fn, _ = get_pipeline(name)
        fn(lt, rt, cfg)
        ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 10))
        dmax = cfg.max_disparity if name == "sad" else cfg.disp_range
        pipe_ms[f"{name} {label}"] = {"pipeline_ms": ms,
                                      "mpixdisp_per_s": h * w * dmax / (ms / 1e3) / 1e6}
    emit({"phase": "timing_pipeline", "shape": [h, w], "pipelines": pipe_ms})

    sc = SADConfig(run_post=True)
    vol_l = wc.sad_volume_cuda(lt, rt, d, sc.winsize)
    vol_r = wc.sad_volume_cuda(lt, rt, d, sc.winsize, "right")
    dl, dr = wta.optimal_disparity(vol_l), wta.wta(vol_r)
    lr = post.lr_check_simple(dl, dr, sc.lr_gate, post.INVALID)
    spk = post.remove_speckles(lr.disp, sc.speckle_diff, sc.speckle_area,
                               invalid_value=post.INVALID, background=0.0)
    filled = post.fill_holes_8dir(spk, lr.occlusion, lr.mismatch, post.INVALID)
    cb = CBLSMConfig(run_post=True)
    ad_l, ad_r = ad_census_cuda.ad_volumes_cuda(lt, rt, d)
    arms_l, arms_r = aggregate.cross_arms(lt, cb.arms), aggregate.cross_arms(rt, cb.arms)
    agg_l = aggregate.rect_mean_aggregate(ad_l, arms_l)
    agg_r = aggregate.rect_mean_aggregate(ad_r, arms_r)
    both = aggregate.rect_mean_aggregate(torch.cat([agg_l, agg_r]), arms_l)
    cdl, cdr = wta.wta(both[:d]), wta.wta(both[d:])
    clr = post.lr_check_consistency(cdl, cdr, cb.lr_gate, post.INVALID)
    cspk = post.remove_speckles(clr.disp, cb.speckle_diff, cb.speckle_area,
                                invalid_value=post.INVALID)
    ncc_vol = volume.ncc_volume(lt, rt, 200, 10)[0]
    stages = {
        "sad run_post": {
            "cost_left": lambda: wc.sad_volume_cuda(lt, rt, d, sc.winsize),
            "wta_uniqueness": lambda: wta.optimal_disparity(vol_l),
            "cost_right": lambda: wc.sad_volume_cuda(lt, rt, d, sc.winsize, "right"),
            "wta_right": lambda: wta.wta(vol_r),
            "post": lambda: sad_post(dl, dr, sc),
            "post.lr_check_simple": lambda: post.lr_check_simple(dl, dr, sc.lr_gate,
                                                                 post.INVALID),
            "post.remove_speckles": lambda: post.remove_speckles(
                lr.disp, sc.speckle_diff, sc.speckle_area, invalid_value=post.INVALID,
                background=0.0),
            "post.fill_holes_8dir": lambda: post.fill_holes_8dir(
                spk, lr.occlusion, lr.mismatch, post.INVALID),
            "post.median": lambda: post.median_filter(filled, 3, "truncate"),
        },
        "cblsm run_post": {
            "cost": lambda: ad_census_cuda.ad_volumes_cuda(lt, rt, d),
            "arms": lambda: (aggregate.cross_arms(lt, cb.arms), aggregate.cross_arms(rt, cb.arms)),
            "rect_pass1": lambda: (aggregate.rect_mean_aggregate(ad_l, arms_l),
                                   aggregate.rect_mean_aggregate(ad_r, arms_r)),
            "rect_pass2_stacked": lambda: aggregate.rect_mean_aggregate(
                torch.cat([agg_l, agg_r]), arms_l),
            "wta": lambda: (wta.wta(both[:d]), wta.wta(both[d:])),
            "post": lambda: cblsm_post(cdl, cdr, cb),
            "post.lr_check_consistency": lambda: post.lr_check_consistency(
                cdl, cdr, cb.lr_gate, post.INVALID),
            "post.remove_speckles": lambda: post.remove_speckles(
                clr.disp, cb.speckle_diff, cb.speckle_area, invalid_value=post.INVALID),
            "post.median": lambda: post.median_filter(cspk, cb.median_size, "truncate"),
        },
        "ncc D=200": {
            "window_sums (wrapper of the sums kernel)": lambda: wc.ncc_sums_cuda(lt, rt, 10),
            "window_sums (plain: 4 box sums)": lambda: volume._ncc_sums_plain(lt, rt, 10),
            "cost (wrapper, sums included)": lambda: volume.ncc_volume(lt, rt, 200, 10),
            "wta_argmax": lambda: wta.wta(ncc_vol, "max"),
        },
    }
    stage_ms = {}
    for pipeline, fns in stages.items():
        stage_ms[pipeline] = {k: statistics.median(cuda_ms(f, 10)) for k, f in fns.items()}
        emit({"phase": "timing_stages", "pipeline": pipeline, "shape": [h, w],
              "stage_ms": stage_ms[pipeline]})

    # the summary times each entry point at its pipeline's reference config
    # Bounds: two u8 images in and the volume out; a windowed sum needs no
    # more than ~6 (SAD: |a - b| and a running box sum) or ~10 (NCC: a
    # product, a running box sum and the epilogue) operations a value, so
    # both are bound by their bytes.  launches: those counted while the
    # pipeline's reference configuration (sad active, ncc D=200) was driven.
    summary = {}
    for kernel, dd, flop in (("sad_volume_f32", d, 6.0), ("ncc_volume_f32", 200, 10.0)):
        t = kernel_ms[kernel, f"{h}x{w}/D={dd}"]
        summary[kernel] = {"launches": counted[kernel],
                           "launches_per_call": counted[kernel] / MAIN_PATH_CALLS,
                           "max_abs_err": err[kernel],
                           "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
                           **bound(2 * h * w + 4 * dd * h * w, flop * dd * h * w),
                           "library_ms": None}
    # ncc's ms is the wrapper's: the sums kernel, then the volume kernel;
    # window_sums_ms is the sums kernel alone (its C entry, back to back)
    summary["ncc_volume_f32"].update(
        ms_covers="wrapper (sums kernel + volume kernel)",
        window_sums_ms=sums_ms[f"{h}x{w}"])
    return summary


def c_entry_footprint(call) -> dict:
    """What one call of the canonical scanline wrapper takes besides its
    time, measured: the memory it allocates at its peak and, of that, the
    scratch it frees again (the peak less what the call leaves allocated:
    its output), and the kernels one call of its C entry launches, counted
    and timed in a ``torch.profiler`` trace of one call."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    scratch = peak - torch.cuda.memory_allocated()
    del out
    # the wrapper launches nothing of its own on these inputs (float32
    # contiguous costs, u8 images), so every kernel in the trace is the C
    # entry's
    events = traced_events(call, 1)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    names = [re.search(r"\w+_kernel(<[^>]*>)?", e["name"]) for e in kernels]
    check(kernels and all(n and ("canonical" in n[0] or "edge_bits" in n[0]) for n in names),
          ("kernels of one C-entry call", [e["name"] for e in kernels],
           sorted({e.get("cat", "") for e in events})))
    return {"scratch_bytes": scratch, "peak_bytes_of_a_call": peak - base,
            "kernels_in_one_c_entry_call": len(kernels),
            "kernel_ms_in_one_call": [[n[0], e["dur"] / 1e3] for n, e in zip(names, kernels)]}


def busy_share(events, window) -> float:
    """The share of the ``window`` event's span in which the card ran a
    kernel, a copy or a fill (their union, from a ``traced_events`` list)."""
    start, end = window["ts"], window["ts"] + window["dur"]
    spans = sorted((max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in events
                   if e.get("cat") in DEVICE_EVENTS)
    busy, reach = 0.0, start
    for a, b in spans:
        if b > max(a, reach):
            busy += b - max(a, reach)
            reach = b
    return busy / window["dur"]


def surfaces_phase(kind: str) -> None:
    """The serving surfaces on the card at the reference size: every
    pipeline's ``return_stages`` and re-entry from its saved stages
    (``utils.checkpoint``, ``models.registry.finish_from_volumes``), the
    command line as a subprocess, and ``serve_pairs`` over the two
    prefetching pair loaders, ``utils.loader``'s (Python threads) and
    ``utils.native``'s (C++ threads)."""
    import tempfile

    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import (
        ADCensusConfig, ASWConfig, CBLSMConfig, NCCConfig, SADConfig, ScanlineConfig,
    )
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
    from stereo_match_traditional_tpu_torch.models.registry import finish_from_volumes
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, asw_cuda, scanline_canonical_cuda, scanline_cuda, window_cost_cuda,
    )
    from stereo_match_traditional_tpu_torch.utils import checkpoint, loader, native
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.io import read_pfm
    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

    h, w, d = TEDDY
    L, R, gt = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")

    def same(a, b) -> bool:
        return all((x is None and y is None) or (x is not None and y is not None
                                                 and torch.equal(x, y)) for x, y in zip(a, b))

    start = time.perf_counter()

    # -- 15. stages and re-entry, each pipeline's reference configuration --
    configs = {"asw": ASWConfig(), "ad_census": ADCensusConfig(), "sad": SADConfig(),
               "ncc": NCCConfig(), "cblsm": CBLSMConfig(),
               "ad_census FULL": ADCensusConfig(scanline=ScanlineConfig(), run_post=True),
               "ad_census canonical FULL": ADCensusConfig(
                   aggregation="cross_two_pass", scanline=ScanlineConfig(), run_post=True)}
    for label, cfg in configs.items():
        name = label.split()[0]
        fn = get_pipeline(name)[0]
        want = fn(lt, rt, cfg)
        res, stages = fn(lt, rt, cfg, return_stages=True)
        torch.cuda.synchronize()
        dd = getattr(cfg, "disp_range", getattr(cfg, "max_disparity", None))
        layout = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                  for k, v in stages.items()}
        check(list(stages) == SURFACE_STAGES[label], (label, "stage names", list(stages)))
        check(all(v == ([[dd, h, w], "float32"] if k.startswith(("cost", "aggregated"))
                        else [[h, w], "int32"]) for k, v in layout.items()),
              (label, "stage shapes", layout))
        check(same(res, want), (label, "the result with stages differs from the one without"))
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            checkpoint.save_result(tmp, res, meta={"pipeline": name})
            for k, v in stages.items():
                checkpoint.save_array(tmp, k, v)
            save_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            loaded = {k: checkpoint.load_array(tmp, k) for k in stages}
            load_ms = (time.perf_counter() - t0) * 1e3
        vols = [loaded.get("aggregated_left", loaded["cost_left"]),
                loaded.get("aggregated_right", loaded.get("cost_right"))]
        arms = ({k[len("arms_left_"):]: loaded[k] for k in ARMS_LEFT}
                if ARMS_LEFT[0] in loaded else None)
        got = finish_from_volumes(name, *vols, cfg, arms)     # NumPy: to the card
        check(got.disp_left.is_cuda and same(got, want),
              (label, "finish_from_volumes differs from the original run"))
        # timed on volumes already on the card
        vols = [None if v is None else torch.from_numpy(v).cuda() for v in vols]
        arms = None if arms is None else {k: torch.from_numpy(a).cuda() for k, a in arms.items()}
        finish = lambda: finish_from_volumes(name, *vols, cfg, arms)  # noqa: E731
        pipeline = lambda: fn(lt, rt, cfg)  # noqa: E731
        finish()
        emit({"phase": "surfaces", "part": "stages and re-entry", "pipeline": label,
              "shape": [h, w], "disp_range": dd, "stages": layout,
              "result_with_stages_bit_exact": True, "reentry_bit_exact": True,
              "finish_from_volumes_ms": statistics.median(cuda_ms(finish, 3)),
              "pipeline_ms": statistics.median(cuda_ms(pipeline, 3)),
              "save_host_ms": save_ms, "load_host_ms": load_ms,
              "saved_bytes": sum(v.nbytes for v in loaded.values())})
        del want, res, stages, got, loaded, vols, arms
        torch.cuda.empty_cache()

    # -- 16. the command line, as a user runs it ----------------------------
    root = os.path.dirname(os.path.abspath(__file__))
    cli = [sys.executable, "-m", "stereo_match_traditional_tpu_torch.cli"]
    with tempfile.TemporaryDirectory() as tmp:
        pfm = os.path.join(tmp, "d.pfm")
        # both commands at once: each process takes seconds to reach the card
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cli + args, cwd=root, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for args in (["run", "ad_census", "--synthetic", f"{h}x{w}", "--disp-range",
                               str(d), "--save-stages", os.path.join(tmp, "stages"),
                               "--out-pfm", pfm],
                              ["info"])]
        (run_out, run_err), (info_out, info_err) = (p.communicate(timeout=600) for p in procs)
        cli_s = time.perf_counter() - t0
        check(procs[0].returncode == 0, ("cli run", procs[0].returncode, run_err[-2000:]))
        check(procs[1].returncode == 0, ("cli info", procs[1].returncode, info_err[-2000:]))
        summary = json.loads(run_out.strip().splitlines()[-1])
        want = get_pipeline("ad_census")[0](lt, rt, ADCensusConfig(disp_range=d))
        pfm_exact = bool(np.array_equal(read_pfm(pfm), want.disp_left.cpu().numpy()))
        saved = sorted(os.listdir(os.path.join(tmp, "stages")))
    devices = json.loads(info_out)["devices"]
    emit({"phase": "surfaces", "part": "cli", "summary": summary, "pfm_bit_exact": pfm_exact,
          "saved": saved, "info_devices": devices, "seconds_both_commands": cli_s})
    check(summary["device"] == "cuda" and summary["shape"] == [h, w]
          and summary["bad_2.0"] < MAX_BAD2, ("cli run summary", summary))
    check(pfm_exact, "the CLI's PFM differs from the in-process map")
    check(saved == sorted(["manifest.json"] + [f"{k}.npy" for k in
                                               SURFACE_STAGES["ad_census"] + ["disp_left",
                                                                              "disp_right"]]),
          ("cli stages", saved))
    check(devices and devices[0] == kind, ("cli info does not name the card", devices))

    # -- 17. serving over the prefetching pair loaders --------------------
    cfg = ADCensusConfig()
    pairs = [make_pair(h, w, d, seed=s)[:2] for s in range(SERVED_PAIRS)]
    fn = get_pipeline("ad_census")[0]
    single = [fn(*pair_to_torch(a, b, "cuda"), cfg).disp_left.cpu().numpy() for a, b in pairs]
    counters = (ad_census_cuda, asw_cuda, scanline_cuda, scanline_canonical_cuda)
    # the Python loader (utils.loader) and the native one (utils.native: C++ threads)
    loaders = {"PairLoader": loader.PairLoader, "native PairLoader": native.PairLoader}
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for k, (a, b) in enumerate(pairs):
            paths.append((os.path.join(tmp, f"l{k}.pgm"), os.path.join(tmp, f"r{k}.pgm")))
            loader.write_pnm(paths[-1][0], a)
            loader.write_pnm(paths[-1][1], b)

        launches = {}
        for name, make in loaders.items():
            for m in counters:
                m.LAUNCHES = 0
            window_cost_cuda.LAUNCHES = dict.fromkeys(window_cost_cuda.LAUNCHES, 0)
            out = list(serve_pairs("ad_census", make(paths), batch_size=SERVE_BATCH))
            launches[name] = {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in counters}
            launches[name].update(window_cost_cuda.LAUNCHES)
            check(len(out) == SERVED_PAIRS
                  and all(np.array_equal(a, b) for a, b in zip(out, single)),
                  (name, "served maps differ from the single-pair calls"))
            check(launches[name] == {"ad_census_cuda": SERVED_PAIRS, "asw_cuda": 0,
                                     "scanline_cuda": 0, "scanline_canonical_cuda": 0,
                                     "sad_volume_f32": 0, "ncc_volume_f32": 0},
                  (name, "launches while serving", launches[name]))
        emit({"phase": "surfaces", "part": "serving", "pipeline": "ad_census",
              "shape": [h, w], "disp_range": d, "pairs": SERVED_PAIRS,
              "batch_size": SERVE_BATCH, "bit_exact_with_single_calls": list(loaders),
              "launches": launches, "bad2_first_pair": bad_pixel_rate(out[0], gt),
              "native_library": native.library_path().name})

        # -- 18. the served stream, timed: the files cycled ------------------
        cycles = SERVE_STREAM // SERVED_PAIRS
        ways = {f"over {name}": make for name, make in loaders.items()}
        ways["over pairs in memory"] = None
        ms_a_pair = {k: [] for k in ways}
        threads = {}                       # each loader's decode workers, as it reports them
        for k in range(SERVE_WINDOWS):
            for way in (list(ways) if k % 2 == 0 else list(ways)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if ways[way] is None:
                    feed = pairs * cycles
                else:
                    feed = ways[way](paths * cycles)
                    threads[way] = feed.threads
                out = list(serve_pairs("ad_census", feed, batch_size=SERVE_BATCH))
                ms_a_pair[way].append((time.perf_counter() - t0) * 1e3 / SERVE_STREAM)
                check(len(out) == SERVE_STREAM
                      and all(np.array_equal(m, single[i % SERVED_PAIRS])
                              for i, m in enumerate(out)), (way, "served maps differ"))
        # each rotation's loaders against its own in-memory window: the
        # excess a pair over memory, and the share of the Python loader's
        # excess that the native loader does not pay
        rotations = []
        for py, nat, mem in zip(*(ms_a_pair[f"over {n}"] for n in loaders),
                                ms_a_pair["over pairs in memory"]):
            rotations.append({"python_excess_ms": py - mem, "native_excess_ms": nat - mem,
                              "recovered_share": (py - nat) / (py - mem) if py != mem else None})

        # each loader's own time a pair, drained with no card work beside it
        alone = {}
        for name, make in loaders.items():
            t0 = time.perf_counter()
            check(sum(1 for _ in make(paths * cycles)) == SERVE_STREAM, (name, "drained"))
            alone[name] = (time.perf_counter() - t0) * 1e3 / SERVE_STREAM

        traced = {}
        for name, make in loaders.items():
            def window(make=make):
                with torch.profiler.record_function("serve_window"):
                    list(serve_pairs("ad_census", make(paths * (SERVE_TRACED // SERVED_PAIRS)),
                                     batch_size=SERVE_BATCH))

            events = traced_events(window, 1)
            spans = [e for e in events
                     if e.get("name") == "serve_window" and e.get("cat") == "user_annotation"]
            check(len(spans) == 1, (name, "serve_window ranges in the trace", len(spans)))
            busy = busy_share(events, spans[0])
            # the card's busy time a pair, from the trace, against the
            # untraced stream's host time a pair: the profiler slows the host
            busy_ms = busy * spans[0]["dur"] / 1e3 / SERVE_TRACED
            traced[f"over {name}"] = {
                "traced_ms_a_pair": spans[0]["dur"] / 1e3 / SERVE_TRACED,
                "idle_share_of_traced_window": 1.0 - busy,
                "card_busy_ms_a_pair": busy_ms,
                "idle_share_against_untraced_median":
                    1.0 - busy_ms / statistics.median(ms_a_pair[f"over {name}"])}
    emit({"phase": "surfaces", "part": "served stream", "pipeline": "ad_census",
          "shape": [h, w], "disp_range": d, "pairs_a_window": SERVE_STREAM,
          "batch_size": SERVE_BATCH, "windows_of_each": SERVE_WINDOWS,
          "loader_threads": threads, "host_cpu_count": os.cpu_count(),
          "ms_a_pair": {k: {"median": statistics.median(v), "min": min(v), "max": max(v),
                            "windows": v} for k, v in ms_a_pair.items()},
          "rotations": rotations,
          "median_excess_ms": {k: statistics.median(r[k] for r in rotations)
                               for k in ("python_excess_ms", "native_excess_ms")},
          "loader_alone_ms_a_pair": alone, "traced_pairs": SERVE_TRACED, "traced": traced,
          "surfaces_seconds": time.perf_counter() - start})


def canonical_phases() -> dict:
    """The canonical family's phases: the canonical scanline kernel against
    its plain version, ``get_pipeline("ad_census")`` with
    ``aggregation='cross_two_pass'`` active and FULL at the reference size
    and at 720p, ``get_pipeline("cblsm")`` with it at the reference size, and
    timings.  Returns the kernel's summary fields, the cross aggregation's
    and, for the voting's row, the voting launches of the main path's
    canonical FULL call at Teddy."""
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import ADCensusConfig, CBLSMConfig, ScanlineConfig
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import aggregate, scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, aggregate_cuda, post_cuda, scanline_canonical_cuda, scanline_cuda,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import (
        pair_to_torch, result_to_numpy,
    )
    from stereo_match_traditional_tpu_torch.utils.synthetic import (
        bad_pixel_rate, make_pair,
    )

    canonical = scanline_canonical_cuda.scanline_optimize_canonical_cuda

    # -- 12. the canonical scanline kernel against its plain version -------
    max_abs = 0.0
    gen = torch.Generator(device="cuda").manual_seed(12)
    default = (1.0, 3.0, 15.0)
    geometries = ([(g, torch.uint8, default) for g in CANONICAL_GEOMETRIES]
                  + [(g, torch.float32, default) for g in CANONICAL_FLOAT_GEOMETRIES]
                  + [(g, torch.uint8, p) for g in CANONICAL_FLOAT_GEOMETRIES
                     for p in CANONICAL_PARAMETERS])
    for (h, w, d), dtype, (p1, p2, tso) in geometries:
        vol = torch.rand((d, h, w), device="cuda", generator=gen) * 2.0
        if dtype == torch.uint8:
            lt, rt = (torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=dtype)
                      for _ in range(2))
        else:
            lt, rt = (torch.rand((h, w), device="cuda", generator=gen) * 255.0 for _ in range(2))
        rec = {"phase": "kernel_check", "kernel": "scanline_canonical_f32", "geometry": [h, w, d],
               "images": str(dtype).replace("torch.", ""), "p1_p2_tso": [p1, p2, tso]}
        for view in ("left", "right"):
            got = canonical(vol, lt, rt, p1, p2, tso, view)
            want = scanline._scanline_optimize_canonical_plain(vol, lt, rt, p1, p2, tso, view)
            torch.cuda.synchronize()
            rec[view] = {"bit_exact": torch.equal(got, want),
                         "max_abs_err": (got - want).abs().max().item()}
            max_abs = max(max_abs, rec[view]["max_abs_err"])
        emit(rec)
        check(rec["left"]["bit_exact"] and rec["right"]["bit_exact"], rec)

    # -- 13. the canonical family through its entry points -----------------
    h, w, d = TEDDY
    fn = get_pipeline("ad_census")[0]
    full_scan = ScanlineConfig()
    # (pipeline, label, config, shape, launches per call: cost, canonical,
    # scanline.cu); each call also launches a cross support and num_iters
    # cross iterations a view
    runs = [
        ("ad_census", "canonical active", ADCensusConfig(
            disp_range=d, aggregation="cross_two_pass"), TEDDY, (1, 0, 0)),
        ("ad_census", "canonical FULL", ADCensusConfig(
            disp_range=d, aggregation="cross_two_pass", scanline=full_scan, run_post=True),
         TEDDY, (1, 2, 0)),
        ("cblsm", "cross_two_pass", CBLSMConfig(disp_range=d, aggregation="cross_two_pass"),
         TEDDY, (1, 0, 0)),
        ("ad_census", "canonical active", ADCensusConfig(
            disp_range=SERVING[2], aggregation="cross_two_pass"), SERVING, (1, 0, 0)),
        ("ad_census", "canonical FULL", ADCensusConfig(
            disp_range=SERVING[2], aggregation="cross_two_pass", scanline=full_scan,
            run_post=True), SERVING, (1, 2, 0)),
    ]
    counted = None
    pipe_ms = {}
    for name, label, cfg, (hh, ww, dd), per_call in runs:
        L, R, gt = make_pair(hh, ww, dd, seed=0)
        lt, rt = pair_to_torch(L, R, "cuda")
        pfn = get_pipeline(name)[0]
        ad_census_cuda.LAUNCHES = scanline_canonical_cuda.LAUNCHES = scanline_cuda.LAUNCHES = 0
        aggregate_cuda.LAUNCHES.update(dict.fromkeys(aggregate_cuda.LAUNCHES, 0))
        post_cuda.LAUNCHES["region_voting_f32"] = 0
        res = pfn(lt, rt, cfg)
        torch.cuda.synchronize()
        launches = {"ad_census_volume_f32": ad_census_cuda.LAUNCHES,
                    "scanline_canonical_f32": scanline_canonical_cuda.LAUNCHES,
                    "scanline_optimize_f32": scanline_cuda.LAUNCHES,
                    "cross_support_f32": aggregate_cuda.LAUNCHES["cross_support_f32"],
                    "cross_aggregate_f32": aggregate_cuda.LAUNCHES["cross_aggregate_f32"]}
        check(tuple(launches.values()) == (*per_call, 2, 2 * cfg.cross_params.num_iters),
              (name, label, launches))
        # the canonical post votes by one launch; cblsm does not vote
        launches["region_voting_f32"] = post_cuda.LAUNCHES["region_voting_f32"]
        check(launches["region_voting_f32"] == int(name == "ad_census" and cfg.run_post),
              (name, label, launches))
        if (name, label, hh) == ("ad_census", "canonical FULL", h):
            counted = launches
        out = result_to_numpy(res)
        rec = {"phase": "slice", "pipeline": name, "config": label, "shape": [hh, ww],
               "disp_range": dd, "launches": launches}
        for f in ("disp_left", "disp_right"):
            v = getattr(out, f)
            check(v.shape == (hh, ww) and np.isfinite(v).all() and v.min() >= 0
                  and v.max() <= dd - 1, (name, label, f))
        final = out.disp_final if cfg.run_post else out.disp_left
        rec["bad2"] = bad_pixel_rate(final, gt)
        key = (label.split()[-1], (hh, ww, dd))
        if name == "ad_census":
            rec["bad2_of_the_jax_package"] = CANONICAL_BAD2[key]
        if (hh, ww, dd) == TEDDY:
            # the port's CPU plain path on the same pair
            plain = result_to_numpy(pfn(*pair_to_torch(L, R, "cpu"), cfg))
            agree = {}
            for f in ("disp_left", "disp_right", "disp_final"):
                v, p = getattr(out, f), getattr(plain, f)
                if v is not None:
                    agree[f] = float((v == p).mean())
            rec["agree_with_cpu_plain_path"] = agree
        emit(rec)
        if (hh, ww, dd) == TEDDY:
            check(min(v for f, v in agree.items() if f != "disp_final") >= MIN_WTA_AGREE
                  and agree.get("disp_final", 1.0) >= MIN_FINAL_AGREE, rec)
            if name == "ad_census":
                check(abs(rec["bad2"] - CANONICAL_BAD2[key]) <= CANONICAL_BAD2_TOL, rec)
            else:
                check(rec["bad2"] <= MAX_BAD2_WINDOW["cblsm"], rec)
        pfn(lt, rt, cfg)
        reps = 5 if hh == h else 2
        pipe_ms[f"{name} {label} @ {hh}x{ww}/D={dd}"] = statistics.median(
            cuda_ms(lambda: pfn(lt, rt, cfg), reps))
        del res, out
    emit({"phase": "timing_pipeline", "pipelines_ms": pipe_ms})

    # -- 14. stages (the pipeline's stage_scope ranges) and the kernel ------
    kernel = {}
    for hh, ww, dd in (TEDDY, SERVING):
        L, R, _ = make_pair(hh, ww, dd, seed=0)
        lt, rt = pair_to_torch(L, R, "cuda")
        cfg = ADCensusConfig(disp_range=dd, aggregation="cross_two_pass", scanline=full_scan,
                             run_post=True)
        emit({"phase": "timing_stages", "pipeline": "ad_census canonical FULL",
              "shape": [hh, ww], "disp_range": dd,
              "stage_ms": profiled_stages(lambda: fn(lt, rt, cfg), 3 if hh == h else 2)})
        # the kernel on the volumes the main path gives it: bit for bit with
        # its plain version, both views, then timed one view at a time
        # (median) and back to back
        cp = cfg.cross_params
        vols = ad_census_cuda.ad_census_volumes_cuda(lt, rt, dd)
        aggs = [aggregate.cross_aggregate(v, aggregate.canonical_cross_arms(img, cp),
                                          cp.num_iters, span_cap=cp.cross_l1)
                for v, img in zip(vols, (lt, rt))]
        del vols
        rec = {}
        for view, agg in zip(("left", "right"), aggs):
            got = canonical(agg, lt, rt, cp.so_p1, cp.so_p2, cp.so_tso, view)
            want = scanline._scanline_optimize_canonical_plain(agg, lt, rt, cp.so_p1, cp.so_p2,
                                                        cp.so_tso, view)
            torch.cuda.synchronize()
            rec[f"bit_exact_{view}"] = torch.equal(got, want)
            max_abs = max(max_abs, (got - want).abs().max().item())
            del got, want
        check(rec["bit_exact_left"] and rec["bit_exact_right"],
              ("scanline_canonical_f32 on the aggregated volumes", hh, ww, dd, rec))
        agg_l = aggs[0]
        one = lambda: canonical(agg_l, lt, rt, cp.so_p1, cp.so_p2, cp.so_tso, "left")  # noqa: E731
        rec.update(kernel_ms=statistics.median(cuda_ms(one, 10 if hh == h else 5)),
                   back_to_back_ms=back_to_back_ms(one, 20 if hh == h else 5),
                   **c_entry_footprint(one))
        if (hh, ww, dd) == TEDDY:
            rec["plain_ms"] = statistics.median(cuda_ms(
                lambda: scanline._scanline_optimize_canonical_plain(
                    agg_l, lt, rt, cp.so_p1, cp.so_p2, cp.so_tso, "left"), 2))
        # the volume in and out once and the two u8 images; ~15 operations a
        # value and direction
        rec.update(bound(8 * dd * hh * ww + 2 * hh * ww, 60.0 * dd * hh * ww))
        rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
        rec["share_of_bound_back_to_back"] = rec["bound_ms"] / rec["back_to_back_ms"]
        kernel[f"{hh}x{ww}/D={dd}"] = rec
        del aggs, agg_l
        torch.cuda.empty_cache()
    emit({"phase": "timing_kernels", "scanline_canonical_f32 (one view)": kernel})

    # -- 14b. the cross aggregation kernel on the main path's inputs (left
    # view, canonical arms, the pipelines' cap): the first iteration bit for
    # bit with its plain version, four within an ulp; one view's four
    # iterations timed (median and back to back) beside the plain version
    cp = ADCensusConfig().cross_params
    cross = {}
    for hh, ww, dd in (TEDDY, KITTI, SERVING):
        L, R, _ = make_pair(hh, ww, dd, seed=0)
        lt, rt = pair_to_torch(L, R, "cuda")
        vol = ad_census_cuda.ad_census_volumes_cuda(lt, rt, dd)[0]
        arms = aggregate.canonical_cross_arms(lt, cp)
        one = lambda: aggregate.cross_aggregate(  # noqa: E731
            vol, arms, cp.num_iters, span_cap=cp.cross_l1)
        plain = lambda: aggregate._cross_aggregate_plain(vol, arms, cp.num_iters)  # noqa: E731
        aggregate_cuda.arms_over_cap("cuda", reset=True)
        before = dict(aggregate_cuda.LAUNCHES)
        got = one()
        torch.cuda.synchronize()
        launched = {k: aggregate_cuda.LAUNCHES[k] - before[k] for k in before
                    if aggregate_cuda.LAUNCHES[k] != before[k]}
        want = plain()
        diff = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
        far = (diff > CROSS_ULPS) & ((got - want).abs() > CROSS_ATOL)
        rec = {"launches": launched, "values_off": int((diff > 0).sum()),
               "max_ulps": int(diff.max()), "values_beyond_tolerance": int(far.sum()),
               "first_iteration_bit_exact": torch.equal(
                   aggregate.cross_aggregate(vol, arms, 1, span_cap=cp.cross_l1),
                   aggregate._cross_aggregate_plain(vol, arms, 1)),
               "arms_over_cap": aggregate_cuda.arms_over_cap("cuda", reset=True)}
        check(rec["first_iteration_bit_exact"] and rec["values_beyond_tolerance"] == 0
              and rec["arms_over_cap"] == 0
              and launched == {"cross_support_f32": 1, "cross_aggregate_f32": cp.num_iters},
              ("cross_aggregate_f32", hh, ww, dd, rec))
        del got, want, diff, far
        kernel_ms, plain_ms = alternate(plain, one, 2, 5)
        rec.update(kernel_ms=kernel_ms, plain_ms=plain_ms,
                   back_to_back_ms=back_to_back_ms(one, 20 if hh == h else 10))
        # the volume in and out once, the four int32 arms in
        rec.update(bound(8 * dd * hh * ww + 16 * hh * ww, 0.0))
        rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
        rec["share_of_bound_back_to_back"] = rec["bound_ms"] / rec["back_to_back_ms"]
        cross[f"{hh}x{ww}/D={dd}"] = rec
        del vol, arms
        torch.cuda.empty_cache()
    emit({"phase": "timing_kernels", "cross_aggregate_f32 (one view, four iterations)": cross})
    teddy = kernel[f"{h}x{w}/D={d}"]
    cross_teddy = cross[f"{h}x{w}/D={d}"]
    return {"launches": counted["scanline_canonical_f32"],
            "launches_per_call": counted["scanline_canonical_f32"], "max_abs_err": max_abs,
            "ms": teddy["kernel_ms"], "plain_ms": teddy["plain_ms"],
            "bound_ms": teddy["bound_ms"], "bound_by": teddy["bound_by"], "library_ms": None,
            "ms_covers": "one view (one C-entry call)",
            "back_to_back_ms": teddy["back_to_back_ms"],
            "at_720p": kernel[f"{SERVING[0]}x{SERVING[1]}/D={SERVING[2]}"],
            "cross_aggregate_f32": {  # launches: canonical FULL at Teddy, one call
                "launches": counted["cross_aggregate_f32"],
                "launches_per_call": counted["cross_aggregate_f32"],
                "support_launches_per_call": counted["cross_support_f32"],
                "max_ulps": max(r["max_ulps"] for r in cross.values()),
                "tolerance": {"ulps": CROSS_ULPS, "or_abs": CROSS_ATOL},
                "ms": cross_teddy["kernel_ms"], "plain_ms": cross_teddy["plain_ms"],
                "bound_ms": cross_teddy["bound_ms"], "bound_by": cross_teddy["bound_by"],
                "library_ms": None, "ms_covers": "one view (a support and four iterations)",
                "back_to_back_ms": cross_teddy["back_to_back_ms"],
                "at_kitti": cross[f"{KITTI[0]}x{KITTI[1]}/D={KITTI[2]}"],
                "at_720p": cross[f"{SERVING[0]}x{SERVING[1]}/D={SERVING[2]}"]},
            "region_voting_f32": {  # launches: canonical FULL at Teddy, one call
                "launches": counted["region_voting_f32"],
                "launches_per_call": counted["region_voting_f32"]}}


def variants_phase() -> dict:
    """The dormant variants (ROADMAP.md Queue 1 item 7): the SAD kernel's
    colour mode against its plain version and timed, then every variant
    configuration on the card at Teddy, its ms, its agreement with the port's
    CPU plain path, its bad-2.0 and its kernel launches.  Returns the colour
    mode's summary fields."""
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import (
        ADCensusConfig, ASWConfig, CBLSMConfig, NCCConfig, ScanlineConfig,
    )
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import filters, post, volume
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, scanline_cuda
    from stereo_match_traditional_tpu_torch.ops.kernels import window_cost_cuda as wc
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.io import rgb_to_lab_u8
    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

    import dataclasses

    start = time.perf_counter()

    def colour_pair(h, w, d, seed, device="cuda"):
        if min(h, w) < 8:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return tuple(torch.randint(0, 256, (h, w, 3), device="cuda", generator=gen,
                                       dtype=torch.uint8) for _ in range(2))
        L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed, color=True)
        return torch.from_numpy(L).to(device), torch.from_numpy(R).to(device)

    # -- 19. the SAD kernel's colour mode against its plain version ---------
    exact_all = True
    for h, w, d, r in COLOUR_SAD_GEOMETRIES:
        lt, rt = colour_pair(h, w, d, 1)
        exact = {}
        for dtype in ("u8", "float32"):
            a, b = (lt, rt) if dtype == "u8" else (lt.float(), rt.float())
            for view in ("left", "right"):
                for mean in (False, True):
                    got = wc.sad_volume_cuda(a, b, d, r - 1, view, mean, True)
                    want = volume._sad_volume_plain(a, b, d, r - 1, view, mean, True)
                    torch.cuda.synchronize()
                    exact[f"{dtype} {view}{' mean' if mean else ''}"] = torch.equal(got, want)
                    del got, want
        exact_all &= all(exact.values())
        emit({"phase": "variants", "part": "kernel_check", "kernel": "sad_volume_f32 (channel_min)",
              "geometry": [h, w, d, r], "bit_exact": exact})
        check(all(exact.values()), (h, w, d, r, exact))
        torch.cuda.empty_cache()
    # non-integer float32 pixels: a sliding sum rounds, within FLOAT_RTOL of
    # the largest window sum its walk passed (window_cost_cuda's docstring)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lt, rt = (t.float() + torch.rand(t.shape, device="cuda", generator=gen)
              for t in colour_pair(40, 70, 100, 3))
    got = wc.sad_volume_cuda(lt, rt, 100, 4, "left", False, True)
    want = volume._sad_volume_plain(lt, rt, 100, 4, "left", False, True)
    float_err = (got - want).abs().max().item()
    emit({"phase": "variants", "part": "kernel_check", "kernel": "sad_volume_f32 (channel_min)",
          "inputs": "non-integer float32", "geometry": [40, 70, 100, 5], "max_abs_err": float_err,
          "atol": wc.FLOAT_RTOL * want.max().item()})
    check(float_err <= wc.FLOAT_RTOL * want.max().item(), ("float colour", float_err))

    # timing: the colour mode at CBLSM's window (radius 2), u8, left view
    timing = {}
    for h, w, d in (TEDDY, SERVING):
        lt, rt = colour_pair(h, w, d, 0)
        k_ms, p_ms = alternate(lambda: volume._sad_volume_plain(lt, rt, d, 1, "left", True, True),
                               lambda: wc.sad_volume_cuda(lt, rt, d, 1, "left", True, True),
                               plain_reps=3, kernel_reps=10)
        # two u8 colour images in and the volume out; a term is three
        # differences and two minima, then a running box sum: bytes bound it
        timing[f"{h}x{w}/D={d}"] = {
            "ms": k_ms, "plain_ms": p_ms,
            "back_to_back_ms": back_to_back_ms(
                lambda: wc.sad_volume_cuda(lt, rt, d, 1, "left", True, True)),
            **bound(2 * 3 * h * w + 4 * d * h * w, 10.0 * d * h * w)}
        timing[f"{h}x{w}/D={d}"]["share_of_bound"] = (timing[f"{h}x{w}/D={d}"]["bound_ms"]
                                                      / k_ms)
        torch.cuda.empty_cache()
    emit({"phase": "variants", "part": "timing_kernels",
          "sad_volume_f32 (channel_min, radius 2, u8)": timing})

    # -- 20. every variant configuration on the card at Teddy ----------------
    h, w, d = TEDDY
    L, R, gt = make_pair(h, w, d, seed=0)
    Lc, Rc, gtc = make_pair(h, w, d, seed=0, color=True)
    cuda_grey, cpu_grey = pair_to_torch(L, R, "cuda"), pair_to_torch(L, R, "cpu")
    colour = {dev: (torch.from_numpy(Lc).to(dev), torch.from_numpy(Rc).to(dev))
              for dev in ("cuda", "cpu")}

    def counts():
        return {**wc.LAUNCHES, "ad_census_volume_f32": ad_census_cuda.LAUNCHES,
                "scanline_optimize_f32": scanline_cuda.LAUNCHES}

    def zero_counts():
        for k in wc.LAUNCHES:
            wc.LAUNCHES[k] = 0
        ad_census_cuda.LAUNCHES = scanline_cuda.LAUNCHES = 0

    def timed(fn, reps=VARIANT_REPS):
        fn()
        torch.cuda.synchronize()
        return statistics.median(cuda_ms(fn, reps))

    def agreement(a, b, fields):
        out = {}
        for f in fields:
            x, y = getattr(a, f), getattr(b, f)
            if x is not None:
                out[f] = float((x.cpu() == y).float().mean())
        return out

    def lab_inputs(hh, ww, dd, dev):
        lc, rc, _ = make_pair(hh, ww, dd, seed=0, color=True)
        return {"left_lab": torch.from_numpy(rgb_to_lab_u8(lc)).to(dev),
                "right_lab": torch.from_numpy(rgb_to_lab_u8(rc)).to(dev)}

    # (label, pipeline, config, pair kind, launches a call).  bad-2.0 is held
    # to a reference only for the grid, the one variant whose accuracy the
    # JAX package recorded (BASELINE.md:435); the others' is reported.
    configs = [
        ("ncc shifted", "ncc", NCCConfig(variant="shifted"), "grey", {}),
        ("asw lab", "asw", ASWConfig(variant="lab"), "lab", {}),
        ("asw lab faithful_lut", "asw", ASWConfig(variant="lab", lab_faithful_lut=True), "lab",
         {}),
        ("asw grid bins=12", "asw", ASWConfig(approx="grid", approx_bins=12), "grey", {}),
        ("cblsm sad_mean", "cblsm", CBLSMConfig(cost="sad_mean", run_post=True), "grey",
         {"sad_volume_f32": 2}),
        ("cblsm sad_mean_v4", "cblsm", CBLSMConfig(cost="sad_mean_v4", run_post=True), "colour",
         {"sad_volume_f32": 2}),
        ("cblsm local_mean", "cblsm", CBLSMConfig(cost="local_mean", run_post=True), "grey", {}),
        ("cblsm rect_mean_v4", "cblsm", CBLSMConfig(aggregation="rect_mean_v4", run_post=True),
         "grey", {"ad_census_volume_f32": 1}),
    ]
    summary = {}
    for label, name, cfg, kind, per_call in configs:
        fn, _ = get_pipeline(name)
        pair = colour["cuda"] if kind == "colour" else cuda_grey
        kw = lab_inputs(h, w, d, "cuda") if kind == "lab" else {}
        zero_counts()
        res = fn(*pair, cfg, **kw)
        torch.cuda.synchronize()
        launches = counts()
        check(launches == {k: per_call.get(k, 0) for k in launches}, (label, launches))
        for f in ("disp_left", "disp_final"):
            v = getattr(res, f)
            if v is not None:
                check(v.shape == (h, w), (label, f))
                fin = torch.isfinite(v)
                check(bool(fin.all()) or f == "disp_final", (label, f, "finite"))
                check(float(v[fin].min()) >= 0, (label, f, "range"))
        rec = {"phase": "variants", "part": "configuration", "config": label, "shape": [h, w],
               "launches_a_call": launches}
        if kind == "lab":
            # the plain path walks 625 offsets: the card and the CPU meet at a
            # smaller shape, and Teddy is timed on the card alone
            hh, ww, dd = WALK_SHAPE
            sl, sr, _ = make_pair(hh, ww, dd, seed=0)
            small = dataclasses.replace(cfg, disp_range=dd)
            card = fn(*pair_to_torch(sl, sr, "cuda"), small, **lab_inputs(hh, ww, dd, "cuda"))
            cpu = fn(*pair_to_torch(sl, sr, "cpu"), small, **lab_inputs(hh, ww, dd, "cpu"))
            rec["agree_with_cpu_plain_path"] = agreement(card, cpu, ("disp_left", "disp_final"))
            rec["agree_at"] = [hh, ww, dd]
            reps = 2
        else:
            cpu_pair = colour["cpu"] if kind == "colour" else cpu_grey
            cpu = fn(*cpu_pair, cfg)
            rec["agree_with_cpu_plain_path"] = agreement(res, cpu, ("disp_left", "disp_final"))
            reps = VARIANT_REPS
        rec["ms"] = timed(lambda: fn(*pair, cfg, **kw), reps)
        if name != "ncc":   # the shifted NCC's output is a display-scaled depth
            rec["bad2_left"] = bad_pixel_rate(res.disp_left.cpu().numpy(),
                                              gtc if kind == "colour" else gt)
        emit(rec)
        agree = rec["agree_with_cpu_plain_path"]
        check(agree["disp_left"] >= MIN_FINAL_AGREE, (label, agree))
        check(agree.get("disp_final", 1.0) >= MIN_FINAL_AGREE, (label, agree))
        if label == "asw grid bins=12":
            check(abs(rec["bad2_left"] - GRID_BAD2) <= GRID_BAD2_TOL, (label, rec["bad2_left"]))
        summary[label] = rec
        torch.cuda.empty_cache()

    # the speckle filter's block form on ad_census FULL's LR map
    full = ADCensusConfig(disp_range=d, scanline=ScanlineConfig(), run_post=True)
    res = get_pipeline("ad_census")[0](*cuda_grey, full)
    lr = post.lr_check_consistency(res.disp_left, res.disp_right, full.lr_gate, post.INVALID)
    blocks = {}
    for block in (None, 32):
        zero_counts()
        out = post.remove_speckles(lr.disp, full.speckle_diff, full.speckle_area,
                                   invalid_value=post.INVALID, block=block)
        blocks[block] = (out, timed(lambda: post.remove_speckles(
            lr.disp, full.speckle_diff, full.speckle_area, invalid_value=post.INVALID,
            block=block)))
    cpu_out = post.remove_speckles(lr.disp.cpu(), full.speckle_diff, full.speckle_area,
                                   invalid_value=post.INVALID, block=32)
    speckle = {"phase": "variants", "part": "configuration",
               "config": "remove_speckles(block=32) on ad_census FULL's LR map",
               "equal_to_block_none": torch.equal(blocks[32][0], blocks[None][0]),
               "agree_with_cpu_plain_path": float((blocks[32][0].cpu() == cpu_out).float().mean()),
               "ms": blocks[32][1], "ms_block_none": blocks[None][1], "launches_a_call": counts()}
    emit(speckle)
    check(speckle["equal_to_block_none"] and speckle["agree_with_cpu_plain_path"] == 1.0, speckle)

    # the bilateral filter (its reference radius 12: 625 offsets) on the
    # left images, grey and colour; the card against the CPU at WALK_SHAPE
    hh, ww, dd = WALK_SHAPE
    sg, _, _ = make_pair(hh, ww, dd, seed=0)
    sc, _, _ = make_pair(hh, ww, dd, seed=0, color=True)
    for label, full_img, small in (("grey", cuda_grey[0], sg), ("colour", colour["cuda"][0], sc)):
        zero_counts()
        got = filters.bilateral_filter(torch.from_numpy(small).cuda()).cpu()
        want = filters.bilateral_filter(torch.from_numpy(small))
        rec = {"phase": "variants", "part": "configuration", "config": f"bilateral_filter {label}",
               "shape": list(full_img.shape),
               "ms": timed(lambda: filters.bilateral_filter(full_img), 2),
               "max_rel_err_vs_cpu": ((got - want).abs() / want.abs().clamp(min=1.0)).max().item(),
               "agree_at": list(small.shape), "launches_a_call": counts()}
        emit(rec)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)
        summary[f"bilateral_filter {label}"] = rec
    emit({"phase": "variants", "part": "done", "seconds": time.perf_counter() - start})

    teddy = timing[f"{h}x{w}/D={d}"]
    return {"channel_min": {
        "ms": teddy["ms"], "back_to_back_ms": teddy["back_to_back_ms"],
        "plain_ms": teddy["plain_ms"], "bound_ms": teddy["bound_ms"],
        "bound_by": teddy["bound_by"], "shape": f"{h}x{w}/D={d}, radius 2, u8",
        "launches": summary["cblsm sad_mean_v4"]["launches_a_call"]["sad_volume_f32"],
        "agreement": "bit-exact" if exact_all else "differs",
        "float_max_abs_err": float_err}}


def strided_pair(fn, cost, pen_lr, pen_rl, a, b):
    """lr and rl of a [D, t, W] band by two launches of the strided banded
    kernel ``fn`` (``directional_pass_banded_cuda`` with ``a, b = p1,
    l2_uses_dm1``, or ``canonical_pass_banded_cuda`` with ``p1, p2``) on
    the band's [W, D, t] view from a zero carry: the streamed executor's
    horizontal step before its band entries.  ``pen_lr`` / ``pen_rl``: the
    penalties of each direction's steps, [W, t] or [W, D, t]."""
    import torch

    d, t, _ = cost.shape
    ch = cost.permute(2, 0, 1)
    z = (torch.zeros((d, t), device=cost.device), torch.zeros((t,), device=cost.device))
    lr, _ = fn(ch, pen_lr, z, None, a, b)
    rl, _ = fn(ch, pen_rl, z, None, a, b, reverse=True)
    return lr.permute(1, 2, 0), rl.permute(1, 2, 0)


@contextlib.contextmanager
def strided_horizontal_passes():
    """The row executors with their horizontal passes as the streamed one
    ran them before the band entries: the band entries' launchers replaced
    by the strided banded kernels on each band's [W, D, t] view
    (``strided_pair``)."""
    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    def legacy(cost, grey, p1, p2_init):
        return strided_pair(banded.directional_pass_banded_cuda, cost,
                            *scanline.horizontal_p2(grey, p1, p2_init), p1, True)

    def canonical(cost, base, match, p1, p2, tso, right_view):
        s = scanline.horizontal_scales(cost.shape[0], base, match, tso, right_view)
        return strided_pair(banded.canonical_pass_banded_cuda, cost, s[:-1], s[1:], p1, p2)

    saved = (banded.horizontal_passes_banded_cuda, banded.canonical_horizontal_passes_banded_cuda)
    banded.horizontal_passes_banded_cuda = legacy
    banded.canonical_horizontal_passes_banded_cuda = canonical
    try:
        yield
    finally:
        (banded.horizontal_passes_banded_cuda,
         banded.canonical_horizontal_passes_banded_cuda) = saved


@contextlib.contextmanager
def wide_kernel_passes():
    """Every banded pass on the wide kernel (the strided banded design
    generalised to any D), the vertical ones too: ``pass_entry`` always
    picks it."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    saved = banded.pass_entry
    banded.pass_entry = lambda canonical, *a, **k: banded.WIDE[canonical]
    try:
        yield
    finally:
        banded.pass_entry = saved


def equal_to_strided(part, label, shape, call, got, phase="streamed"):
    """Check that ``got``, the maps of ``call()``, equal bit for bit those
    of the same call with the strided horizontal passes (streamed) and
    every banded pass on the wide kernel, the vertical ones on the walker /
    mover kernel's place."""
    import torch

    with strided_horizontal_passes(), wide_kernel_passes():
        want = call()
    torch.cuda.synchronize()
    equal = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
             for f in ("disp_left", "disp_right", "disp_final")}
    rec = {"phase": phase, "part": part, "config": label, "shape": shape,
           "equal_to_strided_and_wide_passes": equal}
    emit(rec)
    check(all(equal.values()), rec)


def _reset_launches():
    """Every kernel wrapper's launch count set to 0."""
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, aggregate_cuda, asw_cuda, post_cuda, scanline_banded_cuda,
        scanline_canonical_cuda, scanline_cuda, window_cost_cuda,
    )

    ad_census_cuda.LAUNCHES = asw_cuda.LAUNCHES = 0
    scanline_cuda.LAUNCHES = scanline_canonical_cuda.LAUNCHES = 0
    for counts in (window_cost_cuda.LAUNCHES, scanline_banded_cuda.LAUNCHES,
                   aggregate_cuda.LAUNCHES, post_cuda.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _launches() -> dict:
    """Every kernel wrapper's launch count, by C entry."""
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, aggregate_cuda, asw_cuda, post_cuda, scanline_banded_cuda,
        scanline_canonical_cuda, scanline_cuda, window_cost_cuda,
    )

    return {"asw_volume_left_f32": asw_cuda.LAUNCHES,
            "ad_census_volume_f32": ad_census_cuda.LAUNCHES,
            "scanline_optimize_f32": scanline_cuda.LAUNCHES,
            "scanline_canonical_f32": scanline_canonical_cuda.LAUNCHES,
            **window_cost_cuda.LAUNCHES, **scanline_banded_cuda.LAUNCHES,
            **aggregate_cuda.LAUNCHES, **post_cuda.LAUNCHES}


def _agreement(got, want, d: int) -> dict:
    """Share of equal pixels of each map, outside the clamp triangle (the
    left D columns; the right D of the right view)."""
    out = {}
    for f in ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch"):
        g, w = getattr(got, f), getattr(want, f)
        check((g is None) == (w is None), f)
        if g is not None:
            sl = (slice(None), slice(None, -d)) if f == "disp_right" else (slice(None),
                                                                            slice(d, None))
            out[f] = (g[sl] == w[sl]).double().mean().item()
    return out


def _peak_run(fn):
    """``fn()``'s result and the device memory it peaked at above what was
    allocated before it (bytes), and the caching allocator's peak reserve
    (bytes, all of the process's)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - base, torch.cuda.max_memory_reserved()


def streamed_phase() -> dict:
    """Phase 21, the streamed executor (``parallel.streamed``): the banded
    scanline kernels against their plain versions and timed; the five
    reference configurations streamed at Teddy against the direct path on
    the card; legacy and canonical FULL at 720p with each path's peak
    memory; the direct path's peak at 1080p/D=256, and from it whether the
    whole-image path fits at 4K; and 4K/D=256 on the JAX package's
    representative pair: active, legacy FULL with penalty_scale='auto' and
    canonical FULL through ``streamed_canonical_staged``, each with its
    bad-2.0, ms a pair, band, peak memory, launches and stages.  Returns the
    two banded kernels' summary fields."""
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
    from stereo_match_traditional_tpu_torch.parallel import (
        auto_row_tile, receptive_field_rows, run_streamed, streamed_canonical_staged,
    )
    from stereo_match_traditional_tpu_torch.parallel.halo import crop_row_halo
    from stereo_match_traditional_tpu_torch.parallel.streamed import (
        _LIVE_VOLUME_ROWS, _band_rows, _mode,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

    start = time.perf_counter()
    total_memory = torch.cuda.get_device_properties(0).total_memory
    gen = torch.Generator(device="cuda").manual_seed(21)
    hh, hw, hd = HUGE
    runs = {
        "active": (C.ADCensusConfig(disp_range=hd), "disp_left"),
        "FULL auto": (C.ADCensusConfig(disp_range=hd, run_post=True,
                                       scanline=C.ScanlineConfig(penalty_scale="auto")),
                      "disp_final"),
        "canonical FULL": (C.ADCensusConfig(disp_range=hd, aggregation="cross_two_pass",
                                            scanline=C.ScanlineConfig(), run_post=True),
                           "disp_final"),
    }
    levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
    families = {
        "scanline_banded_f32": (
            lambda c, p, cr, rs, **k: banded.directional_pass_banded_cuda(c, p, cr, rs, 0.5,
                                                                          True, **k),
            lambda c, p, cr, rs: scanline._directional_pass_banded_plain(c, p, cr, rs, 0.5, True)),
        "scanline_banded_canonical_f32": (
            lambda c, p, cr, rs, **k: banded.canonical_pass_banded_cuda(c, p, cr, rs, 1.0, 3.0,
                                                                        **k),
            lambda c, p, cr, rs: scanline._canonical_pass_banded_plain(c, p, cr, rs, 1.0, 3.0)),
    }

    def band_inputs(t, d, w, name, layout):
        """(cost, penalties, carry) of one pass over a [D, t, W] band: steps
        along its rows (vertical) or its columns (horizontal)."""
        band = torch.rand((d, t, w), device="cuda", generator=gen) * 4
        if name == "scanline_banded_f32":
            pen = torch.rand((t, w), device="cuda", generator=gen) * 3 + 0.5
            pen = pen if layout == "vertical" else pen.T
        else:
            pen = levels[torch.randint(0, 3, (d, t, w), device="cuda", generator=gen)]
            pen = pen.permute(1, 0, 2) if layout == "vertical" else pen.permute(2, 0, 1)
        cost = band.permute(1, 0, 2) if layout == "vertical" else band.permute(2, 0, 1)
        prev = torch.rand((d, cost.shape[2]), device="cuda", generator=gen) * 5
        return cost, pen, (prev, prev.amin(0))

    # -- 21a. the banded kernels against their plain versions --------------
    max_abs = dict.fromkeys(families, 0.0)
    for t, d, w in BANDED_CHECKS:
        for name, (kernel, plain) in families.items():
            for layout in ("vertical", "horizontal"):
                cost, pen, carry = band_inputs(t, d, w, name, layout)
                n = cost.shape[0]
                mask = torch.zeros(n, dtype=torch.bool, device="cuda")
                mask[n // 2] = True
                rec = {"phase": "streamed", "part": "kernel_check", "kernel": name,
                       "band": [t, d, w], "layout": layout}
                for reverse in (False, True):
                    got, (gp, gm) = kernel(cost, pen, carry, n // 2, reverse=reverse)
                    if reverse:
                        want, (wp, wm) = plain(cost.flip(0), pen.flip(0), carry, mask.flip(0))
                        want = want.flip(0)
                    else:
                        want, (wp, wm) = plain(cost, pen, carry, mask)
                    torch.cuda.synchronize()
                    rec[f"bit_exact_reverse_{reverse}"] = bool(
                        torch.equal(got, want) and torch.equal(gp, wp) and torch.equal(gm, wm))
                    rec[f"max_abs_err_reverse_{reverse}"] = (got - want).abs().max().item()
                    max_abs[name] = max(max_abs[name], rec[f"max_abs_err_reverse_{reverse}"])
                emit(rec)
                check(rec["bit_exact_reverse_False"] and rec["bit_exact_reverse_True"], rec)

    # -- 21b. the banded kernels timed, at the 4K-wide band ----------------
    t, d, w = band = BANDED_CHECKS[-1]
    timing = {}
    for name, (kernel, plain) in families.items():
        rec = {}
        for layout in ("vertical", "horizontal"):
            cost, pen, carry = band_inputs(t, d, w, name, layout)
            k_ms, p_ms = alternate(lambda: plain(cost, pen, carry, None),
                                   lambda: kernel(cost, pen, carry, None),
                                   plain_reps=1, kernel_reps=5)
            n, m = cost.shape[0], cost.shape[2]
            # the band in, the band out and the penalties once; ~10
            # operations a value (canonical: the scale a value in too)
            pen_bytes = 4 * pen.numel()
            rec[layout] = {"kernel_ms": k_ms, "plain_ms": p_ms, "steps": n, "lanes": m,
                           **bound(8 * n * d * m + pen_bytes + 8 * (d * m + m),
                                   10.0 * n * d * m)}
            rec[layout]["share_of_bound"] = rec[layout]["bound_ms"] / k_ms
        timing[name] = rec
    emit({"phase": "streamed", "part": "timing_kernels", "band": band, "kernels": timing})

    # -- 21a'. the band entries against their plain versions -----------------
    def entry_calls(agg, imgs):
        """(entry, case, kernel call, plain call) of both band entries on a
        band and its two [t, W] u8 image rows: both views and u8 and
        float32 images for the canonical one."""
        grey = imgs[0].float()
        calls = [(BAND_ENTRIES[0], "grey float32",
                  lambda: banded.horizontal_passes_banded_cuda(agg, grey, 0.5, 4.0),
                  lambda: scanline._horizontal_passes_banded_plain(agg, grey, 0.5, 4.0))]
        for right_view in (False, True):
            for u8 in (True, False):
                b, m = imgs if u8 else [x.float() for x in imgs]
                calls.append((
                    BAND_ENTRIES[1],
                    f"{'right' if right_view else 'left'} view, {'u8' if u8 else 'float32'}",
                    lambda b=b, m=m, rv=right_view: banded.canonical_horizontal_passes_banded_cuda(
                        agg, b, m, 1.0, 3.0, 15.0, rv),
                    lambda b=b, m=m, rv=right_view:
                        scanline._canonical_horizontal_passes_banded_plain(
                            agg, b, m, 1.0, 3.0, 15.0, rv)))
        return calls

    def band_of(t, d, w, halo):
        """A [D, t, W] band of random costs, the halo-cropped view of a
        [D, t + 2 halo, W] volume where halo > 0, and two u8 image rows."""
        vol = torch.rand((d, t + 2 * halo, w), device="cuda", generator=gen) * 4
        imgs = [torch.randint(0, 256, (t, w), device="cuda", generator=gen, dtype=torch.uint8)
                for _ in range(2)]
        return crop_row_halo(vol, halo, 1), imgs

    entry_err = dict.fromkeys(BAND_ENTRIES, 0.0)
    for t, d, w, cropped in HORIZONTAL_CHECKS:
        agg, imgs = band_of(t, d, w, BAND_HALO if cropped else 0)
        for name, case, kernel, plain in entry_calls(agg, imgs):
            before = banded.LAUNCHES[name]
            got = kernel()
            torch.cuda.synchronize()
            launched = banded.LAUNCHES[name] - before
            want = plain()
            rec = {"phase": "streamed", "part": "kernel_check", "kernel": name,
                   "band": [d, t, w], "contiguous": agg.is_contiguous(), "case": case,
                   "launches": launched,
                   "bit_exact": all(bool(torch.equal(g, v)) for g, v in zip(got, want)),
                   "max_abs_err": max((g - v).abs().max().item() for g, v in zip(got, want))}
            emit(rec)
            entry_err[name] = max(entry_err[name], rec["max_abs_err"])
            check(rec["bit_exact"] and launched == 1 and got[0].shape == (d, t, w), rec)
        del agg, imgs

    # -- 21b'. the band entries timed against the strided pair -------------
    # at the 4K-wide band and at the band the 4K calls run (auto_row_tile's t,
    # the halo-cropped view the executor hands on); the plain versions only at
    # the first.  Bound: the band in once, lr and rl out, the image rows in.
    entry_timing = {}
    for name, label in zip(BAND_ENTRIES, ("FULL auto", "canonical FULL")):
        cfg = runs[label][0]
        recs = []
        for t, halo in ((band[0], 0), (auto_row_tile("ad_census", cfg, hh, hw),
                                       receptive_field_rows("ad_census", cfg))):
            agg, imgs = band_of(t, hd, hw, halo)
            if name == BAND_ENTRIES[0]:
                grey = imgs[0].float()
                pens = scanline.horizontal_p2(grey, 0.5, 4.0)
                new = lambda: banded.horizontal_passes_banded_cuda(agg, grey, 0.5, 4.0)  # noqa: E731
                old = lambda: strided_pair(banded.directional_pass_banded_cuda, agg,  # noqa: E731
                                           *pens, 0.5, True)
                plain = lambda: scanline._horizontal_passes_banded_plain(  # noqa: E731
                    agg, grey, 0.5, 4.0)
                in_bytes, ops = 4 * t * hw, 20.0
            else:
                pens = scanline.horizontal_scales(hd, imgs[0], imgs[1], 15.0, False)
                new = lambda: banded.canonical_horizontal_passes_banded_cuda(  # noqa: E731
                    agg, imgs[0], imgs[1], 1.0, 3.0, 15.0, False)
                old = lambda: strided_pair(banded.canonical_pass_banded_cuda, agg,  # noqa: E731
                                           pens[:-1], pens[1:], 1.0, 3.0)
                plain = lambda: scanline._canonical_horizontal_passes_banded_plain(  # noqa: E731
                    agg, imgs[0], imgs[1], 1.0, 3.0, 15.0, False)
                in_bytes, ops = 2 * t * hw, 30.0
            new_ms, old_ms = alternate(old, new, plain_reps=2, kernel_reps=5)
            values = hd * t * hw
            rec = {"band": [hd, t, hw], "contiguous": agg.is_contiguous(), "ms": new_ms,
                   "strided_pair_ms": old_ms, "speedup": old_ms / new_ms,
                   "plain_ms": statistics.median(cuda_ms(plain, 1)) if halo == 0 else None,
                   **bound(12 * values + in_bytes, ops * values),
                   "bound_ms_band_read_twice": (16 * values + in_bytes) / HBM_BYTES_PER_S * 1e3}
            rec["share_of_bound"] = rec["bound_ms"] / new_ms
            recs.append(rec)
            del agg, imgs, pens
            torch.cuda.empty_cache()
        entry_timing[name] = recs
        emit({"phase": "streamed", "part": "timing_kernels", "kernel": name,
              "against": "the strided banded pair (lr + rl) on the same inputs", "bands": recs})

    # -- 21c. the five reference configurations at Teddy -------------------
    h, w, d = TEDDY
    L, R, _ = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    references = {
        "asw": C.ASWConfig(),
        "ad_census FULL": C.ADCensusConfig(disp_range=d, scanline=C.ScanlineConfig(),
                                           run_post=True),
        "sad": C.SADConfig(),
        "ncc": C.NCCConfig(),
        "cblsm": C.CBLSMConfig(),
    }
    for label, cfg in references.items():
        name = label.split()[0]
        fn = get_pipeline(name)[0]
        _reset_launches()
        got = run_streamed(name, lt, rt, cfg, row_tile=STREAM_TEDDY_TILE)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _launches().items() if v}
        want = fn(lt, rt, cfg)
        cd = getattr(cfg, "disp_range", getattr(cfg, "max_disparity", 0))
        agree = _agreement(got, want, cd)
        streamed_ms = statistics.median(cuda_ms(
            lambda: run_streamed(name, lt, rt, cfg, row_tile=STREAM_TEDDY_TILE), 2))
        direct_ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 2))
        rec = {"phase": "streamed", "part": "reference configuration", "config": label,
               "shape": [h, w], "disp_range": cd, "row_tile": STREAM_TEDDY_TILE,
               "launches": launches, "agree_with_direct_on_card": agree,
               "streamed_ms": streamed_ms, "direct_ms": direct_ms}
        emit(rec)
        check(min(agree.values()) == 1.0 if name == "sad"
              else min(agree.values()) >= STREAM_AGREE, rec)
        want_kernel = {"asw": "asw_volume_left_f32", "ad_census": "ad_census_volume_f32",
                       "sad": "sad_volume_f32", "ncc": "ncc_volume_f32",
                       "cblsm": "ad_census_volume_f32"}[name]
        check(launches.get(want_kernel, 0) >= -(-h // STREAM_TEDDY_TILE), rec)
        if label == "ad_census FULL":
            check(launches.get("scanline_banded_f32", 0) > 0
                  and launches.get("scanline_horizontal_band_f32", 0) > 0
                  and launches.get("scanline_optimize_f32", 0) == 0, rec)
    for label, cfg in (("ad_census FULL", references["ad_census FULL"]),
                       ("ad_census canonical FULL", C.ADCensusConfig(
                           disp_range=d, aggregation="cross_two_pass",
                           scanline=C.ScanlineConfig(), run_post=True))):
        call = lambda: run_streamed("ad_census", lt, rt, cfg,  # noqa: E731
                                    row_tile=STREAM_TEDDY_TILE)
        equal_to_strided("reference configuration", label, [h, w], call, call())

    # -- 21d. legacy and canonical FULL at 720p: streamed and direct -------
    sh, sw, sd = SERVING
    L, R, _ = make_pair(sh, sw, sd, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    fn = get_pipeline("ad_census")[0]
    live = {}
    for label, cfg in (("FULL", C.ADCensusConfig(disp_range=sd, scanline=C.ScanlineConfig(),
                                                 run_post=True)),
                       ("canonical FULL", C.ADCensusConfig(
                           disp_range=sd, aggregation="cross_two_pass",
                           scanline=C.ScanlineConfig(), run_post=True))):
        halo = receptive_field_rows("ad_census", cfg)
        got, s_peak, s_reserved = _peak_run(lambda: run_streamed("ad_census", lt, rt, cfg,
                                                                 row_tile=STREAM_SERVING_TILE))
        want, d_peak, d_reserved = _peak_run(lambda: fn(lt, rt, cfg))
        rows = (STREAM_SERVING_TILE + 2 * halo) * sd * sw * 4
        rec = {"phase": "streamed", "part": "720p", "config": label, "shape": [sh, sw],
               "disp_range": sd, "row_tile": STREAM_SERVING_TILE, "halo": halo,
               "agree_with_direct_on_card": _agreement(got, want, sd),
               "streamed_peak_bytes": s_peak, "direct_peak_bytes": d_peak,
               "streamed_peak_reserved_bytes": s_reserved,
               "direct_peak_reserved_bytes": d_reserved,
               "volume_rows_per_band_row": s_peak / rows,
               "model_volume_rows_per_band_row": _LIVE_VOLUME_ROWS[_mode("ad_census", cfg)],
               "streamed_ms": statistics.median(cuda_ms(lambda: run_streamed(
                   "ad_census", lt, rt, cfg, row_tile=STREAM_SERVING_TILE), 1)),
               "direct_ms": statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 1))}
        emit(rec)
        live[label] = rec["volume_rows_per_band_row"]
        check(min(rec["agree_with_direct_on_card"].values()) >= STREAM_AGREE, rec)
        check(rec["volume_rows_per_band_row"] <= rec["model_volume_rows_per_band_row"], rec)
        del want
        equal_to_strided("720p", label, [sh, sw], lambda: run_streamed(
            "ad_census", lt, rt, cfg, row_tile=STREAM_SERVING_TILE), got)
        del got

    # -- 21e. the whole-image path's peak at 1080p/D=256 ---------------------
    ph, pw, pd = DENSE_PROBE
    L, R, _ = make_pair(ph, pw, pd, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    dense = {}
    for label, cfg in (("FULL", C.ADCensusConfig(disp_range=pd, scanline=C.ScanlineConfig(),
                                                 run_post=True)),
                       ("canonical FULL", C.ADCensusConfig(
                           disp_range=pd, aggregation="cross_two_pass",
                           scanline=C.ScanlineConfig(), run_post=True))):
        _, peak, reserved = _peak_run(lambda: fn(lt, rt, cfg))
        # 2160 x 3840 has four times the pixels; every volume scales with them
        dense[label] = {"peak_bytes": peak, "peak_reserved_bytes": reserved,
                        "peak_bytes_x4": 4 * peak, "dense_4k_fits": 4 * peak < total_memory}
    emit({"phase": "streamed", "part": "dense peak probe", "shape": [ph, pw], "disp_range": pd,
          "card_memory_bytes": total_memory, "configs": dense})
    del lt, rt
    torch.cuda.empty_cache()

    # -- 21f. 4K/D=256 streamed on the representative pair -----------------
    L, R, gt = make_pair(hh, hw, hd, seed=0, feature_scale=HUGE_PAIR_SCALE)
    lt, rt = pair_to_torch(L, R, "cuda")
    summary = {}
    for label, (cfg, scored) in runs.items():
        tile = auto_row_tile("ad_census", cfg, hh, hw)
        halo = receptive_field_rows("ad_census", cfg)
        if label == "canonical FULL":
            staged = streamed_canonical_staged(cfg)
            call = lambda: staged(lt, rt)  # noqa: E731
        else:
            call = lambda: run_streamed("ad_census", lt, rt, cfg)  # noqa: E731
        _reset_launches()
        res, peak, reserved = _peak_run(call)
        times = cuda_ms(call, HUGE_TIMED_CALLS)
        launches = {k: v for k, v in _launches().items() if v}
        calls = 1 + HUGE_TIMED_CALLS
        ms = statistics.median(times)
        out = getattr(res, scored)
        check(out.shape == (hh, hw) and bool(torch.isfinite(res.disp_left).all()), label)
        bad2 = bad_pixel_rate(out.cpu().numpy(), gt)
        rec = {"phase": "streamed", "part": "4K", "config": label, "shape": [hh, hw],
               "disp_range": hd, "row_tile": tile, "halo": halo, "bands": -(-hh // tile),
               "ms_a_pair": ms, "ms_timed_calls": times,
               "mpixdisp_per_s": hh * hw * hd / (ms / 1e3) / 1e6,
               "peak_bytes": peak, "peak_reserved_bytes": reserved,
               "card_memory_bytes": total_memory,
               "volume_rows_per_band_row": peak / ((tile + 2 * halo) * hd * hw * 4),
               "launches": launches, "calls": calls,
               f"bad2_{scored}": bad2, "bad2_of_the_jax_package": HUGE_BAD2[label]}
        emit(rec)
        check(abs(bad2 - HUGE_BAD2[label]) <= HUGE_BAD2_TOL, rec)
        check(reserved < total_memory, rec)
        check(launches.get("ad_census_volume_f32", 0) >= calls * rec["bands"], rec)
        if label != "active":
            check(launches.get("scanline_optimize_f32", 0) == 0
                  and launches.get("scanline_canonical_f32", 0) == 0, rec)
        summary[label] = {"launches": launches, "calls": calls, "bands": rec["bands"]}
        del out
        if label == "FULL auto":
            # the same call on the plain bodies of the aggregation and post
            # functions (the path before their kernels): its maps bit for bit,
            # its peak not below the kernels'
            torch.cuda.empty_cache()
            with plain_bodies():
                want, plain_peak, plain_reserved = _peak_run(call)
            rec = {"phase": "streamed", "part": "4K against the plain bodies", "config": label,
                   "maps_equal": _maps_equal(res, want), "peak_bytes": peak,
                   "plain_bodies_peak_bytes": plain_peak, "peak_reserved_bytes": reserved,
                   "plain_bodies_peak_reserved_bytes": plain_reserved}
            emit(rec)
            check(all(rec["maps_equal"].values()) and peak <= plain_peak, rec)
            del want
        del res
        torch.cuda.empty_cache()
    # the banded kernel runs the vertical passes only (3 a band and view), the
    # band entry both horizontal passes of a band and view in one launch
    for label, name, entry, views in (("FULL auto", "scanline_banded_f32", BAND_ENTRIES[0], 1),
                                      ("canonical FULL", "scanline_banded_canonical_f32",
                                       BAND_ENTRIES[1], 2)):
        run = summary[label]
        per = run["calls"] * run["bands"] * views
        check(run["launches"].get(name, 0) == 3 * per
              and run["launches"].get(entry, 0) == per, (label, run))

    # -- 21f'. 4K accuracy cells, one untimed call each ---------------------
    runs["FULL parity"] = (C.ADCensusConfig(disp_range=hd, run_post=True,
                                            scanline=C.ScanlineConfig()), "disp_final")
    legacy = make_pair(hh, hw, hd, seed=0)
    inputs = {"representative": (lt, rt, gt),
              "legacy": (*pair_to_torch(*legacy[:2], "cuda"), legacy[2])}
    for (pair, label), want in HUGE_ACCURACY.items():
        cfg, scored = runs[label]
        a, b, g = inputs[pair]
        res = (streamed_canonical_staged(cfg)(a, b) if label == "canonical FULL"
               else run_streamed("ad_census", a, b, cfg))
        bad2 = {f: bad_pixel_rate(getattr(res, f).cpu().numpy(), g)
                for f in ("disp_left", "disp_final") if getattr(res, f) is not None}
        rec = {"phase": "streamed", "part": "4K accuracy", "pair": pair, "config": label,
               "shape": [hh, hw], "disp_range": hd, "bad2": bad2, "scored": scored,
               "bad2_of_the_jax_package": want}
        emit(rec)
        check(abs(bad2[scored] - want) <= HUGE_BAD2_TOL, rec)
        del res
    del inputs, legacy
    torch.cuda.empty_cache()

    # the cost kernel on the band the 4K FULL call runs (its first band)
    cfg = runs["FULL auto"][0]
    tile = auto_row_tile("ad_census", cfg, hh, hw)
    halo = receptive_field_rows("ad_census", cfg)
    le, re = (_band_rows(x, -halo, tile + halo, hh) for x in (lt, rt))
    cost_call = lambda: ad_census_cuda.ad_census_volumes_cuda(  # noqa: E731
        le, re, hd, cfg.sigma_c, cfg.sigma_s, cfg.census_rows, cfg.census_cols, -halo, hh)
    cost_call()
    rows = tile + 2 * halo
    cost = {"phase": "streamed", "part": "4K band cost", "kernel": "ad_census_volume_f32",
            "band_rows": rows, "disp_range": hd, "width": hw,
            "ms": statistics.median(cuda_ms(cost_call, 3)),
            # both u8 band images in, both views' volumes out
            **bound(2 * rows * hw + 2 * 4 * hd * rows * hw, 0.0)}
    cost["share_of_bound"] = cost["bound_ms"] / cost["ms"]
    emit(cost)
    del le, re
    torch.cuda.empty_cache()

    # -- 21g. stages at 4K: the executor's stereo/<stage> ranges -------------
    for label in ("FULL auto", "canonical FULL"):
        cfg = runs[label][0]
        staged = streamed_canonical_staged(cfg) if label == "canonical FULL" else None
        fn4k = ((lambda: staged(lt, rt)) if staged is not None
                else (lambda: run_streamed("ad_census", lt, rt, cfg)))
        emit({"phase": "streamed", "part": "4K stages", "config": label, "shape": [hh, hw],
              "disp_range": hd, "stage_ms": profiled_stages(fn4k, 1, warm_up=False)})
        if staged is None:
            # the fill (three passes, two kernels each) and the arms (six
            # launches a call)
            emit({"phase": "streamed", "part": "4K fill and arms kernels", "config": label,
                  "shape": [hh, hw], "disp_range": hd,
                  "fill_ms": _kernel_ms(fn4k, 1, ("fill_bits_kernel", "fill_pass_kernel"),
                                        per_call=3),
                  "arms_ms": _kernel_ms(fn4k, 1, ("cross_arms",), per_call=6)})
    del lt, rt
    torch.cuda.empty_cache()
    emit({"phase": "streamed", "part": "done", "seconds": time.perf_counter() - start})

    out = {}
    for name, label in zip(BAND_ENTRIES, ("FULL auto", "canonical FULL")):
        at_band, at_4k = entry_timing[name]
        launches = summary[label]["launches"].get(name, 0)
        out[name] = {"launches": launches,
                     "launches_per_call": launches / summary[label]["calls"],
                     "max_abs_err": entry_err[name], "ms": at_band["ms"],
                     "plain_ms": at_band["plain_ms"],
                     "bound_ms": at_band["bound_ms"], "bound_by": at_band["bound_by"],
                     "share_of_bound": at_band["share_of_bound"],
                     "library_ms": None,
                     "ms_covers": "both horizontal passes of a [D, t, W] = [{}, {}, {}] "
                                  "band".format(*at_band["band"]),
                     "strided_pair_ms": at_band["strided_pair_ms"],
                     "at_4k_band": at_4k}
    for name, label in (("scanline_banded_f32", "FULL auto"),
                        ("scanline_banded_canonical_f32", "canonical FULL")):
        rec = timing[name]["vertical"]
        launches = summary[label]["launches"].get(name, 0)
        out[name] = {"launches": launches,
                     "launches_per_call": launches / summary[label]["calls"],
                     "max_abs_err": max_abs[name], "ms": rec["kernel_ms"],
                     "plain_ms": rec["plain_ms"],
                     "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                     "library_ms": None,
                     "ms_covers": "one vertical pass of a [D, t, W] = [{1}, {0}, {2}] "
                                  "band".format(*band),
                     "horizontal": timing[name]["horizontal"]}
    return out


def banded_vertical_checks(shapes, phase: str) -> dict:
    """The walker / mover vertical kernels (``scanline_banded_f32``,
    ``scanline_banded_canonical_f32``) on ``[H, D, W]`` volumes of the
    ``(D, H, W)`` in ``shapes`` (the tiled executor's whole columns, lanes
    contiguous): from a random carry with a reset mid-path and from a zero
    one, both directions, with the output and carry-only, each bit for bit
    against the plain version and the wide kernel (``torch.equal``), one
    launch a call; then timed (median of CUDA-event-timed calls, the
    wrapper's host part in) beside the wide kernel and the plain version,
    with the bound (the volume in, the output out, the penalties in).
    Returns the timing records by kernel name."""
    import torch

    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(22)
    out = {name: [] for name in banded.WALKER.values()}
    for d, h, w in shapes:
        for canonical in (False, True):
            name = banded.WALKER[canonical]
            cost = torch.rand((h, d, w), device="cuda", generator=gen) * 4
            if canonical:
                pen = levels[torch.randint(0, 3, (h, d, w), device="cuda", generator=gen)]
                a, b, dm1 = 1.0, 3.0, True

                def plain_fn(c, p, cr, rs):
                    return scanline._canonical_pass_banded_plain(c, p, cr, rs, 1.0, 3.0)
            else:
                pen = torch.rand((h, w), device="cuda", generator=gen) * 3 + 0.5
                a, b, dm1 = 0.5, 0.0, True

                def plain_fn(c, p, cr, rs):
                    return scanline._directional_pass_banded_plain(c, p, cr, rs, 0.5, True)
            prev = torch.rand((d, w), device="cuda", generator=gen) * 5
            zero = (torch.zeros_like(prev), torch.zeros((w,), device="cuda"))
            rec = {"phase": phase, "part": "kernel_check", "kernel": name, "shape": [d, h, w]}
            exact = True
            for carry, reset in (((prev, prev.amin(0)), h // 2), (zero, None)):
                for reverse in (False, True):
                    before = banded.LAUNCHES[name]
                    got, (gp, gm) = banded._launch(canonical, cost, pen, carry, reset, a, b, dm1,
                                                   reverse, True)
                    _, (sp, sm) = banded._launch(canonical, cost, pen, carry, reset, a, b, dm1,
                                                 reverse, False)
                    torch.cuda.synchronize()
                    exact &= banded.LAUNCHES[name] == before + 2
                    wide, (xp, xm) = banded._launch(canonical, cost, pen, carry, reset, a, b,
                                                    dm1, reverse, True, banded.WIDE[canonical])
                    r = None if reset is None else (h - 1 - reset if reverse else reset)
                    if reverse:
                        want, (wp, wm) = plain_fn(cost.flip(0), pen.flip(0), carry, r)
                        want = want.flip(0)
                    else:
                        want, (wp, wm) = plain_fn(cost, pen, carry, r)
                    exact &= all(torch.equal(x, y) for x, y in (
                        (got, want), (gp, wp), (gm, wm), (sp, wp), (sm, wm), (wide, got),
                        (xp, gp), (xm, gm)))
                    del got, wide, want
            rec["bit_exact_with_plain_and_wide"] = exact
            emit(rec)
            check(exact, rec)
            call = lambda: banded._launch(canonical, cost, pen, zero, None, a, b, dm1,  # noqa: E731
                                          False, True)
            wide_call = lambda: banded._launch(  # noqa: E731
                canonical, cost, pen, zero, None, a, b, dm1, False, True, banded.WIDE[canonical])
            ms, plain_ms = alternate(lambda: plain_fn(cost, pen, zero, None), call, 1, 10)
            timing = {"shape": [d, h, w], "ms": ms, "plain_ms": plain_ms,
                      "back_to_back_ms": back_to_back_ms(call),
                      "wide_kernel_ms": statistics.median(cuda_ms(wide_call, 3)),
                      **bound(8 * d * h * w + 4 * pen.numel() + 8 * (d * w + w),
                              10.0 * d * h * w)}
            timing["share_of_bound"] = timing["bound_ms"] / timing["ms"]
            emit({"phase": phase, "part": "timing_kernels", "kernel": name, **timing})
            out[name].append(timing)
            del cost, pen, prev, zero
            torch.cuda.empty_cache()
    return out


def examples_phase() -> None:
    """Phase 24, the port's two examples in this process on the card at the
    reference size (375x450, D=60): ``examples/demo_torch.py`` (the five
    pipelines on ``make_pair``) and ``examples/serving_torch.py`` (ad_census
    FULL over the native ``PairLoader``, 16 pairs in batches of 4), with
    every launch count set to 0 just before and read just after.  The asw,
    AD-Census, scanline and window kernels must each have launched; each
    pipeline's bad-2.0 must be within its limit and equal to a direct
    call's on the same pair; the demo's images and checkpoints and the
    served images must hold the direct calls' and ``serve_pairs``' maps.
    Both examples write PGM with the native codec; the serving example is
    handed ad_census FULL as its ``cfg``."""
    import tempfile

    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch.config import (
        ADCensusConfig, ScanlineConfig, disp_override_kw,
    )
    from stereo_match_traditional_tpu_torch.models import PIPELINES, get_pipeline
    from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
    from stereo_match_traditional_tpu_torch.utils import checkpoint, native
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.io import normalize_u8
    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    import demo_torch
    import serving_torch

    start = time.perf_counter()
    h, w, d = TEDDY
    size = ["--size", f"{h}x{w}", "--disp", str(d)]
    full = ADCensusConfig(**disp_override_kw(ADCensusConfig, d), scanline=ScanlineConfig(),
                          run_post=True)
    limits = {"asw": MAX_BAD2, "ad_census": MAX_BAD2, **MAX_BAD2_WINDOW}
    with tempfile.TemporaryDirectory() as tmp:
        demo_dir, serve_dir = os.path.join(tmp, "demo"), os.path.join(tmp, "serving")
        _reset_launches()
        t0 = time.perf_counter()
        bad2 = demo_torch.main([*size, "--out-dir", demo_dir])
        demo_s = time.perf_counter() - t0
        served = serving_torch.main([*size, "--pairs", str(EXAMPLE_PAIRS), "--batch",
                                     str(EXAMPLE_BATCH), "--out-dir", serve_dir], cfg=full)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _launches().items() if v}

        L, R, gt = make_pair(h, w, d, seed=0)
        lt, rt = pair_to_torch(L, R, "cuda")
        direct = {}
        for name in sorted(PIPELINES):
            fn, cfg_cls = get_pipeline(name)
            disp = fn(lt, rt, cfg_cls(**disp_override_kw(cfg_cls, d))).disp_left.cpu().numpy()
            direct[name] = bad_pixel_rate(disp, gt)
            check(np.array_equal(native.read_pnm(os.path.join(demo_dir, f"disp_{name}.pgm")),
                                 normalize_u8(disp)), (name, "the demo's image"))
            saved = checkpoint.load_result(os.path.join(demo_dir, f"stages_{name}"))
            check(np.array_equal(saved.disp_left, disp), (name, "the demo's checkpoint"))
        pairs = [make_pair(h, w, d, seed=i)[:2] for i in range(EXAMPLE_PAIRS)]
        want = list(serve_pairs("ad_census", pairs, full, batch_size=EXAMPLE_BATCH))
        maps_equal = (served["pairs"] == len(served["maps"]) == EXAMPLE_PAIRS
                      and all(np.array_equal(native.read_pnm(p), normalize_u8(m))
                              for p, m in zip(served["maps"], want)))
    rec = {"phase": "examples", "shape": [h, w], "disp_range": d, "demo_bad2": bad2,
           "direct_bad2": direct, "limits": limits, "demo_seconds": demo_s,
           "served": {k: served[k] for k in ("pairs", "seconds", "pairs_per_s", "loader",
                                             "world", "mesh")},
           "served_config": "ad_census FULL", "served_maps_equal_serve_pairs": maps_equal,
           "launches": launches, "seconds": time.perf_counter() - start}
    emit(rec)
    check(bad2 == direct, ("the demo's bad-2.0 differs from direct calls", rec))
    check(all(bad2[k] <= limits[k] for k in PIPELINES), ("bad-2.0 above its limit", rec))
    check(maps_equal, ("the served images differ from serve_pairs over the pairs", rec))
    for entry in ("asw_volume_left_f32", "ad_census_volume_f32", "scanline_optimize_f32",
                  "sad_volume_f32", "ncc_volume_f32"):
        check(launches.get(entry, 0) >= 1, (entry, "did not launch in the examples", rec))


def wide_phase() -> dict:
    """Phase 23, above 256 disparities (D = WIDE_ROUTE_D): every scanline
    wrapper's wide route against the port's plain version on the CPU, bit
    for bit, with its launches (the wide kernel's, none of the tuned
    entries'): ``scanline_optimize_cuda`` (both vertical quirks) and
    ``scanline_optimize_canonical_cuda`` (both views) on a WIDE_IMAGE volume,
    both band entries on a halo-cropped band, both vertical banded passes
    (a carry, a reset, both directions); the wide kernel at WIDE_TIMED's
    volumes (a vertical pass and both horizontal ones on the volume as it
    lies, with the pipeline's own penalties and scales), each bit for bit
    against the plain pass on the same card tensors and timed beside it and
    its bound, and the volumes the band entries' horizontal passes allocate
    counted (no row-contiguous copy); then ad_census FULL and canonical FULL
    through ``get_pipeline`` on a WIDE_PAIR pair with the launch counts set
    to 0 just before and read just after, against the CPU plain path; then
    the same at realistic sizes (``wide_pipelines_at_scale``).  Returns the
    two wide entries' summary fields."""
    import torch

    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        scanline_canonical_cuda, scanline_cuda,
    )
    from stereo_match_traditional_tpu_torch.parallel.halo import crop_row_halo
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    start = time.perf_counter()
    d = WIDE_ROUTE_D
    h, w = WIDE_IMAGE
    gen = torch.Generator(device="cuda").manual_seed(23)
    cost = torch.rand((d, h, w), device="cuda", generator=gen) * 20
    lu, ru = (torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
              for _ in range(2))
    cc, lc, rc = cost.cpu(), lu.cpu(), ru.cpu()
    err = dict.fromkeys(WIDE_ENTRIES, 0.0)

    def held(label, entry, launches, call, want):
        """Run ``call`` on the card, its launches by C entry, against ``want``
        (CPU tensors) bit for bit."""
        def flat(x):
            return [t for y in x for t in flat(y)] if isinstance(x, tuple) else [x]

        _reset_launches()
        got = call()
        torch.cuda.synchronize()
        counts = {k: v for k, v in _launches().items() if v}
        got, want = flat(got), flat(want)
        exact = all(torch.equal(g.cpu(), v) for g, v in zip(got, want))
        e = max((g.cpu() - v).abs().max().item() for g, v in zip(got, want))
        err[entry] = max(err[entry], e)
        rec = {"phase": "wide", "part": "kernel_check", "call": label, "disp_range": d,
               "launches": counts, "bit_exact_with_cpu_plain": exact, "max_abs_err": e}
        emit(rec)
        check(exact and counts == {entry: launches}, rec)

    for quirks in (False, True):
        cfg = C.ScanlineConfig(faithful_vertical_l2=quirks, faithful_vertical_p2=quirks)
        held(f"scanline_optimize_cuda, quirks {quirks}", WIDE_ENTRIES[0], 4,
             lambda: scanline_cuda.scanline_optimize_cuda(cost, lu, cfg),
             scanline._scanline_optimize_plain(cc, lc, cfg))
    for view in ("left", "right"):
        held(f"scanline_optimize_canonical_cuda, {view} view", WIDE_ENTRIES[1], 4,
             lambda: scanline_canonical_cuda.scanline_optimize_canonical_cuda(
                 cost, lu, ru, 1.0, 3.0, 15.0, view),
             scanline._scanline_optimize_canonical_plain(cc, lc, rc, 1.0, 3.0, 15.0, view))
    band, bc = crop_row_halo(cost, 2, 1), crop_row_halo(cc, 2, 1)      # [D, h - 4, w]
    rows, rows_c = (lu[2:-2], ru[2:-2]), (lc[2:-2], rc[2:-2])
    held("horizontal_passes_banded_cuda", WIDE_ENTRIES[0], 2,
         lambda: banded.horizontal_passes_banded_cuda(band, rows[0].float(), 0.5, 4.0),
         scanline._horizontal_passes_banded_plain(bc, rows_c[0].float(), 0.5, 4.0))
    held("canonical_horizontal_passes_banded_cuda", WIDE_ENTRIES[1], 2,
         lambda: banded.canonical_horizontal_passes_banded_cuda(band, *rows, 1.0, 3.0, 15.0,
                                                                True),
         scanline._canonical_horizontal_passes_banded_plain(bc, *rows_c, 1.0, 3.0, 15.0, True))
    p2 = torch.rand((h, w), device="cuda", generator=gen) * 3 + 0.5
    levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
    scale = levels[torch.randint(0, 3, (h, d, w), device="cuda", generator=gen)]
    prev = torch.rand((d, w), device="cuda", generator=gen) * 5
    carry, carry_c = (prev, prev.amin(0)), (prev.cpu(), prev.amin(0).cpu())
    cv, cv_c = cost.permute(1, 0, 2), cc.permute(1, 0, 2)
    for reverse in (False, True):
        held(f"directional_pass_banded_cuda, reverse {reverse}", WIDE_ENTRIES[0], 1,
             lambda: banded.directional_pass_banded_cuda(cv, p2, carry, h // 3, 0.5, True,
                                                         reverse=reverse),
             scanline.directional_pass_banded(cv_c, p2.cpu(), carry_c, h // 3, 0.5, True,
                                              reverse=reverse))
        held(f"canonical_pass_banded_cuda, reverse {reverse}", WIDE_ENTRIES[1], 1,
             lambda: banded.canonical_pass_banded_cuda(cv, scale, carry, h // 3, 1.0, 3.0,
                                                       reverse=reverse),
             scanline.canonical_pass_banded(cv_c, scale.cpu(), carry_c, h // 3, 1.0, 3.0,
                                            reverse=reverse))

    # the wide kernel at WIDE_TIMED's [D, H, W] volumes, against plain on the
    # same card tensors and its bound: a vertical pass (lanes contiguous) and
    # both horizontal ones (steps contiguous: the volume as it lies), with the
    # pipeline's own penalties (scales) of random images
    timing = {entry: {} for entry in WIDE_ENTRIES}
    for shape_label, (td, th, tw) in WIDE_TIMED.items():
        vol = torch.rand((td, th, tw), device="cuda", generator=gen) * 20
        base, match = (torch.randint(0, 256, (th, tw), device="cuda", generator=gen,
                                     dtype=torch.uint8) for _ in range(2))
        zeros = {m: (torch.zeros((td, m), device="cuda"), torch.zeros((m,), device="cuda"))
                 for m in (th, tw)}
        for canonical, entry in enumerate(WIDE_ENTRIES):
            recs = {}
            a, b = (1.0, 3.0) if canonical else (0.5, 0.0)

            def fn(c, p, cr, rs, canonical=canonical, a=a, b=b):
                if canonical:
                    return scanline._canonical_pass_banded_plain(c, p, cr, rs, a, b)
                return scanline._directional_pass_banded_plain(c, p, cr, rs, a, True)

            for layout in ("vertical", "horizontal"):
                if layout == "vertical":
                    c = vol.permute(1, 0, 2)
                    pens = (scanline.vertical_scales(td, base, match, 15.0, False) if canonical
                            else scanline.vertical_p2(base, a, 4.0))
                else:
                    c = vol.permute(2, 0, 1)
                    pens = (scanline.horizontal_scales(td, base, match, 15.0, False)
                            if canonical else scanline.horizontal_p2(base, a, 4.0))
                lr, rl = (pens[:-1], pens[1:]) if canonical else pens
                zero = zeros[c.shape[2]]
                for reverse, pen in ((False, lr), (True, rl)):
                    call = lambda: banded._launch(  # noqa: E731
                        bool(canonical), c, pen, zero, None, a, b, True, reverse, True)
                    plain = lambda: scanline._along_path(  # noqa: E731
                        fn, c, pen, zero, None, reverse, True)
                    got, want = call()[0], plain()[0]
                    torch.cuda.synchronize()
                    exact = bool(torch.equal(got, want))
                    del got, want
                    ms, plain_ms = alternate(plain, call, 1, 5)
                    n, m = c.shape[0], c.shape[2]
                    rec = {"shape": [td, th, tw], "steps": n, "lanes": m, "ms": ms,
                           "plain_ms": plain_ms, "bit_exact_with_plain": exact,
                           **bound(8 * td * n * m + 4 * pen.numel() + 8 * (td * m + m),
                                   10.0 * td * n * m)}
                    rec["share_of_bound"] = rec["bound_ms"] / ms
                    recs[layout + (" reversed" if reverse else "")] = rec
                    check(exact, (entry, shape_label, layout, reverse, rec))
                del pens, lr, rl
            if shape_label == "Teddy":
                # the band entries' horizontal passes: no volume allocated but
                # lr and rl (no row-contiguous copy)
                s_ = (scanline.horizontal_scales(td, base, match, 15.0, False) if canonical
                      else None)
                lr_pen, rl_pen = ((s_[:-1], s_[1:]) if canonical
                                  else scanline.horizontal_p2(base, a, 4.0))
                _, peak, _ = _peak_run(lambda: banded._rows(bool(canonical), vol, lr_pen,
                                                            rl_pen, a, b))
                volume = 4 * td * th * tw
                recs["row_contiguous_copies"] = round((peak - 2 * volume) / volume)
                check(recs["row_contiguous_copies"] == 0, (entry, peak / volume))
                del s_, lr_pen, rl_pen
            timing[entry][shape_label] = recs
            emit({"phase": "wide", "part": "timing_kernels", "kernel": entry,
                  "volume": shape_label, **recs})
            torch.cuda.empty_cache()
        del vol, zeros
        torch.cuda.empty_cache()

    # the main path above 256 disparities: ad_census FULL and canonical FULL
    ph, pw = WIDE_PAIR
    L, R, _ = make_pair(ph, pw, d, seed=2)
    lt, rt = pair_to_torch(L, R, "cuda")
    lcpu, rcpu = pair_to_torch(L, R, "cpu")
    fn = get_pipeline("ad_census")[0]
    launches = {}
    for label, entry, cfg in (
            ("ad_census FULL", WIDE_ENTRIES[0],
             C.ADCensusConfig(disp_range=d, scanline=C.ScanlineConfig(), run_post=True)),
            ("ad_census canonical FULL", WIDE_ENTRIES[1],
             C.ADCensusConfig(disp_range=d, aggregation="cross_two_pass",
                              scanline=C.ScanlineConfig(), run_post=True))):
        _reset_launches()
        res = fn(lt, rt, cfg)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _launches().items() if v}
        want = fn(lcpu, rcpu, cfg)
        got = type(res)(*(None if x is None else x.cpu() for x in res))
        agree = {f: (getattr(got, f) == getattr(want, f)).double().mean().item()
                 for f in ("disp_left", "disp_right", "disp_final")}
        ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 2))
        rec = {"phase": "wide", "part": "main path", "config": label, "shape": [ph, pw],
               "disp_range": d, "launches": counts, "agree_with_cpu_plain_path": agree,
               "agree_outside_the_clamp_triangle": _agreement(got, want, d), "ms": ms,
               "disp_left_in_range": bool(torch.isfinite(got.disp_left).all()
                                          and got.disp_left.max().item() <= d - 1)}
        emit(rec)
        views = 2 if "canonical" in label else 1
        check(counts.get(entry, 0) == 4 * views and counts.get("scanline_optimize_f32", 0) == 0
              and counts.get("scanline_canonical_f32", 0) == 0 and rec["disp_left_in_range"], rec)
        # legacy FULL: every pixel; canonical: its cost kernel's last ulp breaks
        # the clamp triangle's ties otherwise, so outside it (as phase 21)
        check(min(agree.values()) == 1.0 if views == 1
              else min(rec["agree_outside_the_clamp_triangle"].values()) >= MIN_WTA_AGREE, rec)
        launches[entry] = counts[entry]
    wide_pipelines_at_scale()
    served_full_size()
    emit({"phase": "wide", "part": "done", "seconds": time.perf_counter() - start})

    out = {}
    for entry in WIDE_ENTRIES:
        teddy = timing[entry]["Teddy"]
        rec = teddy["vertical"]
        out[entry] = {"launches": launches[entry], "launches_per_call": launches[entry],
                      "max_abs_err": err[entry], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                      "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                      "share_of_bound": rec["share_of_bound"], "library_ms": None,
                      "ms_covers": "one vertical pass of a [D, H, W] = [{}, {}, {}] "
                                   "volume".format(*WIDE_TIMED["Teddy"]),
                      "horizontal": teddy["horizontal"],
                      "horizontal_reversed": teddy["horizontal reversed"],
                      "row_contiguous_copies": teddy["row_contiguous_copies"],
                      "full_size": timing[entry]["full size"],
                      "d800_band": timing[entry]["D=800 band"]}
    return out


@contextlib.contextmanager
def held_to_plain(module, name, hold):
    """``module.name`` wrapped for the duration: each call runs the wrapped
    function, then ``hold(args, result)``, whose records are collected in
    the list this yields."""
    wrapped, records = getattr(module, name), []

    def call(*args, **kwargs):
        result = wrapped(*args, **kwargs)
        rec = hold(args, kwargs, result)
        if rec is not None:
            records.append(rec)
        return result

    setattr(module, name, call)
    try:
        yield records
    finally:
        setattr(module, name, wrapped)


def wide_pipelines_at_scale() -> None:
    """Phase 23b: ad_census FULL and canonical FULL above 256 disparities at
    realistic sizes, the wide kernel on their whole scanline: direct at the
    Middlebury 2014 half-size geometry (WIDE_HALF, each scanline call held
    bit for bit to the port's plain whole-image scanline on the same card
    tensors), and streamed at the full-size one (WIDE_FULL, legacy FULL and
    canonical staged: the first wide launch of each family, layout and
    direction held bit for bit to the plain banded pass), each with its
    launches, ms a pair, peak memory and (streamed) device ms by ``stereo/``
    range."""
    import torch

    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        scanline_canonical_cuda,
        scanline_cuda,
    )
    from stereo_match_traditional_tpu_torch.parallel import (
        auto_row_tile, run_streamed, streamed_canonical_staged,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    def full(d):
        return C.ADCensusConfig(disp_range=d, scanline=C.ScanlineConfig(), run_post=True)

    def canonical_full(d):
        return C.ADCensusConfig(disp_range=d, aggregation="cross_two_pass",
                                scanline=C.ScanlineConfig(), run_post=True)

    # direct at the half-size geometry
    h, w, d = WIDE_HALF
    L, R, _ = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    fn = get_pipeline("ad_census")[0]
    for label, cfg, launcher, name, plain_fn, entry in (
            ("ad_census FULL", full(d), scanline_cuda, "scanline_optimize_cuda",
             scanline._scanline_optimize_plain, WIDE_ENTRIES[0]),
            ("ad_census canonical FULL", canonical_full(d), scanline_canonical_cuda,
             "scanline_optimize_canonical_cuda", scanline._scanline_optimize_canonical_plain,
             WIDE_ENTRIES[1])):
        def hold(args, kwargs, result, plain_fn=plain_fn):
            want = plain_fn(*args, **kwargs)
            torch.cuda.synchronize()
            return bool(torch.equal(result, want)) and result.is_contiguous()

        _reset_launches()
        with held_to_plain(launcher, name, hold) as held:
            res = fn(lt, rt, cfg)
            torch.cuda.synchronize()
        counts = {k: v for k, v in _launches().items() if v}
        del res
        _, peak, reserved = _peak_run(lambda: fn(lt, rt, cfg))
        ms = statistics.median(cuda_ms(lambda: fn(lt, rt, cfg), 2))
        views = 2 if "canonical" in label else 1
        rec = {"phase": "wide", "part": "direct at scale", "config": label, "shape": [h, w],
               "disp_range": d, "launches": counts, "ms_a_pair": ms,
               "mpixdisp_per_s": h * w * d / (ms / 1e3) / 1e6, "peak_bytes": peak,
               "peak_reserved_bytes": reserved,
               "scanline_calls_bit_exact_with_plain": held}
        emit(rec)
        check(len(held) == views and all(held) and counts.get(entry, 0) == 4 * views
              and counts.get("scanline_optimize_f32", 0) == 0
              and counts.get("scanline_canonical_f32", 0) == 0, rec)
        torch.cuda.empty_cache()
    del lt, rt
    torch.cuda.empty_cache()

    # streamed at the full-size geometry
    h, w, d = WIDE_FULL
    L, R, _ = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    for label, cfg in (("FULL", full(d)), ("canonical FULL", canonical_full(d))):
        tile = auto_row_tile("ad_census", cfg, h, w)

        def call(row_tile=None, label=label, cfg=cfg):
            if label == "canonical FULL":
                return streamed_canonical_staged(cfg, row_tile)(lt, rt)
            return run_streamed("ad_census", lt, rt, cfg, row_tile)

        seen = set()

        def hold(args, kwargs, result, cfg=cfg):
            canonical, cost, pen, carry, reset, p1, p2, dm1, reverse, store = args[:10]
            key = (bool(canonical), cost.stride(0) in (1, -1), bool(reverse))
            if key in seen:
                return None
            seen.add(key)

            def plain_fn(c, p, cr, rs):
                if canonical:
                    return scanline._canonical_pass_banded_plain(c, p, cr, rs, p1, p2)
                return scanline._directional_pass_banded_plain(c, p, cr, rs, p1, dm1)

            want = scanline._along_path(plain_fn, cost, pen, carry, reset, reverse, store)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(
                (result[0], *result[1]), (want[0], *want[1])) if x is not None]
            return {"canonical": key[0], "steps_contiguous": key[1], "reversed": key[2],
                    "shape": list(cost.shape), "bit_exact_with_plain": all(same)}

        # the held call in bands of half the rows: room for the plain passes
        with held_to_plain(banded, "_launch", hold) as held:
            call(max(64, tile // 2))
            torch.cuda.synchronize()
        _reset_launches()
        res, peak, reserved = _peak_run(call)
        counts = {k: v for k, v in _launches().items() if v}
        check(bool(torch.isfinite(res.disp_left).all()), label)
        del res
        times = cuda_ms(call, 2)
        ms = statistics.median(times)
        rec = {"phase": "wide", "part": "streamed at scale", "config": label, "shape": [h, w],
               "disp_range": d, "row_tile": tile, "launches": counts, "calls": 1,
               "ms_a_pair": ms, "ms_timed_calls": times,
               "mpixdisp_per_s": h * w * d / (ms / 1e3) / 1e6, "peak_bytes": peak,
               "peak_reserved_bytes": reserved,
               "card_memory_bytes": torch.cuda.get_device_properties(0).total_memory,
               "wide_launches_held_to_plain": held,
               "stage_ms": profiled_stages(call, 1, warm_up=False)}
        emit(rec)
        entry = WIDE_ENTRIES[label == "canonical FULL"]
        # vertical and horizontal passes, both directions, on the wide kernel only
        check(len(held) == 4 and all(r["bit_exact_with_plain"] for r in held)
              and counts.get(entry, 0) > 0 and counts.get(BAND_ENTRIES[0], 0) == 0
              and counts.get(BAND_ENTRIES[1], 0) == 0
              and counts.get("scanline_banded_f32", 0) == 0
              and counts.get("scanline_banded_canonical_f32", 0) == 0
              and reserved < rec["card_memory_bytes"], rec)
        torch.cuda.empty_cache()
    del lt, rt
    torch.cuda.empty_cache()


def served_full_size() -> None:
    """Phase 23c: ad_census FULL at the full-size geometry (WIDE_FULL)
    through ``models.batch.serve_pairs``, the users' entry, one pair a
    batch: the route it takes (the direct pipeline: ``serve_pairs`` has no
    other), the peak memory allocated and reserved while it serves, ms a
    pair over SERVED_PAIRS pairs (the host's clock: ``serve_pairs`` waits for
    each map), the spans' counters, and device ms by ``stereo/`` range, the
    ranges of the rect mean and of the composed scanline's rows and columns
    among them."""
    import numpy as np
    import torch

    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
    from stereo_match_traditional_tpu_torch.utils.profiling import record_spans
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    h, w, d = WIDE_FULL
    cfg = C.ADCensusConfig(disp_range=d, scanline=C.ScanlineConfig(), run_post=True)
    pairs = [make_pair(h, w, d, seed=s)[:2] for s in (0, 1)]

    def serve(n):
        return list(serve_pairs("ad_census", (pairs[k % 2] for k in range(n)), cfg))

    serve(1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with record_spans() as rec:
        t0 = time.perf_counter()
        maps = serve(SERVED_PAIRS)
        seconds = time.perf_counter() - t0
    # the stage ranges of the pipeline call that serve_pairs runs inside
    # stereo/serve_run (the serving spans have no card work of their own)
    lt, rt = (torch.from_numpy(x).cuda() for x in pairs[0])
    stages = profiled_stages(lambda: get_pipeline("ad_census")[0](lt, rt, cfg), 1)
    ranges = {"rect_mean", "scanline_rows", "scanline_columns", "post"}
    out = {"phase": "wide", "part": "served at full size", "config": "FULL", "shape": [h, w],
           "disp_range": d, "route": "direct (models.batch.serve_pairs)", "pairs": len(maps),
           "ms_a_pair": 1e3 * seconds / len(maps),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "peak_reserved_bytes": torch.cuda.max_memory_reserved(),
           "card_memory_bytes": torch.cuda.get_device_properties(0).total_memory,
           "counters": dict(rec.counters), "stage_ms": stages}
    emit(out)
    check(len(maps) == SERVED_PAIRS and all(np.isfinite(m).any() for m in maps)
          and rec.counters.get("ad_census.volume_elements") == SERVED_PAIRS * d * h * w
          and rec.counters.get("scanline.wide_passes") == 4 * SERVED_PAIRS
          and ranges <= set(stages), out)
    del maps, lt, rt
    torch.cuda.empty_cache()


def _tiled_runs() -> list:
    """``(label, pipeline, (h, w, d), cfg, runner)`` of the tiled phase's
    runs: the five reference configurations at Teddy over row tiles, the
    ``(tile, disp)`` runners at Teddy (ncc at its committed D=200), and
    legacy and canonical ad_census FULL at 720p.  ``runner`` is ``tiled``
    (``run_tiled`` over every rank) or ``tile_disp`` (a (1, world) mesh:
    one row tile, the disparities over the ranks)."""
    from stereo_match_traditional_tpu_torch import config as C

    h, w, d = TEDDY
    sh, sw, sd = SERVING
    scan = C.ScanlineConfig()
    return [
        ("asw", "asw", TEDDY, C.ASWConfig(), "tiled"),
        ("ad_census FULL", "ad_census", TEDDY,
         C.ADCensusConfig(disp_range=d, scanline=scan, run_post=True), "tiled"),
        ("sad", "sad", TEDDY, C.SADConfig(), "tiled"),
        ("ncc", "ncc", (h, w, 200), C.NCCConfig(), "tiled"),
        ("cblsm", "cblsm", TEDDY, C.CBLSMConfig(), "tiled"),
        ("ad_census_tile_disp", "ad_census", TEDDY, C.ADCensusConfig(disp_range=d), "tile_disp"),
        ("ncc_tile_disp", "ncc", (h, w, 200), C.NCCConfig(), "tile_disp"),
        ("ad_census FULL 720p", "ad_census", SERVING,
         C.ADCensusConfig(disp_range=sd, scanline=scan, run_post=True), "tiled"),
        ("ad_census canonical FULL 720p", "ad_census", SERVING,
         C.ADCensusConfig(disp_range=sd, aggregation="cross_two_pass", scanline=scan,
                          run_post=True), "tiled"),
    ]


def _tiled_run_all(world: int, rank: int, stages: bool = False) -> list:
    """Every run of :func:`_tiled_runs` on this rank: ms a call (CUDA events,
    the median of TILED_REPS calls after the first, which is held to the
    direct path on rank 0), launches by C entry, peak memory; with
    ``stages``, the 720p runs' ``stereo/<stage>`` ranges from a trace of two
    calls.  Every rank makes the same calls in the same order."""
    import torch

    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.parallel import make_mesh, run_tiled
    from stereo_match_traditional_tpu_torch.parallel.tiled import (
        ad_census_tile_disp, ncc_tile_disp,
    )
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    tiles = make_mesh(axis_names=("tile",))
    grid = make_mesh(axis_names=("tile", "disp"), shape=(1, world))
    pairs, out = {}, []
    for label, name, (h, w, d), cfg, runner in _tiled_runs():
        if (h, w) not in pairs:
            L, R, _ = make_pair(h, w, min(d, 128), seed=0)
            pairs[h, w] = pair_to_torch(L, R, "cuda")
        lt, rt = pairs[h, w]
        if runner == "tiled":
            call = lambda: run_tiled(name, lt, rt, cfg, tiles)  # noqa: E731
        else:
            fn = (ad_census_tile_disp if name == "ad_census" else ncc_tile_disp)(cfg, grid)
            call = lambda: fn(lt, rt)  # noqa: E731
        _reset_launches()
        got, peak, reserved = _peak_run(call)
        launches = {k: v for k, v in _launches().items() if v}
        reps = TILED_REPS if h == TEDDY[0] else 1
        times = cuda_ms(call, reps)
        rec = {"config": label, "runner": runner, "shape": [h, w], "disp_range": d,
               "ranks": world, "rank": rank, "ms_a_pair": statistics.median(times),
               "ms_timed_calls": times, "launches": launches, "peak_bytes": peak,
               "peak_reserved_bytes": reserved}
        if stages and h == SERVING[0]:
            # two calls: the profiler has lost the first kernels of a trace,
            # here the first call's tiny halo stage (seen on the card)
            rec["stage_ms"] = profiled_stages(call, 2, warm_up=False)
        if rank == 0:
            want = get_pipeline(name)[0](lt, rt, cfg)
            rec["agree_with_direct_on_card"] = _agreement(got, want, d)
            rec["direct_ms"] = statistics.median(cuda_ms(lambda: get_pipeline(name)[0](
                lt, rt, cfg), reps))
            del want
        out.append(rec)
        del got
        torch.cuda.empty_cache()
    return out


def _tiled_checks(rec: dict) -> None:
    """A tiled run's maps within the envelope of the direct path (sad, ncc
    and asw bit for bit), through its kernels, the scanline by the band
    entries and the banded kernel only."""
    agree = rec["agree_with_direct_on_card"]
    exact = rec["config"].split()[0] in ("sad", "ncc", "asw", "ncc_tile_disp")
    check(min(agree.values()) == 1.0 if exact else min(agree.values()) >= STREAM_AGREE, rec)
    launches = rec["launches"]
    name = rec["config"].split()[0]
    want = {"asw": "asw_volume_left_f32", "ad_census": "ad_census_volume_f32",
            "sad": "sad_volume_f32", "ncc": "ncc_volume_f32", "cblsm": "ad_census_volume_f32",
            "ad_census_tile_disp": "ad_census_volume_f32",
            "ncc_tile_disp": "ncc_volume_f32"}[name]
    check(launches.get(want, 0) >= 1, rec)
    if "FULL" in rec["config"]:
        canonical = "canonical" in rec["config"]
        entry = ("scanline_canonical_horizontal_band_f32" if canonical
                 else "scanline_horizontal_band_f32")
        banded = "scanline_banded_canonical_f32" if canonical else "scanline_banded_f32"
        check(launches.get(entry, 0) >= 1 and launches.get(banded, 0) >= 2
              and launches.get("scanline_optimize_f32", 0) == 0
              and launches.get("scanline_canonical_f32", 0) == 0, rec)


def tiled_rank(rank: int, port: str, out_path: str) -> None:
    """One rank of the tiled phase's two-rank run (``chip_smoke.py
    --tiled-rank RANK PORT OUT``, started by :func:`tiled_phase`): both ranks
    on the one card over gloo, whose exchanges go through host memory while
    every operation runs on the card; the records to ``OUT``."""
    import torch
    import torch.distributed as dist

    from stereo_match_traditional_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", TILED_RANKS, rank, backend="gloo")
    torch.cuda.set_device(0)
    recs = _tiled_run_all(TILED_RANKS, rank)
    with open(out_path, "w") as f:
        json.dump(recs, f)
    dist.destroy_process_group()


def tiled_phase(kind: str) -> dict:
    """Phase 22, the tiled executor (``parallel.tiled``).  (a) The two
    kernels with ``d_offset`` (``ad_census_volume_f32``, ``ncc_volume_f32``):
    each slice of disparities against its plain version, the slices joined
    equal to the whole-volume kernel bit for bit, and timed.  (b) A world of
    one in this process over NCCL: :func:`_tiled_runs` against the direct
    path.  (c) Two ranks on the one card in two processes over gloo (NCCL
    refuses two ranks on one device): the same runs; a two-rank time on one
    card is not a multi-card number.  NCCL across several cards is not
    measured here.  Returns the two ``d_offset`` entries' summary fields."""
    import socket
    import tempfile

    import torch
    import torch.distributed as dist

    from stereo_match_traditional_tpu_torch.ops import volume
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda as ac
    from stereo_match_traditional_tpu_torch.ops.kernels import window_cost_cuda as wc
    from stereo_match_traditional_tpu_torch.parallel import distributed
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    start = time.perf_counter()
    h, w, d = TEDDY
    L, R, _ = make_pair(h, w, d, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    lc, rc = pair_to_torch(L, R, "cpu")
    summary = {}

    # -- 22a. the d-slices against their plain versions and the whole volume --
    def slices(offsets, total, kernel, plain, views):
        bounds = list(offsets) + [total]
        whole = kernel(lt, rt, total, 0)
        got, err = [], 0.0
        for o, e in zip(bounds, bounds[1:]):
            vols = kernel(lt, rt, e - o, o)
            want = plain(lc, rc, e - o, o)
            for v in range(views):
                err = max(err, (vols[v].cpu() - want[v]).abs().max().item())
            got.append(vols)
        joined = all(torch.equal(torch.cat([g[v] for g in got]), whole[v]) for v in range(views))
        return joined, err

    cost_kernel = lambda a, b, n, o: ac.ad_census_volumes_cuda(a, b, n, d_offset=o)  # noqa: E731
    cost_plain = lambda a, b, n, o: volume._ad_census_volumes_plain(  # noqa: E731
        a, b, n, d_offset=o)
    ncc_kernel = lambda a, b, n, o: volume.ncc_volume(a, b, n, 10, d_offset=o)[:1]  # noqa: E731
    ncc_plain = lambda a, b, n, o: volume._ncc_volume_plain(  # noqa: E731
        a, b, n, 10, d_offset=o)[:1]
    err = {"ad_census_volume_f32": 0.0, "ncc_volume_f32": 0.0}
    for kernel_name, kernel, plain, views, total, offsets in (
            ("ad_census_volume_f32", cost_kernel, cost_plain, 2, d, TILED_OFFSETS),
            ("ncc_volume_f32", ncc_kernel, ncc_plain, 1, d, TILED_OFFSETS),
            ("ncc_volume_f32", ncc_kernel, ncc_plain, 1, 200, TILED_NCC_OFFSETS)):
        joined, e = slices(offsets, total, kernel, plain, views)
        rec = {"phase": "tiled", "part": "kernel_check", "kernel": kernel_name,
               "shape": [h, w], "disp_range": total, "d_offsets": list(offsets),
               "slices_join_to_whole_volume": joined, "max_abs_err": e}
        emit(rec)
        check(joined, rec)
        check(e <= (AD_CENSUS_ATOL if views == 2 else 0.0), rec)
        err[kernel_name] = max(err[kernel_name], e)
    # the AD and Hamming parts of a slice: exact
    for part, fn, pl in (("ad", ac.ad_volume_cuda, volume._ad_volume_plain),
                         ("census", ac.census_volume_cuda, volume._census_volume_plain)):
        for view in ("left", "right"):
            check(torch.equal(fn(lt, rt, 30, view=view, d_offset=15).cpu(),
                              pl(lc, rc, 30, view=view, d_offset=15)), (part, view))
    # timed: a slice from an offset against its plain version on the card
    for kernel_name, n, o, call, plain_call, out_bytes, flop in (
            ("ad_census_volume_f32", 30, 15,
             lambda: ac.ad_census_volumes_cuda(lt, rt, 30, d_offset=15),
             lambda: volume._ad_census_volumes_plain(lt, rt, 30, d_offset=15), 8, 12.0),
            ("ncc_volume_f32", 100, 100,
             lambda: volume.ncc_volume(lt, rt, 100, 10, d_offset=100),
             lambda: volume._ncc_volume_plain(lt, rt, 100, 10, d_offset=100), 4, 10.0)):
        ms, plain_ms = alternate(plain_call, call, 2, 10)
        summary[kernel_name] = {
            "max_abs_err": err[kernel_name], "ms": ms, "plain_ms": plain_ms,
            "ms_covers": f"disparities {o}..{o + n - 1} of a {h}x{w} pair"
                         + (" (both views)" if out_bytes == 8 else ""),
            "back_to_back_ms": back_to_back_ms(call),
            **bound(2 * h * w + out_bytes * n * h * w, flop * n * h * w),
            "library_ms": None}
        summary[kernel_name]["share_of_bound"] = (summary[kernel_name]["bound_ms"]
                                                  / summary[kernel_name]["ms"])
        emit({"phase": "tiled", "part": "timing_kernels", "kernel": kernel_name,
              **summary[kernel_name]})
    del lt, rt
    torch.cuda.empty_cache()

    # -- 22a'. the banded vertical kernels at the executor's whole columns ----
    summary["vertical"] = banded_vertical_checks(TILED_VERTICAL, "tiled")

    # -- 22b. a world of one over NCCL, in this process ------------------------
    status = distributed.initialize()
    check(status == "single-process" and dist.get_backend() == "nccl", status)
    for rec in _tiled_run_all(1, 0, stages=True):
        rec.update(phase="tiled", part="world of one (NCCL)", card=kind)
        emit(rec)
        _tiled_checks(rec)
    # the 720p maps with every banded pass on the wide kernel: bit for bit
    from stereo_match_traditional_tpu_torch.parallel import make_mesh, run_tiled

    tiles = make_mesh(axis_names=("tile",))
    L, R, _ = make_pair(*SERVING, seed=0)
    lt, rt = pair_to_torch(L, R, "cuda")
    for label, name, _, cfg, _ in _tiled_runs()[-2:]:
        call = lambda: run_tiled(name, lt, rt, cfg, tiles)  # noqa: E731
        equal_to_strided("world of one (NCCL)", label, list(SERVING[:2]), call, call(),
                         phase="tiled")
    # legacy FULL's maps against the plain bodies of the aggregation and post
    # functions (the path before their kernels): bit for bit
    pairs = {SERVING[:2]: (lt, rt)}
    for label, name, (th, tw, td), cfg, runner in _tiled_runs():
        if runner != "tiled" or not label.startswith("ad_census FULL"):
            continue
        if (th, tw) not in pairs:
            pairs[th, tw] = pair_to_torch(*make_pair(th, tw, td, seed=0)[:2], "cuda")
        a, b = pairs[th, tw]
        got = run_tiled(name, a, b, cfg, tiles)
        with plain_bodies():
            want = run_tiled(name, a, b, cfg, tiles)
        rec = {"phase": "tiled", "part": "world of one (NCCL) against the plain bodies",
               "config": label, "shape": [th, tw], "disp_range": td,
               "maps_equal": _maps_equal(got, want)}
        emit(rec)
        check(all(rec["maps_equal"].values()), rec)
        del got, want
    del lt, rt, pairs
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # -- 22c. two ranks on the one card over gloo, in two processes -------------
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(TILED_RANKS)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(TILED_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tiled-rank",
                                   str(r), port, outs[r]], stdout=logs[r],
                                  stderr=subprocess.STDOUT)
                 for r in range(TILED_RANKS)]
        deadline = time.monotonic() + TILED_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read()[-4000:])
            log.close()
        check(all(p.returncode == 0 for p in procs),
              ("two-rank run", [p.returncode for p in procs], texts))
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
    tile_disp_launches = {"ad_census_volume_f32": 0, "ncc_volume_f32": 0}
    for recs in zip(*ranks):
        rec = dict(recs[0], phase="tiled", part="two ranks on one card (gloo)", card=kind,
                   note="two processes sharing one card: not a multi-card number",
                   ms_a_pair_by_rank=[r["ms_a_pair"] for r in recs],
                   launches_by_rank=[r["launches"] for r in recs],
                   peak_bytes_by_rank=[r["peak_bytes"] for r in recs])
        emit(rec)
        _tiled_checks(rec)
        if rec["runner"] == "tile_disp":
            for r in recs:
                for k in tile_disp_launches:
                    tile_disp_launches[k] += r["launches"].get(k, 0)
    for k, n in tile_disp_launches.items():
        check(n >= TILED_RANKS, (k, n))
        summary[k]["launches"] = n
    emit({"phase": "tiled", "part": "done", "seconds": time.perf_counter() - start})
    return summary


def _voting_inputs(call):
    """The arguments of the first ``post.iterative_region_voting`` call that
    ``call()`` makes: the canonical post's LR-checked map, the left arms,
    and the rest as the post passes them."""
    from stereo_match_traditional_tpu_torch.ops import post

    seen = []
    real = post.iterative_region_voting

    def spy(disp, arms, *a, **k):
        if not seen:
            seen.append((disp.clone(), arms, a, k))
        return real(disp, arms, *a, **k)

    post.iterative_region_voting = spy
    try:
        call()
    finally:
        post.iterative_region_voting = real
    check(len(seen) == 1, "the call voted")
    return seen[0]


def region_voting_phase() -> dict:
    """Phase 26, the region voting kernel (``csrc/region_voting.cu``) on the
    inputs the canonical post hands it (ad_census canonical FULL at Teddy,
    KITTI and 720p, the streamed canonical call at 4K/D=256): the map bit
    for bit against the plain body's, the targets (``region_voting.targets``
    inside ``record_spans()``) and launches, and the kernel and the plain
    body timed by CUDA events in turns, back to back and by kernel.
    Returns the kernel's summary fields but its launches, which phase 13
    counts on the main path; ``max_abs_err`` is the largest over the
    shapes.  Runs alone:
    ``TEARDOWN_CUPTI=0 python3 -c "import chip_smoke; chip_smoke.region_voting_phase()"``."""
    import torch

    from stereo_match_traditional_tpu_torch import ADCensusConfig, ScanlineConfig
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.ops import post
    from stereo_match_traditional_tpu_torch.ops.kernels import post_cuda
    from stereo_match_traditional_tpu_torch.parallel.streamed import streamed_canonical_staged
    from stereo_match_traditional_tpu_torch.utils import profiling
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    start = time.perf_counter()
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    fn = get_pipeline("ad_census")[0]
    cases = []
    for hh, ww, dd, scale in VOTING_SHAPES:
        cfg = ADCensusConfig(disp_range=dd, aggregation="cross_two_pass",
                             scanline=ScanlineConfig(), run_post=True)
        lt, rt = pair_to_torch(*make_pair(hh, ww, dd, seed=0, feature_scale=scale)[:2], "cuda")
        cases.append((f"{hh}x{ww}/D={dd}", cfg,
                      lambda lt=lt, rt=rt, cfg=cfg: fn(lt, rt, cfg)))
    hh, hw, hd = HUGE
    cfg = ADCensusConfig(disp_range=hd, aggregation="cross_two_pass", scanline=ScanlineConfig(),
                         run_post=True)
    lt4, rt4 = pair_to_torch(*make_pair(hh, hw, hd, seed=0, feature_scale=HUGE_PAIR_SCALE)[:2],
                             "cuda")
    staged = streamed_canonical_staged(cfg)
    cases.append((f"{hh}x{hw}/D={hd} streamed whole map", cfg, lambda: staged(lt4, rt4)))

    out = {}
    for label, cfg, call in cases:
        disp, arms, a, k = _voting_inputs(call)
        torch.cuda.empty_cache()
        h, w = disp.shape
        called = inspect.signature(post.iterative_region_voting).bind(disp, arms, *a, **k)
        called.apply_defaults()
        nd, iters = called.arguments["disp_range"], called.arguments["num_iters"]
        kernel = lambda: post.iterative_region_voting(disp, arms, *a, **k)  # noqa: E731
        plain = lambda: post._iterative_region_voting_plain(disp, arms, *a, **k)  # noqa: E731
        before = post_cuda.LAUNCHES["region_voting_f32"]
        with profiling.record_spans() as rec:
            got = kernel()
        torch.cuda.synchronize()
        launches = post_cuda.LAUNCHES["region_voting_f32"] - before
        targets = rec.counters.get("region_voting.targets", 0)
        want = plain()
        invalid = int((disp == post.INVALID).sum())
        # 0 where the two agree, invalid pixels included (inf - inf is nan)
        err = torch.where(got == want, 0.0, (got - want).abs()).max().item()
        r = {"phase": "region_voting", "shape": [h, w], "disp_range": nd, "config": label,
             "bit_exact": torch.equal(got.view(torch.int32), want.view(torch.int32)),
             "max_abs_err": err, "launches": launches, "invalid_before": invalid,
             "invalid_after": int((got == post.INVALID).sum()), "targets": targets,
             "targets_share_of_pixel_iterations": targets / (h * w * iters)}
        check(r["bit_exact"] and launches == 1 and 0 < targets <= invalid * iters, r)
        del got, want
        reps = 1 if h * w > 4e6 else 3
        kernel_ms, plain_ms = alternate(plain, kernel, reps, 10)
        r.update(kernel_ms=kernel_ms, plain_ms=plain_ms, back_to_back_ms=back_to_back_ms(kernel),
                 kernels_ms={}, **bound(24.0 * h * w, 0.0))
        # by kernel, and the launches each made in the trace (the count and
        # apply kernels once an iteration)
        events = traced_events(kernel, 5)
        for name in VOTING_KERNELS:
            durs = [e["dur"] for e in events if e.get("cat") == "kernel" and name in e["name"]]
            r["kernels_ms"][name] = {"ms": sum(durs) / 1e3 / 5, "launches": len(durs) / 5,
                                     "each_ms": [d / 1e3 for d in durs[:iters]]}
        r["share_of_bound"] = r["bound_ms"] / r["kernel_ms"]
        r["share_of_bound_back_to_back"] = r["bound_ms"] / r["back_to_back_ms"]
        emit(r)
        out[label] = r
        del disp, arms
        torch.cuda.empty_cache()
    emit({"phase": "region_voting", "part": "done", "seconds": time.perf_counter() - start})
    teddy = out[f"{TEDDY[0]}x{TEDDY[1]}/D={TEDDY[2]}"]
    return {"max_abs_err": max(r["max_abs_err"] for r in out.values()), "ms": teddy["kernel_ms"], "plain_ms": teddy["plain_ms"],
            "bound_ms": teddy["bound_ms"], "bound_by": teddy["bound_by"], "library_ms": None,
            "ms_covers": "one call: five iterations (2 kernels each), the prep and a memset",
            "back_to_back_ms": teddy["back_to_back_ms"], "kernels_ms": teddy["kernels_ms"],
            "at": {k: v for k, v in out.items() if v is not teddy}}


@contextlib.contextmanager
def plain_bodies():
    """The four public functions that dispatch to the aggregation and post
    kernels (``aggregate.cross_arms``, ``aggregate.rect_mean_aggregate``,
    ``post.remove_speckles``, ``post.fill_holes_8dir``, and the fill's pass
    ``post._fill_from_candidates``) routed to their plain bodies for the
    duration: the path the port took on the card before the kernels, to
    hold the maps and the peaks of a call against in the same run."""
    from stereo_match_traditional_tpu_torch.ops import aggregate, post

    def rect(vol, arms, inclusive=True, max_span=None, layout="auto"):
        return aggregate._rect_mean_aggregate_plain(vol, arms, inclusive)

    def speckles(disp, diff_insame=1.0, min_speckle_area=80, invalid_value=post.INVALID,
                 background=None, max_iters=None, connectivity=8, block=None):
        return post._remove_speckles_plain(disp, diff_insame, min_speckle_area, invalid_value,
                                           background, max_iters, connectivity)

    patches = [(aggregate, "cross_arms", aggregate._cross_arms_plain),
               (aggregate, "rect_mean_aggregate", rect),
               (post, "remove_speckles", speckles),
               (post, "fill_holes_8dir", post._fill_holes_8dir_plain),
               (post, "_fill_from_candidates", post._fill_from_candidates_plain)]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    for m, n, f in patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _maps_equal(a, b) -> dict:
    """``torch.equal`` of each map of two pipeline results."""
    import torch

    out = {}
    for f in ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch"):
        x, y = getattr(a, f), getattr(b, f)
        check((x is None) == (y is None), f)
        if x is not None:
            out[f] = bool(x.shape == y.shape and torch.equal(x, y))
    return out


def _speckle_map(h, w, seed, holes, invalid):
    """Integer disparities in 5x5 patches with noise and a share of invalid
    pixels, and an occlusion / mismatch split of the invalid ones, on the
    card: components and holes of many sizes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, 12, size=(h // 5 + 1, w // 5 + 1))
    d = np.kron(coarse, np.ones((5, 5)))[:h, :w]
    d = np.where(rng.random((h, w)) < 0.1, rng.integers(0, 12, size=(h, w)), d)
    d = np.where(rng.random((h, w)) < holes, invalid, d).astype(np.float32)
    bad = ~np.isfinite(d) | (d == np.float32(invalid))
    occl = bad & (rng.random((h, w)) < 0.5)
    mism = bad & ~occl & (rng.random((h, w)) < 0.7)
    return tuple(torch.from_numpy(a).cuda() for a in (d, occl, mism))


def _ulps(got, want) -> int:
    """The largest distance in float32 ulps between two volumes of
    non-negative values."""
    import torch

    return int((got.view(torch.int32).long() - want.view(torch.int32).long()).abs().max())


def _capped_arms(h, w, cap, seed, at_cap=0.5):
    """Random arms in [0, cap] on the card, half exactly at it, clipped to
    the image as real arms are."""
    import torch

    from stereo_match_traditional_tpu_torch.ops.aggregate import Arms

    gen = torch.Generator(device="cuda").manual_seed(seed)
    ii = torch.arange(h, device="cuda")[:, None].expand(h, w)
    jj = torch.arange(w, device="cuda")[None, :].expand(h, w)
    out = []
    for room in (jj, w - 1 - jj, ii, h - 1 - ii):
        a = torch.randint(0, cap + 1, (h, w), device="cuda", generator=gen)
        a = torch.where(torch.rand((h, w), device="cuda", generator=gen) < at_cap, cap, a)
        out.append(torch.minimum(a, room).to(torch.int32))
    return Arms(*out)


def _kernel_ms(fn, reps: int, names, per_call: int = 1) -> dict:
    """Device ms a call of each kernel whose name holds one of ``names``
    (launched ``per_call`` times a call), from a trace of ``reps`` calls of
    ``fn`` (kernels launched through a C entry are read from the trace, not
    the profiler's op tree); None for a kernel of which the trace lost a
    launch (the profiler can, see ``traced_events``): these times explain
    the wrapper's, which the phase times by CUDA events and checks."""
    events = traced_events(fn, reps)
    out = {}
    for name in names:
        durs = [e["dur"] for e in events if e.get("cat") == "kernel" and name in e["name"]]
        out[name] = sum(durs) / 1e3 / reps if len(durs) == reps * per_call else None
    return out


def _full_inputs(h, w, d, seed):
    """The real inputs of the four functions in one ad_census FULL call on
    ``cuda_pair(h, w, d, seed)``, by the kernels: the images, both cost
    volumes, both views' arms and aggregated volumes, the LR check's map and
    masks, the speckle-filtered map, and the fill's first pass's map, target
    mask and caps."""
    import torch

    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, scanline_cuda

    full = C.ADCensusConfig(disp_range=d, scanline=C.ScanlineConfig(), run_post=True)
    lt, rt = cuda_pair(h, w, d, seed)
    vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
    arms_l, arms_r = aggregate.cross_arms(lt, full.arms), aggregate.cross_arms(rt, full.arms)
    agg_l = aggregate.rect_mean_aggregate(vol_l, arms_l, max_span=full.arms.max_length)
    agg_r = aggregate.rect_mean_aggregate(vol_r, arms_r, max_span=full.arms.max_length)
    opt = scanline_cuda.scanline_optimize_cuda(agg_l, lt, full.scanline)
    lr = post.lr_check_consistency(wta.wta(opt), wta.wta(agg_r), full.lr_gate, post.INVALID)
    spk = post.remove_speckles(lr.disp, full.speckle_diff, full.speckle_area,
                               invalid_value=post.INVALID)
    # the fill's first pass as fill_holes_8dir makes it: the map with
    # invalid_value read as +inf, its non-finite occlusions, the caps
    first = torch.where(spk == post.INVALID, float("inf"), spk)
    return dict(cfg=full, lt=lt, rt=rt, vol_l=vol_l, vol_r=vol_r, arms_l=arms_l,
                arms_r=arms_r, agg_l=agg_l, agg_r=agg_r, lr=lr, spk=spk, first=first,
                occluded=lr.occlusion & ~torch.isfinite(first),
                caps=(d - 1, int(round((d - 1) * 0.70710678))))


def agg_post_phase() -> dict:
    """Phase 25, the aggregation and post kernels (``csrc/aggregate.cu``:
    ``cross_arms_i32``, ``rect_mean_f32`` (the chunked table: calls without
    a cap), ``rect_mean_walker_f32`` (the strip walker: calls with the arms'
    cap, the main path's); ``csrc/post.cu``: ``fill_holes_8dir_f32`` (the
    three passes, the main path's) and ``fill_pass_f32`` (one pass: the
    sharded post's; bitsets and a target list, a thread a target, each),
    ``remove_speckles_f32`` (tile-local labelling)).  (a) Each against its
    plain version on the same CUDA tensors at AGG_POST_GEOMETRIES (cross
    arms grey and colour, u8 and float32, and a band with ``row_offset``;
    both rect-mean routes on both AD-Census views, the two concatenated,
    inclusive and exclusive, bit for bit, and on random volumes and a second
    pass's means within a float32 ulp; the fill with rays capped and
    unbounded; the speckle filter with 4- and 8-connectivity and a
    background); the raise on an explicit ``max_iters`` below the cap.  (a')
    The walker at WALKER_EDGES, bit for bit, its word of arms over the cap
    read as 0, the route by the cap (none and 49: the chunked table) and a
    cap below the arms counted; the speckle filter at SPECKLE_EDGES (one
    component, a checkerboard, stripes across tiles); the fill and the arms
    at FILL_ARMS_EDGES, every FILL_EDGE_SEARCH and ARM_EDGE_LENGTHS, and
    one fill pass at FILL_PASS_CAPS with a target mask holding finite
    pixels, on a contiguous and a transposed map.  (b) The real inputs of
    ad_census FULL at Teddy and 720p, sad's (unbounded fill, background
    speckles), asw's (4-connectivity) and cblsm's (its stacked second pass),
    bit for bit.  (c) Each timed against its plain version on those inputs
    beside its bound, the walker's pre-pass, the speckle filter's four
    kernels, the fill's two and the arms' one apart from a trace.  (d)
    ad_census FULL through ``get_pipeline`` at Teddy (launch counts set to 0
    just before, read just after; the word of arms over the cap read as 0) and at 720p: ms and
    per-stage ms beside the same calls on the plain bodies, the device
    kernels of one call from a trace, and the maps of FULL and of sad, asw
    and cblsm with post equal to the plain bodies' bit for bit; the chunked
    table's own path (the public function without a cap) counted.  Returns
    each kernel's summary fields."""
    import torch

    from stereo_match_traditional_tpu_torch import config as C
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.asw import _minmax_u8
    from stereo_match_traditional_tpu_torch.ops import aggregate, post, wta
    from stereo_match_traditional_tpu_torch.ops.kernels import (
        ad_census_cuda, aggregate_cuda, post_cuda, scanline_cuda, window_cost_cuda,
    )
    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

    start = time.perf_counter()
    err = dict.fromkeys(AGG_POST_ENTRIES, 0.0)

    def direct_means(vol, arms, flat):
        """The inclusive rect means at the flat indices ``flat`` of ``vol``,
        each from a float64 sum of its rectangle's values (no summed-area
        table: magnitudes of the rectangle's alone) and the float32
        division: the reference where the kernel and the plain version
        differ."""
        n, hh, ww = vol.shape
        out = []
        for t in flat:
            s, p = divmod(int(t), hh * ww)
            i, j = divmod(p, ww)
            u, dn, lf, rt_ = (int(a[i, j]) for a in (arms.up, arms.down, arms.left, arms.right))
            total = vol[s, max(i - u, 0): min(i + dn, hh - 1) + 1,
                        max(j - lf, 0): min(j + rt_, ww - 1) + 1].double().sum().float()
            count = torch.tensor(float((u + dn + 1) * (lf + rt_ + 1)), device=vol.device)
            out.append(torch.div(total, count).item())
        return out

    def hold(entry, rec, got, want, ulps=0, vol=None, arms=None):
        if isinstance(got, tuple):
            exact = all(torch.equal(g, x) for g, x in zip(got, want))
            diff = max((g - x).abs().max().item() for g, x in zip(got, want))
        else:
            exact = torch.equal(got, want)
            fin = torch.isfinite(want)
            diff = (got[fin] - want[fin]).abs().max().item() if bool(fin.any()) else 0.0
            check(torch.equal(torch.isfinite(got), fin), rec)
        rec.update(kernel=entry, bit_exact=exact)
        if ulps:
            # where the two differ, each against the direct float64 sum of
            # the rectangle
            off = torch.nonzero((got != want).reshape(-1)).reshape(-1)[:RECT_DIRECT_CHECKS]
            ref = direct_means(vol, arms, off.tolist())
            g, x = got.reshape(-1)[off].tolist(), want.reshape(-1)[off].tolist()
            rec.update(max_ulps=_ulps(got, want), values_off=int((got != want).sum()),
                       values=int(want.numel()), checked_against_direct_sum=len(ref),
                       kernel_equals_direct=sum(a == r for a, r in zip(g, ref)),
                       plain_equals_direct=sum(b == r for b, r in zip(x, ref)))
            check(rec["max_ulps"] <= ulps, rec)
        else:
            check(exact, rec)
        err[entry] = max(err[entry], diff)
        emit(rec)

    # -- 25a. the kernels against their plain versions ----------------------
    arm_cfg = C.ADCensusConfig().arms
    span = arm_cfg.max_length
    aggregate_cuda.arms_over_cap("cuda", reset=True)
    for h, w, d, seed in AGG_POST_GEOMETRIES:
        lt, rt = cuda_pair(h, w, d, seed)
        base = {"phase": "agg_post", "part": "kernel_check", "geometry": [h, w, d]}
        colour = torch.stack([lt, lt.roll(1, 1), lt // 2 + 40], dim=-1)
        for label, img in (("u8", lt), ("float32", lt.float() * 0.75), ("colour u8", colour),
                           ("colour float32", colour.float() * 0.75)):
            hold("cross_arms_i32", dict(base, image=label), tuple(aggregate.cross_arms(
                img, arm_cfg)), tuple(aggregate._cross_arms_plain(img, arm_cfg)))
        vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
        arms = aggregate.cross_arms(lt, arm_cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        rand = torch.rand((d, h, w), device="cuda", generator=gen) * 3.0
        # without a cap the chunked-table kernels, with the arms' cap the
        # strip walker
        for entry, cap in (("rect_mean_f32", None), ("rect_mean_walker_f32", span)):
            for inclusive in (True, False):
                for label, vol in (("left", vol_l), ("right", vol_r),
                                   ("both views concatenated", torch.cat([vol_l, vol_r]))):
                    hold(entry, dict(base, volume=f"AD-Census {label}", inclusive=inclusive,
                                     max_span=cap),
                         aggregate.rect_mean_aggregate(vol, arms, inclusive, max_span=cap),
                         aggregate._rect_mean_aggregate_plain(vol, arms, inclusive))
            second = aggregate.rect_mean_aggregate(vol_l, arms, max_span=cap)
            for label, vol in (("random", rand), ("second pass", second)):
                hold(entry, dict(base, volume=label, max_span=cap), aggregate.rect_mean_aggregate(
                    vol, arms, max_span=cap), aggregate._rect_mean_aggregate_plain(vol, arms, True),
                     ulps=RECT_ULPS, vol=vol, arms=arms)
        del vol_l, vol_r, rand, second
        for invalid in (float("inf"), -1.0):
            disp, occl, mism = _speckle_map(h, w, seed, 0.3, invalid)
            for ms in (None, d):
                hold("fill_holes_8dir_f32", dict(base, invalid=str(invalid), max_search=ms),
                     post.fill_holes_8dir(disp, occl, mism, invalid, ms),
                     post._fill_holes_8dir_plain(disp, occl, mism, invalid, ms))
        for conn, bg, invalid in ((8, None, float("inf")), (4, None, float("inf")),
                                  (8, 0.0, float("inf")), (4, 0.0, 0.0)):
            disp = _speckle_map(h, w, seed + 1, 0.15, invalid)[0]
            hold("remove_speckles_f32",
                 dict(base, connectivity=conn, background=bg, invalid=str(invalid)),
                 post.remove_speckles(disp, 1.0, 30, invalid, bg, None, conn),
                 post._remove_speckles_plain(disp, 1.0, 30, invalid, bg, None, conn))
    # a band of rows placed in a taller image (the executors' halo'd bands)
    lt = cuda_pair(*TEDDY, 0)[0]
    h = lt.shape[0]
    for ro, rows in ((-34, h - 34), (41, h), (h - 75, h)):
        band = lt[max(ro, 0): max(ro, 0) + 75]
        hold("cross_arms_i32", {"phase": "agg_post", "part": "kernel_check",
                                "band": [ro, rows, list(band.shape)]},
             tuple(aggregate.cross_arms(band, arm_cfg, ro, rows)),
             tuple(aggregate._cross_arms_plain(band, arm_cfg, ro, rows)))
    disp = _speckle_map(40, 60, 3, 0.1, float("inf"))[0]
    cap = post_cuda.speckle_iteration_cap(40, 60)
    try:
        post.remove_speckles(disp, 1.0, 30, max_iters=cap - 1)
        raised = None
    except ValueError as e:
        raised = str(e)
    emit({"phase": "agg_post", "part": "max_iters below the cap", "cap": cap,
          "max_iters": cap - 1, "raised": raised})
    check(raised is not None and "max_iters" in raised, raised)

    # -- 25a'. the walker's strips and ring at their edges, its route by the
    # cap and its word of arms over the cap; the speckle tiles at theirs
    for n, h, w, cap in WALKER_EDGES:
        gen = torch.Generator(device="cuda").manual_seed(n + h + w)
        vol = torch.randint(0, 9, (n, h, w), device="cuda", generator=gen).float()
        arms = _capped_arms(h, w, cap, h * w)
        for inclusive in (True, False):
            hold("rect_mean_walker_f32", {"phase": "agg_post", "part": "walker edges",
                                          "shape": [n, h, w], "max_span": cap,
                                          "inclusive": inclusive},
                 aggregate.rect_mean_aggregate(vol, arms, inclusive, max_span=cap),
                 aggregate._rect_mean_aggregate_plain(vol, arms, inclusive))
    over = aggregate_cuda.arms_over_cap("cuda", reset=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    vol = torch.randint(0, 9, (9, 90, 170), device="cuda", generator=gen).float()
    arms = _capped_arms(90, 170, 20, 3)
    walked = aggregate.rect_mean_aggregate(vol, arms, max_span=20)
    _reset_launches()
    routes = {str(cap): torch.equal(aggregate.rect_mean_aggregate(vol, arms, max_span=cap),
                                    walked) for cap in (None, 49)}
    route_launches = {k: v for k, v in _launches().items() if v}
    clamped = aggregate.Arms(*(a.clamp(max=7) for a in arms))
    below = torch.equal(aggregate.rect_mean_aggregate(vol, arms, max_span=7),
                        aggregate._rect_mean_aggregate_plain(vol, clamped, True))
    rec = {"phase": "agg_post", "part": "walker route and cap",
           "arms_over_cap_before": over, "chunked_route_equal_to_walker": routes,
           "route_launches": route_launches, "cap_7_equal_to_clamped_plain": below,
           "arms_over_cap_7": aggregate_cuda.arms_over_cap("cuda", reset=True),
           "arms_above_7": sum(int((a > 7).sum()) for a in arms)}
    emit(rec)
    check(over == 0 and all(routes.values()) and below, rec)
    check(route_launches == {"rect_mean_f32": 2}, rec)
    check(rec["arms_over_cap_7"] == rec["arms_above_7"] > 0, rec)
    for h, w in SPECKLE_EDGES:
        ii = torch.arange(h, device="cuda")[:, None]
        jj = torch.arange(w, device="cuda")[None, :]
        one = torch.full((h, w), 5.0, device="cuda")
        one[::2, 1::3] = 5.5
        maps = {"one component": (one, 1.0, h * w), "one component, area above": (
                    one, 1.0, h * w + 1),
                "checkerboard": (torch.where((ii + jj) % 2 == 0, 3.0, float("inf")).float(),
                                 0.0, 2),
                "stripes across tiles": (((ii + jj) // 7 % 5).float(), 0.0, 40)}
        for label, (disp, diff, area) in maps.items():
            for conn in (4, 8):
                hold("remove_speckles_f32", {"phase": "agg_post", "part": "speckle tile edges",
                                             "shape": [h, w], "map": label, "connectivity": conn},
                     post.remove_speckles(disp, diff, area, connectivity=conn),
                     post._remove_speckles_plain(disp, diff, area, float("inf"), None, None, conn))
    # the fill and the arms at their edges
    for h, w in FILL_ARMS_EDGES:
        base = {"phase": "agg_post", "part": "fill and arms edges", "shape": [h, w]}
        for invalid in (float("inf"), -1.0):
            disp, occl, mism = _speckle_map(h, w, h + w, 0.4, invalid)
            for ms in FILL_EDGE_SEARCH:
                hold("fill_holes_8dir_f32", dict(base, invalid=str(invalid), max_search=ms),
                     post.fill_holes_8dir(disp, occl, mism, invalid, ms),
                     post._fill_holes_8dir_plain(disp, occl, mism, invalid, ms))
        gen = torch.Generator(device="cuda").manual_seed(h * w)
        # flat runs (long arms) broken by steps and noise (short ones)
        steps = torch.randint(0, 200, (h // 37 + 1, w // 23 + 1), device="cuda", generator=gen)
        img = steps.repeat_interleave(37, 0).repeat_interleave(23, 1)[:h, :w]
        noise = torch.randint(-9, 10, (h, w), device="cuda", generator=gen)
        img = (img + noise * (torch.rand((h, w), device="cuda", generator=gen) < 0.3))
        img = img.clamp(0, 255).to(torch.uint8)
        colour = torch.stack([img, img.roll(1, 1), img // 2 + 40], dim=-1).float() * 0.75
        for length in ARM_EDGE_LENGTHS:
            cfg = C.CrossArmConfig(tao1=30, tao2=6, max_length=length, sec_length=length // 2)
            for label, x in (("u8", img), ("colour float32", colour)):
                hold("cross_arms_i32", dict(base, image=label, max_length=length),
                     tuple(aggregate.cross_arms(x, cfg)),
                     tuple(aggregate._cross_arms_plain(x, cfg)))
    disp, occl, mism = _speckle_map(150, 301, 7, 0.5, float("inf"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    target = occl | mism | (torch.rand(disp.shape, device="cuda", generator=gen) < 0.2)
    for caps in FILL_PASS_CAPS:
        for layout, d, t in (("contiguous", disp, target), ("transposed", disp.t(), target.t())):
            for second in (True, False):
                hold("fill_pass_f32", {"phase": "agg_post", "part": "fill pass edges",
                                       "caps": list(caps), "layout": layout, "second": second},
                     post._fill_from_candidates(d, t, second, *caps),
                     post._fill_from_candidates_plain(d, t, second, *caps))

    # -- 25b. the real inputs of the main path and of the other chains -------
    inputs = {}
    for (h, w, d), seed in ((TEDDY, 0), (SERVING, 1)):
        x = inputs[h, w, d] = _full_inputs(h, w, d, seed)
        base = {"phase": "agg_post", "part": "FULL inputs", "geometry": [h, w, d]}
        for view in ("l", "r"):
            img = x["lt"] if view == "l" else x["rt"]
            hold("cross_arms_i32", dict(base, view=view), x[f"arms_{view}"],
                 tuple(aggregate._cross_arms_plain(img, x["cfg"].arms)))
            hold("rect_mean_walker_f32", dict(base, view=view), x[f"agg_{view}"],
                 aggregate._rect_mean_aggregate_plain(x[f"vol_{view}"], x[f"arms_{view}"], True))
        lr, cfg = x["lr"], x["cfg"]
        hold("remove_speckles_f32", dict(base, map="LR map, 8-connectivity"), x["spk"],
             post._remove_speckles_plain(lr.disp, cfg.speckle_diff, cfg.speckle_area,
                                         post.INVALID, None, None, 8))
        hold("fill_holes_8dir_f32", dict(base, map="speckle-filtered LR map", max_search=d),
             post.fill_holes_8dir(x["spk"], lr.occlusion, lr.mismatch, post.INVALID, d),
             post._fill_holes_8dir_plain(x["spk"], lr.occlusion, lr.mismatch, post.INVALID, d))
    h, w, d = TEDDY
    x = inputs[TEDDY]
    lt, rt = x["lt"], x["rt"]
    sc = C.SADConfig(run_post=True)
    sdl = wta.optimal_disparity(window_cost_cuda.sad_volume_cuda(lt, rt, d, sc.winsize))
    sdr = wta.wta(window_cost_cuda.sad_volume_cuda(lt, rt, d, sc.winsize, "right"))
    slr = post.lr_check_simple(sdl, sdr, sc.lr_gate, post.INVALID)
    sspk = post.remove_speckles(slr.disp, sc.speckle_diff, sc.speckle_area,
                                invalid_value=post.INVALID, background=0.0)
    base = {"phase": "agg_post", "part": "sad post inputs", "geometry": [h, w, d]}
    hold("remove_speckles_f32", dict(base, map="LR map, background 0"), sspk,
         post._remove_speckles_plain(slr.disp, sc.speckle_diff, sc.speckle_area, post.INVALID,
                                     0.0, None, 8))
    hold("fill_holes_8dir_f32", dict(base, max_search=None),
         post.fill_holes_8dir(sspk, slr.occlusion, slr.mismatch, post.INVALID),
         post._fill_holes_8dir_plain(sspk, slr.occlusion, slr.mismatch, post.INVALID))
    ac = C.ASWConfig()
    alr = post.lr_check_simple(wta.wta(x["vol_l"]), wta.wta(x["vol_r"]), ac.lr_gate, 0.0)
    scaled = _minmax_u8(alr.disp)
    hold("remove_speckles_f32", {"phase": "agg_post", "part": "asw post inputs",
                                 "map": "min-max u8 map, 4-connectivity, invalid 0"},
         post.remove_speckles(scaled, ac.speckle_diff, ac.speckle_area + 1, invalid_value=0.0,
                              connectivity=4),
         post._remove_speckles_plain(scaled, ac.speckle_diff, ac.speckle_area + 1, 0.0, None,
                                     None, 4))
    cb = C.CBLSMConfig()
    ad_l, ad_r = ad_census_cuda.ad_volumes_cuda(lt, rt, d)
    c_arms = aggregate.cross_arms(lt, cb.arms)
    c_span = cb.arms.max_length
    first = torch.cat([aggregate.rect_mean_aggregate(ad_l, c_arms, max_span=c_span),
                       aggregate.rect_mean_aggregate(ad_r, aggregate.cross_arms(rt, cb.arms),
                                                     max_span=c_span)])
    hold("cross_arms_i32", {"phase": "agg_post", "part": "cblsm inputs", "image": "left"},
         tuple(c_arms), tuple(aggregate._cross_arms_plain(lt, cb.arms)))
    hold("rect_mean_walker_f32", {"phase": "agg_post", "part": "cblsm inputs",
                                  "volume": "AD costs, first pass"},
         first[:d], aggregate._rect_mean_aggregate_plain(ad_l, c_arms, True))
    hold("rect_mean_walker_f32", {"phase": "agg_post", "part": "cblsm inputs",
                                  "volume": "stacked second pass (non-integer means)"},
         aggregate.rect_mean_aggregate(first, c_arms, max_span=c_span),
         aggregate._rect_mean_aggregate_plain(first, c_arms, True), ulps=RECT_ULPS, vol=first,
         arms=c_arms)
    del ad_l, ad_r, first

    # -- 25c. the kernels timed against their plain versions ----------------
    timing = {}
    for (h, w, d), x in inputs.items():
        lr, cfg = x["lr"], x["cfg"]
        cases = {
            # one image: u8 in, four int32 maps out
            "cross_arms_i32": (
                lambda: aggregate._cross_arms_plain(x["lt"], cfg.arms),
                lambda: aggregate.cross_arms(x["lt"], cfg.arms), h * w + 16 * h * w),
            # one view: the volume in and out, the four arm maps in; without
            # a cap (the chunked table) and with the main path's (the walker)
            "rect_mean_f32": (
                lambda: aggregate._rect_mean_aggregate_plain(x["vol_l"], x["arms_l"], True),
                lambda: aggregate.rect_mean_aggregate(x["vol_l"], x["arms_l"]),
                8 * d * h * w + 16 * h * w),
            "rect_mean_walker_f32": (
                lambda: aggregate._rect_mean_aggregate_plain(x["vol_l"], x["arms_l"], True),
                lambda: aggregate.rect_mean_aggregate(x["vol_l"], x["arms_l"],
                                                      max_span=cfg.arms.max_length),
                8 * d * h * w + 16 * h * w),
            # the map and both masks in, the map out (the three passes)
            "fill_holes_8dir_f32": (
                lambda: post._fill_holes_8dir_plain(x["spk"], lr.occlusion, lr.mismatch,
                                                    post.INVALID, d),
                lambda: post.fill_holes_8dir(x["spk"], lr.occlusion, lr.mismatch, post.INVALID,
                                             d), 10 * h * w),
            # one pass (the first, on its own input): the map and the
            # target mask in, the map out
            "fill_pass_f32": (
                lambda: post._fill_from_candidates_plain(x["first"], x["occluded"], True,
                                                         *x["caps"]),
                lambda: post._fill_from_candidates(x["first"], x["occluded"], True,
                                                   *x["caps"]), 9 * h * w),
            # the map in and out
            "remove_speckles_f32": (
                lambda: post._remove_speckles_plain(lr.disp, cfg.speckle_diff,
                                                    cfg.speckle_area, post.INVALID, None,
                                                    None, 8),
                lambda: post.remove_speckles(lr.disp, cfg.speckle_diff, cfg.speckle_area,
                                             invalid_value=post.INVALID), 8 * h * w),
        }
        for entry, (plain_fn, kernel_fn, nbytes) in cases.items():
            k_ms, p_ms = alternate(plain_fn, kernel_fn, plain_reps=3, kernel_reps=10)
            rec = {"kernel_ms": k_ms, "back_to_back_ms": back_to_back_ms(kernel_fn),
                   "plain_ms": p_ms, "speedup": p_ms / k_ms, **bound(nbytes, 0.0)}
            rec["share_of_bound"] = rec["bound_ms"] / k_ms
            timing[entry, f"{h}x{w}/D={d}"] = rec
        # the kernels of one call, from a trace: the walker's pre-pass apart
        # from the walker, the speckle filter's four
        timing["rect_mean_walker_f32", f"{h}x{w}/D={d}"]["kernels_ms"] = _kernel_ms(
            cases["rect_mean_walker_f32"][1], 5, ("rect_carry_kernel", "rect_walker_kernel"))
        timing["remove_speckles_f32", f"{h}x{w}/D={d}"]["kernels_ms"] = _kernel_ms(
            cases["remove_speckles_f32"][1], 5, ("speckle_tile_kernel", "speckle_merge_kernel",
                                                 "speckle_tally_kernel", "speckle_kill_kernel"))
        # the fill's bitsets and target lists, its searches (three of each a
        # call), the arms' kernel (the grey u8 one on these images)
        timing["fill_holes_8dir_f32", f"{h}x{w}/D={d}"]["kernels_ms"] = _kernel_ms(
            cases["fill_holes_8dir_f32"][1], 5, ("fill_bits_kernel", "fill_pass_kernel"),
            per_call=3)
        timing["cross_arms_i32", f"{h}x{w}/D={d}"]["kernels_ms"] = _kernel_ms(
            cases["cross_arms_i32"][1], 5, ("cross_arms",))
        emit({"phase": "agg_post", "part": "timing_kernels", "shape": [h, w], "disp_range": d,
              "covers": {"cross_arms_i32": "one image", "rect_mean_f32": "one view, no cap",
                         "rect_mean_walker_f32": "one view, the main path's cap",
                         "fill_pass_f32": "the first pass alone (the sharded post's call)",
                         "fill_holes_8dir_f32": "one fill_holes_8dir call (three passes, each "
                                                "the tile kernel and the search kernel)",
                         "remove_speckles_f32": "one call"},
              "kernels": {k: v for (k, s), v in timing.items() if s == f"{h}x{w}/D={d}"}})

    # -- 25d. ad_census FULL through its entry point, against the plain bodies
    fn = get_pipeline("ad_census")[0]
    h, w, d = TEDDY
    lt, rt = inputs[TEDDY]["lt"], inputs[TEDDY]["rt"]
    full = inputs[TEDDY]["cfg"]
    _reset_launches()
    for _ in range(MAIN_PATH_CALLS):
        res = fn(lt, rt, full)
    torch.cuda.synchronize()
    launches = _launches()
    counted = {k: launches[k] for k in AGG_POST_ENTRIES}
    want = {"cross_arms_i32": 2, "rect_mean_f32": 0, "rect_mean_walker_f32": 2,
            "fill_pass_f32": 0, "fill_holes_8dir_f32": 1, "remove_speckles_f32": 1}
    check(counted == {k: n * MAIN_PATH_CALLS for k, n in want.items()}, counted)
    over = aggregate_cuda.arms_over_cap("cuda", reset=True)
    check(over == 0, ("arms over the cap on the main path", over))
    # the chunked-table kernels are on no pipeline's path now; their own
    # path is the public function without a cap (the JAX package's
    # default), one view a call, counted apart from the main path's
    _reset_launches()
    for _ in range(MAIN_PATH_CALLS):
        aggregate.rect_mean_aggregate(inputs[TEDDY]["vol_l"], inputs[TEDDY]["arms_l"])
    torch.cuda.synchronize()
    # the one-pass entry's own path: the sharded post's call, a pass a call
    x = inputs[TEDDY]
    for _ in range(MAIN_PATH_CALLS):
        post._fill_from_candidates(x["first"], x["occluded"], True, *x["caps"])
    torch.cuda.synchronize()
    own_path = {k: _launches()[k] for k in ("rect_mean_f32", "fill_pass_f32")}
    check(own_path == dict.fromkeys(own_path, MAIN_PATH_CALLS), own_path)
    with plain_bodies():
        plain_res = fn(lt, rt, full)
        kernels_plain = traced_events(lambda: fn(lt, rt, full), 1)
    kernels_now = traced_events(lambda: fn(lt, rt, full), 1)
    device = {label: {"kernels": sum(e.get("cat") == "kernel" for e in ev),
                      "device_events": sum(e.get("cat") in DEVICE_EVENTS for e in ev)}
              for label, ev in (("kernels", kernels_now), ("plain bodies", kernels_plain))}
    _, _, gt = make_pair(h, w, d, seed=0)
    equal = _maps_equal(res, plain_res)
    rec = {"phase": "agg_post", "part": "main path", "pipeline": "ad_census",
           "config": "FULL (entry())", "shape": [h, w], "disp_range": d,
           "launches": {k: v for k, v in launches.items() if v}, "calls": MAIN_PATH_CALLS,
           "arms_over_cap": over,
           "device_work_of_one_call": device, "maps_equal_to_plain_bodies": equal,
           "bad2_final": bad_pixel_rate(res.disp_final.cpu().numpy(), gt)}
    emit(rec)
    check(all(equal.values()), rec)
    check(rec["bad2_final"] <= MAX_BAD2, rec)
    del kernels_plain, kernels_now

    pipelines = {}
    for (h, w, d), x in inputs.items():
        lt, rt, cfg = x["lt"], x["rt"], x["cfg"]
        call = lambda: fn(lt, rt, cfg)  # noqa: E731
        with plain_bodies():
            plain_res = call()
            plain_ms = cuda_ms(call, AGG_POST_FULL_REPS)
        got = call()
        kernel_ms = cuda_ms(call, AGG_POST_FULL_REPS)
        with plain_bodies():
            plain_ms += cuda_ms(call, AGG_POST_FULL_REPS)
        kernel_ms += cuda_ms(call, AGG_POST_FULL_REPS)
        equal = _maps_equal(got, plain_res)
        lr = x["lr"]
        opt = scanline_cuda.scanline_optimize_cuda(x["agg_l"], lt, cfg.scanline)
        dl, dr = wta.wta(opt), wta.wta(x["agg_r"])
        filled = post.fill_holes_8dir(x["spk"], lr.occlusion, lr.mismatch, post.INVALID, d)
        stage_fns = {
            "cost": lambda: ad_census_cuda.ad_census_volumes_cuda(lt, rt, d),
            "arms (both images)": lambda: (aggregate.cross_arms(lt, cfg.arms),
                                           aggregate.cross_arms(rt, cfg.arms)),
            "rect mean (both views)": lambda: (
                aggregate.rect_mean_aggregate(x["vol_l"], x["arms_l"],
                                              max_span=cfg.arms.max_length),
                aggregate.rect_mean_aggregate(x["vol_r"], x["arms_r"],
                                              max_span=cfg.arms.max_length)),
            "scanline": lambda: scanline_cuda.scanline_optimize_cuda(x["agg_l"], lt,
                                                                      cfg.scanline),
            "wta (both)": lambda: (wta.wta(opt), wta.wta(x["agg_r"])),
            "lr_check_consistency": lambda: post.lr_check_consistency(dl, dr, cfg.lr_gate,
                                                                      post.INVALID),
            "remove_speckles": lambda: post.remove_speckles(
                lr.disp, cfg.speckle_diff, cfg.speckle_area, invalid_value=post.INVALID),
            "fill_holes_8dir": lambda: post.fill_holes_8dir(x["spk"], lr.occlusion,
                                                            lr.mismatch, post.INVALID, d),
            "median": lambda: post.median_filter(filled, cfg.median_size, "truncate"),
        }
        stages = {}
        for name, f in stage_fns.items():
            with plain_bodies():
                p = statistics.median(cuda_ms(f, 5))
            stages[name] = {"kernels_ms": statistics.median(cuda_ms(f, 5)), "plain_bodies_ms": p}
        rec = {"phase": "agg_post", "part": "timing_stages", "pipeline": "ad_census",
               "config": "FULL", "shape": [h, w], "disp_range": d,
               "pipeline_ms": statistics.median(kernel_ms), "ms_timed_calls": kernel_ms,
               "plain_bodies_pipeline_ms": statistics.median(plain_ms),
               "plain_bodies_ms_timed_calls": plain_ms,
               "mpixdisp_per_s": h * w * d / (statistics.median(kernel_ms) / 1e3) / 1e6,
               "stage_ms": stages, "maps_equal_to_plain_bodies": equal}
        emit(rec)
        check(all(equal.values()), rec)
        pipelines[f"{h}x{w}/D={d}"] = rec["pipeline_ms"]
        del got, plain_res, opt

    # sad, asw and cblsm with their post chains: the maps of the plain bodies
    h, w, d = TEDDY
    lt, rt = inputs[TEDDY]["lt"], inputs[TEDDY]["rt"]
    for name, cfg in (("sad", C.SADConfig(run_post=True)), ("asw", C.ASWConfig()),
                      ("cblsm", C.CBLSMConfig(run_post=True))):
        f = get_pipeline(name)[0]
        _reset_launches()
        got = f(lt, rt, cfg)
        torch.cuda.synchronize()
        launched = {k: v for k, v in _launches().items() if k in AGG_POST_ENTRIES and v}
        with plain_bodies():
            plain_res = f(lt, rt, cfg)
        equal = _maps_equal(got, plain_res)
        rec = {"phase": "agg_post", "part": "post chains", "pipeline": name, "shape": [h, w],
               "launches": launched, "maps_equal_to_plain_bodies": equal,
               "agree_with_plain_bodies": _agreement(got, plain_res, d)}
        emit(rec)
        check(launched.get("remove_speckles_f32", 0) == 1, rec)
        # cblsm's second rect-mean pass sums non-integer means, which the
        # kernel holds within a float32 ulp: its maps within the envelope
        check(all(equal.values()) if name != "cblsm"
              else min(rec["agree_with_plain_bodies"].values()) >= MIN_FINAL_AGREE, rec)
    del inputs
    torch.cuda.empty_cache()
    emit({"phase": "agg_post", "part": "done", "seconds": time.perf_counter() - start})

    h, w, d = TEDDY
    teddy = f"{h}x{w}/D={d}"
    serving = f"{SERVING[0]}x{SERVING[1]}/D={SERVING[2]}"
    return {entry: {"launches": counted[entry],
                    "launches_per_call": counted[entry] / MAIN_PATH_CALLS,
                    "max_abs_err": err[entry], "ms": timing[entry, teddy]["kernel_ms"],
                    "plain_ms": timing[entry, teddy]["plain_ms"],
                    "bound_ms": timing[entry, teddy]["bound_ms"],
                    "bound_by": timing[entry, teddy]["bound_by"], "library_ms": None,
                    "ms_covers": {"cross_arms_i32": "one image",
                                  "rect_mean_f32": "one view, no cap (on no pipeline's "
                                                   "path: launches 0 on ad_census FULL)",
                                  "rect_mean_walker_f32": "one view, the main path's cap",
                                  "fill_pass_f32": "one pass alone (the sharded post's call; "
                                                   "launches 0 on ad_census FULL)",
                                  "fill_holes_8dir_f32": "one fill_holes_8dir call (3 passes, "
                                                         "2 kernels each)",
                                  "remove_speckles_f32": "one call"}[entry],
                    **({"own_path_launches": own_path[entry],
                        "own_path": {"rect_mean_f32": "rect_mean_aggregate without max_span, "
                                                      "one view a call",
                                     "fill_pass_f32": "post._fill_from_candidates, the first "
                                                      "pass on FULL's map, a pass a call"}[entry]
                                    + f", {MAIN_PATH_CALLS} calls"}
                       if entry in own_path else {}),
                    "back_to_back_ms": timing[entry, teddy]["back_to_back_ms"],
                    **({"kernels_ms": timing[entry, teddy]["kernels_ms"]}
                       if "kernels_ms" in timing[entry, teddy] else {}),
                    "at_720p": timing[entry, serving],
                    "full_ms": pipelines}
            for entry in AGG_POST_ENTRIES}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tiled-rank"]:
        tiled_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
