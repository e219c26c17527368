#!/usr/bin/env python3
"""Variants of the wide banded kernel, timed side by side on one card.

    python3 -m stereo_match_traditional_tpu_torch.tools.wide_variants OUT.json [VARIANTS.json]

Builds, beside the port's own library, one library a variant of
``csrc/scanline_banded.cu`` (with ``common.cu``): a copy of the source with
textual substitutions, ``{"name": [[old, new], ...]}``, each ``old`` found
exactly once.  The wrappers are pointed at each library in turn (by
replacing ``build.library``) and time, on the same seeded inputs, one
vertical pass (``_launch`` on a ``[D, H, W]`` volume's ``permute(1, 0, 2)``)
and both horizontal passes (``_rows``) of each family at SHAPES, with the
pipeline's own penalties (scales) of random images.  The default variants
take the kernel apart: as built; the movers off (no tile fetched or
written: the walkers' time); the walkers off (the movers' time); the lanes
of a vertical pass cut from 8 while the blocks number fewer than the SMs.
Each record gives the median ms of CUDA-event-timed calls and a SHA-256 of
the outputs (the variants that compute agree bit for bit; the ones with a
part off do not compute).  Writes every record to ``OUT.json``; prints one
line a shape and family.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SHAPES = [(300, 375, 450), (290, 1988, 2880)]
REPS = 5
VARIANTS = {
    "as built": [],
    "movers off": [["    if (in < ntiles) {\n      float* stage",
                    "    if (false) {\n      float* stage"],
                   ["    if (a.out == nullptr) return;\n    const float* stage",
                    "    return;\n    const float* stage"]],
    "walkers off": [["  auto walk = [&](int ti) {\n    if (!walks) return;\n    const int c",
                     "  auto walk = [&](int ti) {\n    return;\n    const int c"]],
    "lanes cut for the SMs": [["  int lb = lanes_inner ? 3 : 0;\n",
                               "  int lb = lanes_inner ? 3 : 0;\n  while (lanes_inner && lb > 0 && "
                               "((a.m_lanes + (1 << lb) - 1) >> lb) < sm_count) --lb;\n"]],
}


def build_variant(name: str, patches, build) -> Path:
    """The library of one variant, under the kernels' build directory."""
    source = (build.CSRC / "scanline_banded.cu").read_text()
    for old, new in patches:
        if source.count(old) != 1:
            raise ValueError(f"{name}: {old!r} is not in the source exactly once")
        source = source.replace(old, new)
    out = build.BUILD_DIR / "variants" / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    (out / "scanline_banded.cu").write_text(source)
    (out / "scanline_tiles.cuh").write_text((build.CSRC / "scanline_tiles.cuh").read_text())
    objs = []
    for src in (out / "scanline_banded.cu", build.CSRC / "common.cu"):
        obj = out / f"{src.stem}.o"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(out), "-c", "-o", str(obj),
                        str(src)], check=True, capture_output=True, text=True)
        objs.append(str(obj))
    lib = out / "libvariant.so"
    subprocess.run([build._nvcc(), *build.ARCH, "-shared", "-o", str(lib), *objs], check=True,
                   capture_output=True, text=True)
    return lib


def main(argv) -> int:
    if not argv:
        raise SystemExit(__doc__)
    import torch

    from stereo_match_traditional_tpu_torch.ops import scanline
    from stereo_match_traditional_tpu_torch.ops.kernels import build
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
    from stereo_match_traditional_tpu_torch.tools.banded_ab import _median_ms, _sha

    variants = json.loads(Path(argv[1]).read_text()) if len(argv) > 1 else VARIANTS
    own = build.library()
    with ThreadPoolExecutor(len(variants)) as pool:
        paths = dict(zip(variants, pool.map(lambda kv: build_variant(*kv, build),
                                            variants.items())))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for entry in (*banded.WIDE.values(), "stereo_kernels_error_string"):
            getattr(lib, entry).argtypes = getattr(own, entry).argtypes
            getattr(lib, entry).restype = getattr(own, entry).restype
        libs[name] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    records = []
    try:
        for d, h, w in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(d + h + w)
            vol = torch.rand((d, h, w), device="cuda", generator=g) * 20
            base, match = (torch.randint(0, 256, (h, w), device="cuda", generator=g,
                                         dtype=torch.uint8) for _ in range(2))
            for canonical in (False, True):
                a, b = (1.0, 3.0) if canonical else (0.5, 0.0)
                vert = (scanline.vertical_scales(d, base, match, 15.0, False)[:-1] if canonical
                        else scanline.vertical_p2(base, a, 4.0)[0])
                s = scanline.horizontal_scales(d, base, match, 15.0, False) if canonical else None
                lr, rl = (s[:-1], s[1:]) if canonical else scanline.horizontal_p2(base, a, 4.0)
                zero = (torch.zeros((d, w), device="cuda"), torch.zeros((w,), device="cuda"))
                calls = {
                    "vertical": lambda: banded._launch(canonical, vol.permute(1, 0, 2), vert,
                                                       zero, None, a, b, True, False, True)[:1],
                    "both horizontal": lambda: banded._rows(canonical, vol, lr, rl, a, b),
                }
                rec = {"shape": [d, h, w], "family": "canonical" if canonical else "legacy",
                       "card": smi, "variants": {}}
                for name, lib in libs.items():
                    build.library = lambda lib=lib: lib
                    rec["variants"][name] = {}
                    for label, call in calls.items():
                        out = call()
                        torch.cuda.synchronize()
                        sha = _sha(out)
                        del out
                        ms, times = _median_ms(call, REPS)
                        rec["variants"][name][label] = {"ms": ms, "ms_all": times, "sha256": sha}
                build.library = lambda: own
                print(json.dumps({k: rec[k] for k in ("shape", "family")} | {
                    n: {lbl: round(v["ms"], 3) for lbl, v in r.items()}
                    for n, r in rec["variants"].items()}), flush=True)
                records.append(rec)
                del vert, s, lr, rl
                torch.cuda.empty_cache()
            del vol
            torch.cuda.empty_cache()
    finally:
        build.library = lambda: own
        Path(argv[0]).write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
