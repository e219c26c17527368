"""End-to-end demo of the PyTorch/CUDA port: all five pipelines on a
synthetic stereo pair.

    python examples/demo_torch.py [--cpu] [--out-dir $TMPDIR/stereo_demo_torch]
                                  [--size 192x256] [--disp 32]

The port's counterpart of ``examples/demo.py``.  It generates a procedural
rectified pair with ground truth (the reference hard-codes Middlebury
Teddy files it does not ship), runs every pipeline with its reference
default configuration and the disparity range of ``--disp``, prints each
pipeline's bad-2.0 of ``disp_left``, and writes the min-max normalised
disparity images and each pipeline's stage checkpoint
(``utils.checkpoint.save_result``), plus ``summary.json`` with the exact
bad-2.0 values.  The images are PGM, written with the native host
library's codec (``utils.native.write_pnm``), so the demo needs no imageio.
It runs on the card unless ``--cpu`` asks for the CPU (the kernels' plain
versions); without a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_of(cpu: bool) -> str:
    """``cpu`` where asked for, else ``cuda``, which must be present."""
    import torch

    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on the CPU")
    return "cuda"


def main(argv=None) -> dict:
    """Run the demo; returns ``{pipeline: bad-2.0 of disp_left}``."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(), "stereo_demo_torch"))
    ap.add_argument("--size", default="192x256")
    ap.add_argument("--disp", type=int, default=32)
    args = ap.parse_args(argv)

    from stereo_match_traditional_tpu_torch.config import disp_override_kw
    from stereo_match_traditional_tpu_torch.models import PIPELINES, get_pipeline
    from stereo_match_traditional_tpu_torch.utils.checkpoint import save_result
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
    from stereo_match_traditional_tpu_torch.utils.io import normalize_u8
    from stereo_match_traditional_tpu_torch.utils.native import write_pnm
    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

    device = device_of(args.cpu)
    h, w = (int(x) for x in args.size.split("x"))
    left, right, gt = make_pair(h, w, args.disp, seed=0)
    lt, rt = pair_to_torch(left, right, device)
    os.makedirs(args.out_dir, exist_ok=True)
    write_pnm(os.path.join(args.out_dir, "left.pgm"), left)
    write_pnm(os.path.join(args.out_dir, "right.pgm"), right)

    print(f"{'pipeline':12s} {'bad-2.0':>8s}")
    bad2 = {}
    for name in sorted(PIPELINES):
        fn, cfg_cls = get_pipeline(name)
        cfg = cfg_cls(**disp_override_kw(cfg_cls, args.disp))
        res = fn(lt, rt, cfg)
        disp = res.disp_left.cpu().numpy()
        bad2[name] = bad_pixel_rate(disp, gt)
        print(f"{name:12s} {bad2[name]:8.3f}")
        write_pnm(os.path.join(args.out_dir, f"disp_{name}.pgm"), normalize_u8(disp))
        save_result(os.path.join(args.out_dir, f"stages_{name}"), res, {"pipeline": name})
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump({"device": device, "shape": [h, w], "disp": args.disp, "bad_2.0": bad2}, f)
    print(f"outputs -> {args.out_dir}")
    return bad2


if __name__ == "__main__":
    main()
