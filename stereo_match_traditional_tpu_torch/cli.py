"""Command-line entry point of the port, ``stereo-torch`` (the counterpart
of the JAX package's ``stereo``):

    python -m stereo_match_traditional_tpu_torch.cli run ad_census \
        --left im2.png --right im6.png --out disp.png --disp-range 60
    python -m stereo_match_traditional_tpu_torch.cli run asw --synthetic 375x450 \
        --save-stages stages/ --out-pfm disp.pfm
    python -m stereo_match_traditional_tpu_torch.cli eval ad_census --data middlebury/
    python -m stereo_match_traditional_tpu_torch.cli info

``run`` and ``eval`` run on the card; ``--cpu`` asks for the CPU (the plain
PyTorch versions of the kernels).  ``run --executor streamed [--row-tile N]``
runs the pipeline over sequential row bands (``parallel.run_streamed``), for
images whose whole-image volumes do not fit the card.  ``run --executor
tiled`` runs it over row tiles, one process a device
(``parallel.run_tiled``): under torchrun,

    torchrun --nproc-per-node 4 -m stereo_match_traditional_tpu_torch.cli \
        run ad_census --synthetic 720x1280 --disp-range 128 --executor tiled

every rank runs its tile and rank 0 writes the outputs; started alone it is
a world of one (NCCL on the card, gloo under ``--cpu``).  Any config dataclass
field can be overridden with ``--set field=value`` (repeatable); defaults are
the reference driver constants (config.py).  A ``--save-stages`` directory is
re-entered with ``models.registry.finish_from_volumes``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import typing

# Executors of the JAX package that the port does not have.
_EXECUTORS = {
    "gspmd": "has no torch counterpart (ROADMAP.md Queue 1 item 9: "
             "a sharded-input XLA program; it is not ported)",
}


def _coerce(key: str, val: str, typ):
    """Coerce a ``--set`` string to the field's *resolved* type.  Optional
    is unwrapped; bool is dispatched before int (bool is an int subclass,
    and ``--set run_post=1`` must become True, not the int 1)."""
    origin = typing.get_origin(typ)
    if origin is typing.Union:  # Optional[T] and friends
        members = [t for t in typing.get_args(typ) if t is not type(None)]
        if val.lower() in ("none", "null"):
            return None
        typ = members[0] if members else str
    if typ is bool:
        if val.lower() in ("true", "1", "yes", "on"):
            return True
        if val.lower() in ("false", "0", "no", "off"):
            return False
        raise SystemExit(f"--set {key}: expected a bool, got {val!r}")
    if typ is int:
        return int(val)
    if typ is float:
        return float(val)
    if typ is str:
        return val
    # nested config dataclasses etc.: passing the raw string through would
    # surface later as an opaque AttributeError inside the pipeline
    raise SystemExit(
        f"--set {key}: field type {getattr(typ, '__name__', typ)!r} cannot "
        "be parsed from the command line (only str/int/float/bool and "
        "'none' for Optional fields); construct nested configs in Python"
    )


def _parse_set(cfg_cls, overrides):
    hints = typing.get_type_hints(cfg_cls)
    fields = {f.name: f for f in dataclasses.fields(cfg_cls)}
    kw = {}
    for item in overrides or []:
        if "=" not in item:
            raise SystemExit(f"--set expects field=value, got {item!r}")
        key, val = item.split("=", 1)
        if key not in fields:
            raise SystemExit(
                f"unknown config field {key!r} for {cfg_cls.__name__}; "
                f"have {sorted(fields)}"
            )
        kw[key] = _coerce(key, val, hints.get(key, str))
    return kw


def _device(args) -> str:
    """The card, or the CPU under ``--cpu``; never the CPU in place of a
    missing card."""
    if args.cpu:
        return "cpu"
    import torch

    if not torch.cuda.is_available():
        raise SystemExit(
            f"stereo-torch {args.cmd}: no CUDA device (torch.cuda.is_available() is "
            "False); pass --cpu to run the plain PyTorch versions on the CPU"
        )
    return "cuda"


def _load_pair(args):
    from stereo_match_traditional_tpu_torch.utils import io as io_utils
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    if args.synthetic:
        if getattr(args, "gt", None):
            raise SystemExit("--gt is for file pairs; --synthetic has its own GT")
        h, w = (int(x) for x in args.synthetic.split("x"))
        left, right, gt = make_pair(h, w, args.disp_range or 60, seed=args.seed)
        return left, right, gt
    if not (args.left and args.right):
        raise SystemExit("provide --left/--right image paths or --synthetic HxW")
    left = io_utils.rgb_to_gray_u8(io_utils.imread(args.left))
    right = io_utils.rgb_to_gray_u8(io_utils.imread(args.right))
    gt = None
    if getattr(args, "gt", None):
        gt = io_utils.read_gt_disparity(args.gt, scale=args.gt_scale)
        if gt.shape != left.shape:
            raise SystemExit(
                f"--gt shape {gt.shape} does not match the pair {left.shape}"
            )
    return left, right, gt


def _build_cfg(args):
    """(pipeline_fn, cfg) from the shared pipeline/--set/--disp-range args."""
    from stereo_match_traditional_tpu_torch.config import disp_override_kw
    from stereo_match_traditional_tpu_torch.models import get_pipeline

    pipeline, cfg_cls = get_pipeline(args.pipeline)
    kw = _parse_set(cfg_cls, args.set)
    for field, val in disp_override_kw(cfg_cls, args.disp_range).items():
        kw.setdefault(field, val)  # an explicit --set wins
    return pipeline, cfg_cls(**kw)


def _metric_map(pipeline_name, res, disp):
    """The map to score against ground truth, plus a note (or None).

    ASW's faithful final map is the reference's *display* scale
    (cv::normalize to 0-255 before speckles, `ASWeight.cpp:69`), not
    disparity units: accuracy is measured on the raw WTA map.
    """
    if pipeline_name == "asw" and res.disp_final is not None:
        return res.disp_left.cpu().numpy(), "disp_left (disp_final is display-scaled)"
    return disp, None


def _bad_rate(metric_map, gt, thresh: float = 2.0):
    """bad-``thresh`` rate over the known-GT pixels (file GT marks unknown
    pixels NaN), or None when no pixel is known: an all-unknown map must
    read as no-data, not a perfect 0.0."""
    import numpy as np

    from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate

    finite = np.isfinite(gt)
    if not finite.any():
        return None
    valid = None if finite.all() else finite
    return round(bad_pixel_rate(metric_map, gt, thresh=thresh, valid=valid), 4)


def _final_map(res):
    disp = res.disp_final if res.disp_final is not None else res.disp_left
    return disp.cpu().numpy()


def _lab_inputs(args, cfg, device) -> dict:
    """``left_lab`` / ``right_lab`` for the ASW Lab variant, else nothing.
    It weights from the colour pair in OpenCV's 8-bit Lab encoding
    (`ASW/ASWeight.cpp:33-34` cvtColor(CV_BGR2Lab)): with ``--synthetic`` the
    colour pair of the same seed, else the files, which must be colour."""
    if args.pipeline != "asw" or getattr(cfg, "variant", "") != "lab":
        return {}
    import torch

    from stereo_match_traditional_tpu_torch.utils import io as io_utils

    if args.synthetic:
        from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

        h, w = (int(x) for x in args.synthetic.split("x"))
        lc, rc, _ = make_pair(h, w, args.disp_range or 60, seed=args.seed, color=True)
    else:
        lc = io_utils.imread(args.left)
        rc = io_utils.imread(args.right)
        if lc.ndim != 3 or rc.ndim != 3:
            raise SystemExit(
                "variant=lab needs COLOR input images (the Lab weights "
                "come from cvtColor(CV_BGR2Lab), ASWeight.cpp:33-34)"
            )
    return {"left_lab": torch.from_numpy(io_utils.rgb_to_lab_u8(lc)).to(device),
            "right_lab": torch.from_numpy(io_utils.rgb_to_lab_u8(rc)).to(device)}


def cmd_run(args) -> int:
    import numpy as np

    from stereo_match_traditional_tpu_torch.utils import io as io_utils
    from stereo_match_traditional_tpu_torch.utils.profiling import StageTimer, profile

    if args.executor in _EXECUTORS:
        raise SystemExit(f"--executor {args.executor} {_EXECUTORS[args.executor]}")
    if args.save_stages and args.executor != "direct":
        raise SystemExit("--save-stages requires --executor direct")
    device = _device(args)
    pipeline, cfg = _build_cfg(args)
    left, right, gt = _load_pair(args)
    rank = 0
    if args.executor == "tiled":
        import torch.distributed as dist

        from stereo_match_traditional_tpu_torch.parallel import distributed

        # before the pair goes to the card: NCCL picks each rank's card
        distributed.initialize(backend="gloo" if device == "cpu" else None)
        rank = dist.get_rank()

    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch

    lt, rt = pair_to_torch(left, right, device)
    pkw = _lab_inputs(args, cfg, device)
    timer = StageTimer()
    stages = None
    with profile(args.trace), timer.stage("pipeline"):
        if args.executor == "streamed":
            from stereo_match_traditional_tpu_torch.parallel import run_streamed

            res = run_streamed(args.pipeline, lt, rt, cfg, row_tile=args.row_tile,
                               aux=tuple(pkw.values()))
        elif args.executor == "tiled":
            from stereo_match_traditional_tpu_torch.parallel import run_tiled

            res = run_tiled(args.pipeline, lt, rt, cfg, aux=tuple(pkw.values()))
        elif args.save_stages:
            res, stages = pipeline(lt, rt, cfg, return_stages=True, **pkw)
        else:
            res = pipeline(lt, rt, cfg, **pkw)
        disp = _final_map(res)
    if rank != 0:      # every rank holds the whole result; rank 0 writes it
        return 0

    if args.save_stages:
        from stereo_match_traditional_tpu_torch.utils.checkpoint import save_array, save_result

        save_result(args.save_stages, res, meta={"pipeline": args.pipeline})
        for stage_name, arr in stages.items():
            save_array(args.save_stages, stage_name, arr)
        print(
            f"stages -> {args.save_stages} "
            f"(incl. {sorted(stages)} volumes; re-enter with "
            "models.registry.finish_from_volumes)",
            file=sys.stderr,
        )

    if args.out:
        io_utils.imwrite(args.out, io_utils.normalize_u8(disp))
        print(f"disparity -> {args.out}", file=sys.stderr)
    if args.out_pfm:
        # Raw float disparities (Middlebury submission format), unlike the
        # display-normalized --out PNG.
        io_utils.write_pfm(args.out_pfm, np.asarray(disp, dtype=np.float32))
        print(f"raw disparity -> {args.out_pfm}", file=sys.stderr)

    finite = np.isfinite(disp)
    summary = {
        "pipeline": args.pipeline,
        "device": device,
        "shape": list(disp.shape),
        "finite_fraction": float(finite.mean()),
        # null (not NaN: bare NaN is invalid JSON) when nothing is finite
        "disp_min": float(disp[finite].min()) if finite.any() else None,
        "disp_max": float(disp[finite].max()) if finite.any() else None,
    }
    if args.executor == "tiled":
        import torch.distributed as dist

        summary["world"] = dist.get_world_size()
    if gt is not None:
        metric_map, note = _metric_map(args.pipeline, res, disp)
        if note:
            summary["bad_2.0_map"] = note
        summary["bad_2.0"] = _bad_rate(metric_map, gt)
    summary.update(json.loads(timer.report()))
    print(json.dumps(summary))
    return 0


def cmd_eval(args) -> int:
    """Evaluate one pipeline over a dataset directory.

    Layout and defaults follow the Middlebury 2003 convention the
    reference hard-codes (`im2.png`/`im6.png` in every main, e.g.
    `SAD/SADmain.cpp:27-28`; ground truth `disp2.png` stores disparity*4
    with 0 = unknown).  ``--data`` may point at one scene directory or at
    a directory of scene directories (`teddy/`, `cones/`, ...).
    """
    import numpy as np

    from stereo_match_traditional_tpu_torch.utils import io as io_utils
    from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch

    device = _device(args)
    pipeline, cfg = _build_cfg(args)

    root = args.data
    if not os.path.isdir(root):
        raise SystemExit(f"--data {root!r} is not a directory")
    if os.path.exists(os.path.join(root, args.left_name)):
        scenes = [(os.path.basename(os.path.normpath(root)), root)]
    else:
        scenes = [
            (entry, os.path.join(root, entry))
            for entry in sorted(os.listdir(root))
            if os.path.exists(os.path.join(root, entry, args.left_name))
        ]
    if not scenes:
        raise SystemExit(f"no scene under {root!r} contains {args.left_name!r}")

    rows, rates = [], []
    for name, d in scenes:
        left = io_utils.rgb_to_gray_u8(io_utils.imread(os.path.join(d, args.left_name)))
        right = io_utils.rgb_to_gray_u8(io_utils.imread(os.path.join(d, args.right_name)))
        res = pipeline(*pair_to_torch(left, right, device), cfg)
        disp = _final_map(res)
        metric_map, _ = _metric_map(args.pipeline, res, disp)
        row = {"scene": name, "shape": list(disp.shape)}
        gt_path = os.path.join(d, args.gt_name)
        if os.path.exists(gt_path):
            gt = io_utils.read_gt_disparity(gt_path, scale=args.gt_scale)
            if gt.shape != metric_map.shape:
                raise SystemExit(
                    f"{name}: GT shape {gt.shape} != pair {metric_map.shape}"
                )
            # key matches cmd_run's "bad_2.0" for the default threshold
            rate = _bad_rate(metric_map, gt, args.thresh)
            row[f"bad_{args.thresh:.1f}"] = rate
            if rate is not None:  # all-unknown GT: reported null, not averaged
                rates.append(rate)
        rows.append(row)

    out = {"pipeline": args.pipeline, "device": device, "scenes": rows}
    if rates:
        out[f"mean_bad_{args.thresh:.1f}"] = round(float(np.mean(rates)), 4)
    print(json.dumps(out))
    return 0


def cmd_bench(args) -> int:
    raise SystemExit(
        "stereo-torch bench: the port has no throughput harness yet "
        "(ROADMAP.md Queue 1 item 8a, the torch bench)"
    )


def cmd_info(args) -> int:
    import torch

    from stereo_match_traditional_tpu_torch import __version__
    from stereo_match_traditional_tpu_torch.models import PIPELINES

    cuda = torch.cuda.is_available() and not args.cpu
    info = {
        "version": __version__,
        "pipelines": sorted(PIPELINES),
        "torch": torch.__version__,
        "backend": "cuda" if cuda else "cpu",
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if cuda else ["cpu"]),
    }
    print(json.dumps(info, indent=2))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="stereo-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--cpu", action="store_true",
        help="run on the CPU (the kernels' plain PyTorch versions); without "
        "it run and eval need a CUDA device",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run a stereo pipeline on an image pair")
    run.add_argument("pipeline")
    run.add_argument("--left")
    run.add_argument("--right")
    run.add_argument("--out")
    run.add_argument(
        "--out-pfm", metavar="PATH",
        help="also write the raw float disparity map as Middlebury PFM",
    )
    run.add_argument(
        "--gt", metavar="PATH",
        help="ground-truth disparity (PFM, or integer PNG/PGM) for bad-2.0",
    )
    run.add_argument(
        "--gt-scale", type=float, default=None,
        help="divide ground-truth values by this; default is the format's "
        "convention (1 for PFM, 4 for integer images: Middlebury 2003 "
        "Teddy/Cones PNGs store disparity*4)",
    )
    run.add_argument("--synthetic", help="HxW procedural pair with ground truth")
    run.add_argument(
        "--trace", metavar="DIR",
        help="write a torch.profiler Chrome trace of the run to DIR/trace.json "
        "(stages appear as stereo/<stage> ranges)",
    )
    run.add_argument("--seed", type=int, default=0)
    run.add_argument("--disp-range", type=int, default=None)
    run.add_argument("--set", action="append", metavar="FIELD=VALUE")
    run.add_argument("--save-stages", metavar="DIR")
    run.add_argument(
        "--executor", choices=("direct", "tiled", "streamed", "gspmd"),
        default="direct",
        help="direct = one pipeline call; tiled = row tiles over every process of "
        "the launch (torchrun; alone, a world of one); streamed = sequential row "
        "bands (memory-bounded, 4K-class images on one card); gspmd has no torch "
        "counterpart",
    )
    run.add_argument(
        "--row-tile", type=int, default=None,
        help="rows a band for --executor streamed (default: sized to the device's "
        "memory, parallel.streamed.auto_row_tile)",
    )
    run.set_defaults(func=cmd_run)

    ev = sub.add_parser(
        "eval", help="evaluate a pipeline over a dataset directory (bad-pixel rates)"
    )
    ev.add_argument("pipeline")
    ev.add_argument(
        "--data", required=True,
        help="a scene directory or a directory of scene directories",
    )
    ev.add_argument("--left-name", default="im2.png")
    ev.add_argument("--right-name", default="im6.png")
    ev.add_argument("--gt-name", default="disp2.png")
    ev.add_argument(
        "--gt-scale", type=float, default=None,
        help="divide ground-truth values by this; default is the format's "
        "convention (1 for PFM, 4 for integer images)",
    )
    ev.add_argument("--thresh", type=float, default=2.0, help="bad-pixel threshold")
    ev.add_argument("--disp-range", type=int, default=None)
    ev.add_argument("--set", action="append", metavar="FIELD=VALUE")
    ev.set_defaults(func=cmd_eval)

    bench = sub.add_parser("bench", help="the throughput harness (not ported yet)")
    bench.add_argument("--pipeline", default="ad_census")
    bench.set_defaults(func=cmd_bench)

    info = sub.add_parser("info", help="print framework/device info")
    info.set_defaults(func=cmd_info)

    args = ap.parse_args(argv)
    try:
        return args.func(args)
    except NotImplementedError as e:   # a configuration the port has not yet
        raise SystemExit(f"stereo-torch {args.cmd}: {e}") from e


if __name__ == "__main__":
    raise SystemExit(main())
