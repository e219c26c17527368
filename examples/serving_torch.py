"""Serving demo of the PyTorch/CUDA port: stream disparity maps for a
directory of stereo pairs.

    python examples/serving_torch.py [--cpu] [--pipeline ad_census] [--batch 4]
        [--pairs 10] [--size 192x256] [--disp 32] [--out-dir DIR]
        [--loader native|python]
    torchrun --nproc-per-node 4 examples/serving_torch.py --batch 4 ...

The port's counterpart of ``examples/serving.py``.  It stages ``--pairs``
synthetic pairs as PGM files with the native host library's codec
(``utils.native.write_pnm``), decodes them ahead of the card with a pair
loader (``--loader native``: ``utils.native.PairLoader`` on C++ threads,
the default; ``--loader python``: ``utils.loader.PairLoader`` on Python
threads), streams them through ``models.batch.serve_pairs`` in batches of
``--batch``, writes each map min-max normalised as ``pair<i>_disp.pgm``
(the native codec again, so no imageio is needed) and prints pairs/s.
The pipeline runs its reference configuration at ``--disp``; a caller of
``main`` may pass another configuration of it as ``cfg``.

It runs on the card unless ``--cpu``; without a card and without ``--cpu``
it raises.  Under ``torchrun`` with a world above 1 and ``--batch`` a
multiple of it, every batch is split over a ``batch`` mesh of the ranks
(``parallel.make_mesh``; NCCL on the card, gloo with ``--cpu``): rank 0
stages the pairs and writes the maps, every rank decodes the same pairs.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

_EXAMPLES = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_EXAMPLES), _EXAMPLES]

from demo_torch import device_of  # noqa: E402


def main(argv=None, cfg=None) -> dict:
    """Serve the pairs with ``cfg``, a configuration of ``--pipeline``
    (default: its reference configuration at ``--disp``); returns what was
    served (pairs, seconds, pairs/s, the loader, the world and whether a
    mesh split the batches, and the paths of the staged pairs and of the
    written maps)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--pipeline", default="ad_census")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--size", default="192x256")
    ap.add_argument("--disp", type=int, default=32)
    ap.add_argument("--out-dir",
                    default=os.path.join(tempfile.gettempdir(), "stereo_serving_torch"))
    ap.add_argument("--loader", choices=("native", "python"), default="native")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from stereo_match_traditional_tpu_torch.config import disp_override_kw
    from stereo_match_traditional_tpu_torch.models import get_pipeline
    from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
    from stereo_match_traditional_tpu_torch.parallel import distributed, make_mesh
    from stereo_match_traditional_tpu_torch.utils import loader, native
    from stereo_match_traditional_tpu_torch.utils.io import normalize_u8
    from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

    device = device_of(args.cpu)
    h, w = (int(x) for x in args.size.split("x"))
    if cfg is None:
        cfg_cls = get_pipeline(args.pipeline)[1]
        cfg = cfg_cls(**disp_override_kw(cfg_cls, args.disp))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank, mesh = 0, None
    if world > 1:
        # before anything goes to the card: NCCL picks each rank's card
        distributed.initialize(backend="gloo" if args.cpu else None)
        rank = dist.get_rank()
        if args.batch % world == 0:
            mesh = make_mesh(world, ("batch",))

    # 1) stage a request set on disk
    os.makedirs(args.out_dir, exist_ok=True)
    paths = [(os.path.join(args.out_dir, f"pair{i:03d}_l.pgm"),
              os.path.join(args.out_dir, f"pair{i:03d}_r.pgm")) for i in range(args.pairs)]
    if rank == 0:
        for i, (lp, rp) in enumerate(paths):
            left, right, _ = make_pair(h, w, args.disp, seed=i)
            native.write_pnm(lp, left)
            native.write_pnm(rp, right)
    if world > 1:
        dist.barrier()

    # 2) decode ahead of the card, on the loader asked for
    if args.loader == "native":
        feed, src = native.PairLoader(paths, threads=4), "native threaded loader"
    else:
        feed, src = loader.PairLoader(paths, threads=4), "python threaded loader"

    # 3) stream the maps out
    written, n = [], 0
    t0 = time.perf_counter()
    for disp in serve_pairs(args.pipeline, feed, cfg, batch_size=args.batch, mesh=mesh,
                            device=device):
        if rank == 0:
            written.append(os.path.join(args.out_dir, f"pair{n:03d}_disp.pgm"))
            native.write_pnm(written[-1], normalize_u8(disp))
        n += 1
    dt = time.perf_counter() - t0
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    if rank == 0:
        print(f"{n} pairs via {src}, batch={args.batch}"
              f"{f', mesh of {world}' if mesh is not None else ''}: {dt:.2f} s wall "
              f"({n / dt:.1f} pairs/s incl. warm-up) -> {args.out_dir}")
    return {"pairs": n, "seconds": dt, "pairs_per_s": n / dt, "loader": args.loader,
            "world": world, "mesh": mesh is not None, "inputs": paths, "maps": written}


if __name__ == "__main__":
    main()
