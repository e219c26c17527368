"""Batched execution and a pipelined serving loop, the counterparts of
``stereo_match_traditional_tpu.models.batch``.

The reference processes exactly one hard-coded pair per run
(`SAD/SADmain.cpp:27-28` et al.).  For serving, the port runs a batch pair
by pair on the card and stacks every result field along axis 0, and a
pair loader decodes the pairs ahead while the card runs:
`utils.native.PairLoader` on C++ threads, or `utils.loader.PairLoader` on
Python threads.  With a mesh, the batch is split over the ranks of its
``batch`` axis (one process a device, ``parallel.mesh``), each rank runs its
share and the results are gathered: batch data parallelism, no collective
but the gather.
"""

from __future__ import annotations

import itertools
from typing import Iterable, Iterator, Tuple

import numpy as np
import torch

from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.models.registry import get_pipeline
from stereo_match_traditional_tpu_torch.utils.profiling import count, span


def batched_pipeline(name: str, cfg=None, method: str = "map",
                     mesh=None, axis_name: str = "batch"):
    """``(left [B, H, W], right [B, H, W]) -> StereoResult`` with every
    result field stacked along axis 0.

    The batch runs pair by pair on the device of its tensors, so each map
    is the single-pair call's, bit for bit.  ``method`` takes the JAX
    package's values, ``'map'`` and ``'vmap'``, and both run that loop:
    there the choice was a TPU one (`lax.map` kept each example's gather
    source in the v5e's fast memory, where `vmap` batched it past a cliff),
    with nothing to choose between on the card.

    ``mesh``: a ``DeviceMesh`` whose ``axis_name`` axis shards the batch
    (every rank calls ``run`` with the whole batch, runs its contiguous
    share and returns the gathered result); the batch must be a multiple of
    the axis' ranks.  The maps are the unsharded run's, bit for bit.  A
    rank outside the mesh (one over the first ranks of a larger world) gets
    None, before any collective."""
    if method not in ("map", "vmap"):
        raise ValueError(f"method must be 'map' or 'vmap': {method}")
    fn, cfg_cls = get_pipeline(name)
    if cfg is None:
        cfg = cfg_cls()

    def run(ls: torch.Tensor, rs: torch.Tensor) -> StereoResult:
        if ls.shape != rs.shape or ls.dim() != 3:
            raise ValueError(
                f"batches must be [B, H, W] of one shape, got {tuple(ls.shape)} and "
                f"{tuple(rs.shape)}")
        results = [fn(ls[k], rs[k], cfg) for k in range(ls.shape[0])]
        return StereoResult(*(None if fields[0] is None else torch.stack(fields)
                              for fields in zip(*results)))

    if mesh is None:
        return run
    from stereo_match_traditional_tpu_torch.parallel import comm
    from stereo_match_traditional_tpu_torch.parallel.mesh import MeshAxis, in_mesh

    def sharded(ls: torch.Tensor, rs: torch.Tensor) -> StereoResult:
        if not in_mesh(mesh):
            return None
        axis = MeshAxis(mesh, axis_name)
        n = axis.size
        if ls.shape[0] % n:
            raise ValueError(
                f"batch {ls.shape[0]} must divide the {axis_name} axis ({n});"
                " serve_pairs pads partial batches"
            )
        b = ls.shape[0] // n
        share = slice(axis.index * b, (axis.index + 1) * b)
        res = run(ls[share], rs[share])
        return StereoResult(*(None if f is None else comm.all_gather(f, axis).flatten(0, 1)
                              for f in res))

    return sharded


def serve_pairs(
    name: str,
    pairs: Iterable[Tuple[np.ndarray, np.ndarray]],
    cfg=None,
    batch_size: int = 1,
    mesh=None,
    device="cuda",
) -> Iterator[np.ndarray]:
    """Stream disparity maps (``disp_final``, else ``disp_left``, as NumPy
    arrays) for an iterable of ``(left, right)`` uint8 pairs: one map a
    pair, in order, the last batch partial where the pairs run out.

    Each batch is uploaded with a plain copy: a Teddy pair is 2 x 169 KB,
    and a copy stream with pinned staging measured no faster on the card
    (PERF.md).  Pass a pair loader as ``pairs`` to decode the pairs
    ahead while the card runs: `utils.native.PairLoader` (C++ threads) or
    `utils.loader.PairLoader` (Python threads).  ``device`` is the card
    unless the caller asks for the CPU.  With ``mesh`` each batch is split over its
    ``batch`` axis (:func:`batched_pipeline`; every rank iterates the same
    pairs and yields every map), ``batch_size`` a multiple of the axis'
    ranks, and a partial last batch is padded with its last pair, whose
    maps are dropped; a rank outside the mesh yields nothing.

    Each batch is five :func:`utils.profiling.span` s, all with ``pair=``
    the stream index of its first pair: ``stereo/serve_next`` (taking the
    pairs from ``pairs``), ``stereo/serve_upload`` (stacking and copying
    them to ``device``), ``stereo/serve_run`` (the pipeline's enqueue),
    ``stereo/serve_wait`` (the card's stream drained; on a card only) and
    ``stereo/serve_download`` (the maps copied to the host); and three
    counters: ``serve.pairs``, ``serve.bytes_up`` and ``serve.bytes_down``.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if mesh is not None:
        from stereo_match_traditional_tpu_torch.parallel.mesh import in_mesh

        if not in_mesh(mesh):
            return
    run = batched_pipeline(name, cfg, mesh=mesh)
    on_card = torch.device(device).type == "cuda"
    it = iter(pairs)
    first = 0                                       # the stream index of the batch's first pair
    while True:
        with span("stereo/serve_next", pair=first):
            batch = list(itertools.islice(it, batch_size))
        if not batch:
            return
        n = len(batch)
        if mesh is not None:
            batch += batch[-1:] * (batch_size - n)
        with span("stereo/serve_upload", pair=first):
            ls, rs = (torch.from_numpy(np.stack(side)).to(device) for side in zip(*batch))
        with span("stereo/serve_run", pair=first):
            res = run(ls, rs)
            disp = res.disp_final if res.disp_final is not None else res.disp_left
        if on_card:
            with span("stereo/serve_wait", pair=first):
                torch.cuda.current_stream(disp.device).synchronize()
        with span("stereo/serve_download", pair=first):
            maps = disp[:n].cpu().numpy()
        count("serve.pairs", n)
        count("serve.bytes_up", ls.nbytes + rs.nbytes)
        count("serve.bytes_down", maps.nbytes)
        first += n
        yield from maps
