"""Row halos (torch counterpart of
``stereo_match_traditional_tpu.parallel.halo``).

Aggregation windows (<= 25 px ASW, <= 34 px arms x passes, 4 px census
rows) need overlap between neighbouring row tiles: a tile is extended by
``halo`` rows from each neighbour (:func:`add_row_halo`, over a mesh axis)
and its own rows are then computed exactly as in the whole image;
:func:`crop_row_halo` drops them again.

The halo may exceed the tile's height (CBLSM's two aggregation passes need
68 rows where a 375-row image on 8 devices has 47-row tiles), so the
exchange runs ``ceil(halo / tile_rows)`` hops: hop k shifts whole tiles k
devices along the axis, and beyond the image a virtual tile repeats the
image's edge row: the ``BORDER_REPLICATE`` the reference applies to the
whole image (`SAD/SADmain.cpp:47-48`).
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.parallel import comm


def _shift(x: torch.Tensor, axis, edge_fix: torch.Tensor, down: bool) -> torch.Tensor:
    """Each rank receives the tile of the rank above it (``down``: idx - 1)
    or below it (idx + 1); the rank at the image's edge receives
    ``edge_fix`` (the virtual tile beyond the image).  One axis of world 1
    exchanges nothing."""
    n, idx = axis.size, axis.index
    edge = 0 if down else n - 1
    if n > 1:
        step = 1 if down else -1
        sends = [(x, idx + step)] if 0 <= idx + step < n else []
        recvs = [(x, idx - step)] if 0 <= idx - step < n else []
        got = comm.exchange(sends, recvs, axis)
        if idx != edge:
            return got[0]
    return edge_fix


def _shift_down(x: torch.Tensor, axis, edge_fix: torch.Tensor) -> torch.Tensor:
    """Each rank receives the tile of the rank above it (idx - 1); rank 0
    receives ``edge_fix``."""
    return _shift(x, axis, edge_fix, True)


def _shift_up(x: torch.Tensor, axis, edge_fix: torch.Tensor) -> torch.Tensor:
    """Each rank receives the tile of the rank below it (idx + 1); the last
    rank receives ``edge_fix``."""
    return _shift(x, axis, edge_fix, False)


def add_row_halo(x: torch.Tensor, halo: int, axis_name) -> torch.Tensor:
    """Extend this rank's row tile ``x`` [T, ...] with ``halo`` rows of each
    neighbour along ``axis_name`` (a :class:`parallel.mesh.MeshAxis`).

    Hop k delivers the tile k ranks away; beyond the image the virtual tiles
    repeat the global edge row, built hop by hop: the virtual tile above
    tile 0 is its first row repeated, and shifting that chain keeps every
    tile outside the image the edge row's replication.  Every rank of the
    axis calls it with the same ``halo`` and tile shape."""
    if halo <= 0:
        return x
    t = x.shape[0]
    hops = -(-halo // t)
    rep = (t,) + (1,) * (x.dim() - 1)
    above, cur = [], x
    for _ in range(hops):
        cur = _shift_down(cur, axis_name, cur[:1].repeat(rep))
        above.append(cur)
    below, cur = [], x
    for _ in range(hops):
        cur = _shift_up(cur, axis_name, cur[-1:].repeat(rep))
        below.append(cur)
    top = torch.cat(above[::-1])[-halo:]
    bottom = torch.cat(below)[:halo]
    return torch.cat([top, x, bottom])


def crop_row_halo(x: torch.Tensor, halo: int, axis: int = 0) -> torch.Tensor:
    """Drop ``halo`` rows from both ends of ``axis`` (a view)."""
    if halo <= 0:
        return x
    return x.narrow(axis, halo, x.shape[axis] - 2 * halo)
