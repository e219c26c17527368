"""Row halos of a band (torch counterpart of
``stereo_match_traditional_tpu.parallel.halo``).

A band of rows is extended by ``halo`` rows on each side so that its own
rows are computed exactly as in the whole image; :func:`crop_row_halo` drops
them again.  The exchange of halos between devices (``add_row_halo``) comes
with the tiled executor (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

import torch


def crop_row_halo(x: torch.Tensor, halo: int, axis: int = 0) -> torch.Tensor:
    """Drop ``halo`` rows from both ends of ``axis`` (a view)."""
    if halo <= 0:
        return x
    return x.narrow(axis, halo, x.shape[axis] - 2 * halo)
