"""CUDA AD / Census / fused AD-Census cost volumes (``csrc/ad_census_cost.cu``).

Counterparts of ``ops.volume.ad_volume``, ``census_volume``,
``ad_census_volume`` and of the both-view ``ad_volumes`` and
``ad_census_volumes``, which are their plain versions.  Dispatch is by the
device of the inputs, never by a fallback: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.

One call of the C entry ``ad_census_volume_f32`` computes the census of
both images once and writes the left view, the right view or both: each
value is computed once and stored to both views.  Both images uint8 are
read as they are (the exponentials then come from tables, bit for bit the
direct formula); anything else is handed over as float32.

``row_offset`` / ``global_rows`` place the images as a band of rows in a
larger image for the census, as the plain ``ops.volume.census_transform``
does (the row executors, ``parallel``): the C entry's row window.
``d_offset`` builds the slice of global disparities ``d_offset ..
d_offset + disp_range - 1`` of either view, as the plain versions do (the
``(tile, disp)`` runners): the C entry's disparity slice, both views still
from one launch.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops import volume
from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current,
    kernel_inputs,
    on_cuda,
    raise_on_error,
    stream,
)

# Kernel launches so far (one per call of the C entry point, which runs the
# census kernel, except for the AD part, and the volume kernel); a run
# resets it to show its path went through the kernel.  Only the launch
# below increments it.
LAUNCHES = 0

_PARTS = {"cost": 0, "ad": 1, "census": 2}
_VIEWS = ("left", "right", "both")
# The cost kernel's grid puts the rows on its z axis
MAX_ROWS = 65535


def _launch(left, right, disp_range, rows, cols, sigma_c, sigma_s, view, part,
            row_offset=0, global_rows=None, d_offset=0):
    """Raw launch on CUDA ``[H, W]`` images -> float32 ``[D, H, W]`` for
    ``view`` 'left' or 'right', ``(vol_l, vol_r)`` for 'both': two views of
    one storage, which lives as long as either of them.  The images are rows
    ``row_offset..`` of an image of ``global_rows`` rows (default: ``H``)."""
    global LAUNCHES
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if view not in _VIEWS:
        raise ValueError(f"view must be one of {_VIEWS}, got {view!r}")
    if left.dim() != 2 or left.shape != right.shape or left.device != right.device:
        raise ValueError(
            f"left/right must be [H, W] on one device: {tuple(left.shape)} on "
            f"{left.device} vs {tuple(right.shape)} on {right.device}"
        )
    if rows * cols > 63:
        raise ValueError(f"census window {rows}x{cols} needs more than 63 bits")
    h, w = left.shape
    if h < 1 or w < 1 or disp_range < 1:
        raise ValueError(f"empty problem: {h}x{w}, D={disp_range}")
    if h > MAX_ROWS:
        raise ValueError(f"{h} rows: the kernel takes at most {MAX_ROWS}")
    if global_rows is None:
        global_rows = h
    if global_rows < 1:
        raise ValueError(f"global_rows must be >= 1, got {global_rows}")
    if d_offset < 0:
        raise ValueError(f"d_offset must be >= 0, got {d_offset}")
    if not left.is_cuda:
        raise ValueError(f"the kernel needs CUDA tensors, got {left.device}")
    lk, rk, u8 = kernel_inputs(left, right)
    # The views written share one allocation (one allocation less of host
    # time beside a ~0.05 ms kernel): a view keeps the other's memory alive.
    # The census scratch is a temporary of its own: the signatures of both
    # images (int64 [2, H, W]), then the two exponential tables (320 floats
    # as 160 int64); the AD part needs none of it.
    n = disp_range * h * w
    views = 2 if view == "both" else 1
    buf = torch.empty(views * n, dtype=torch.float32, device=lk.device)
    sig = (torch.empty(2 * h * w + 160, dtype=torch.int64, device=lk.device)
           if part != "ad" else None)
    ptr = buf.data_ptr()
    lib = library()
    with current(lk.device):
        err = lib.ad_census_volume_f32(
            lk.data_ptr(), rk.data_ptr(), u8, sig.data_ptr() if sig is not None else None,
            ptr if view != "right" else None, ptr + 4 * n * (views - 1) if view != "left" else None,
            h, w, int(row_offset), int(global_rows), disp_range, int(d_offset), rows, cols,
            float(sigma_c),
            float(sigma_s), _PARTS[part],
            stream(lk.device),
        )
    raise_on_error(lib, "ad_census_volume_f32", err)
    LAUNCHES += 1
    vols = buf.view(views, disp_range, h, w)
    return (vols[0], vols[1]) if view == "both" else vols[0]


def _single(view: str) -> str:
    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    return view


def ad_census_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    sigma_c: float = 10.0,
    sigma_s: float = 30.0,
    census_rows: int = 9,
    census_cols: int = 7,
    view: str = "left",
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
) -> torch.Tensor:
    """Drop-in for ``ops.volume.ad_census_volume``: one launch per call for
    CUDA inputs, the plain version for CPU inputs."""
    if not on_cuda(left, right):
        return volume.ad_census_volume(
            left, right, disp_range, sigma_c, sigma_s, census_rows, census_cols, view,
            row_offset, global_rows, d_offset,
        )
    return _launch(left, right, disp_range, census_rows, census_cols, sigma_c, sigma_s,
                   _single(view), "cost", row_offset, global_rows, d_offset)


def ad_census_volumes_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    sigma_c: float = 10.0,
    sigma_s: float = 30.0,
    census_rows: int = 9,
    census_cols: int = 7,
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
):
    """Both views ``(vol_l, vol_r)`` of ``ops.volume.ad_census_volumes``:
    one launch for CUDA inputs, the plain version for CPU inputs."""
    if not on_cuda(left, right):
        return volume.ad_census_volumes(
            left, right, disp_range, sigma_c, sigma_s, census_rows, census_cols,
            row_offset, global_rows, d_offset,
        )
    return _launch(left, right, disp_range, census_rows, census_cols, sigma_c, sigma_s,
                   "both", "cost", row_offset, global_rows, d_offset)


def ad_volume_cuda(left, right, disp_range: int, view: str = "left",
                   d_offset: int = 0) -> torch.Tensor:
    """Drop-in for ``ops.volume.ad_volume`` (the kernel's AD part)."""
    if not on_cuda(left, right):
        return volume.ad_volume(left, right, disp_range, view, d_offset)
    return _launch(left, right, disp_range, 1, 1, 1.0, 1.0, _single(view), "ad",
                   d_offset=d_offset)


def ad_volumes_cuda(left, right, disp_range: int):
    """Both views ``(vol_l, vol_r)`` of ``ops.volume.ad_volumes`` (the
    kernel's AD part): one launch for CUDA inputs."""
    if not on_cuda(left, right):
        return volume.ad_volumes(left, right, disp_range)
    return _launch(left, right, disp_range, 1, 1, 1.0, 1.0, "both", "ad")


def census_volume_cuda(
    left, right, disp_range: int, rows: int = 9, cols: int = 7, view: str = "left",
    row_offset: int = 0, global_rows: int = None, d_offset: int = 0,
) -> torch.Tensor:
    """Drop-in for ``ops.volume.census_volume`` (the kernel's Hamming part)."""
    if not on_cuda(left, right):
        return volume.census_volume(left, right, disp_range, rows, cols, view, row_offset,
                                    global_rows, d_offset)
    return _launch(left, right, disp_range, rows, cols, 1.0, 1.0, _single(view), "census",
                   row_offset, global_rows, d_offset)
