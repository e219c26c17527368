"""CUDA canonical AD-Census scanline (``csrc/scanline_canonical.cu``).

The launcher of ``ops.scanline.scanline_optimize_canonical``, which calls it
for CUDA tensors and runs its plain body for CPU tensors.  The launcher
takes CUDA tensors only: a CPU tensor raises ``ValueError``.  Its route is
chosen by D alone: ``scanline_canonical_f32`` for D <=
256, four launches of the wide banded kernel above
(``scanline_banded_cuda.scanline_canonical_composed``, counted in
``scanline_banded_cuda.LAUNCHES``).
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current, edge_bit_words, kernel_inputs, raise_on_error, require_cuda, stream,
)
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_banded_cuda import (
    scanline_canonical_composed,
)

# Kernel launches so far (one per call of the C entry point, which writes
# the edge bits and runs the four passes of one view, the last storing their
# mean); a run resets it to show its path went through the kernel.  Only the
# launch below increments it (not the wide route above 256 disparities).
LAUNCHES = 0

MAX_DISP = 256           # scanline_canonical_f32: 8 values a walker lane; shared memory of a stage
MAX_VALUES = 2**32 - 1   # ... which keeps offsets into the volumes in 32 bits


def scanline_optimize_canonical_cuda(
    cost: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    p1: float = 1.0,
    p2: float = 3.0,
    tso: float = 15.0,
    view: str = "left",
) -> torch.Tensor:
    """``ops.scanline.scanline_optimize_canonical``: one call of
    ``scanline_canonical_f32`` per view (D <= 256), or above 256 disparities
    the wide route (four launches of ``scanline_banded_wide_canonical_f32``,
    a contiguous result).

    ``cost`` is the view's d-major ``[D, H, W]`` volume, ``left`` / ``right``
    the gray images (read as they are when both are uint8, else as float32).
    ``scanline_canonical_f32`` writes d-major volumes whose rows are padded
    to a multiple of 4 columns (16-byte rows); the result is the float32
    ``[D, H, W]`` view of such a volume, contiguous when ``W`` is a multiple
    of 4."""
    global LAUNCHES
    devices = {t.device for t in (cost, left, right)}
    if len(devices) != 1:
        raise ValueError(f"cost, left and right must lie on one device, got "
                         f"{sorted(map(str, devices))}")
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    if cost.dim() != 3 or left.shape != cost.shape[1:] or right.shape != left.shape:
        raise ValueError(f"cost must be [D, H, W] and the images [H, W], got {tuple(cost.shape)}, "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    d, h, w = cost.shape
    wp = -(-w // 4) * 4
    if d < 1 or h < 1 or w < 1:
        raise ValueError(f"canonical scanline kernel takes a non-empty volume, got D={d}, "
                         f"{h}x{w}")
    require_cuda(cost=cost, left=left, right=right)
    if d > MAX_DISP:
        return scanline_canonical_composed(cost, left, right, p1, p2, tso, view)
    if d * h * wp > MAX_VALUES:
        raise ValueError(f"scanline_canonical_f32 takes a volume below 2^32 values, got "
                         f"D={d}, {h}x{w}")
    c = cost.to(torch.float32).contiguous()
    lf, rf, u8 = kernel_inputs(left, right)
    # rl and ud, [2, D, H, wp], then the edge bits
    scratch = torch.empty(2 * d * h * wp + edge_bit_words(h, w), dtype=torch.float32,
                          device=c.device)
    out = torch.empty((d, h, wp), dtype=torch.float32, device=c.device)
    lib = library()
    with current(c.device):
        err = lib.scanline_canonical_f32(
            c.data_ptr(), lf.data_ptr(), rf.data_ptr(), u8, scratch.data_ptr(), out.data_ptr(),
            d, h, w, float(p1), float(p2), float(tso), int(view == "right"), stream(c.device))
    raise_on_error(lib, "scanline_canonical_f32", err)
    LAUNCHES += 1
    return out[:, :, :w]
