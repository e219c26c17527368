"""CUDA 4-path scanline optimizer (``csrc/scanline.cu``).

The launcher of ``ops.scanline.scanline_optimize``, which calls it for CUDA
tensors and runs its plain body for CPU tensors.  The launcher takes CUDA
tensors only: a CPU tensor raises ``ValueError``.  Its route is chosen by D
alone: ``scanline_optimize_f32`` for D <= 256, four
launches of the wide banded kernel above (``scanline_banded_cuda.
scanline_optimize_composed``, counted in ``scanline_banded_cuda.LAUNCHES``).
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import ScanlineConfig
from stereo_match_traditional_tpu_torch.ops.kernels.launch import require_cuda, stream
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_banded_cuda import (
    scanline_optimize_composed,
)

# Kernel launches so far (one per call of the C entry point, which runs the
# horizontal and the two vertical kernels); a run resets it to show its path
# went through the kernel.  Only the launch below increments it (not the
# wide route above 256 disparities).
LAUNCHES = 0

MAX_DISP = 256           # scanline_optimize_f32: 8 values a walker lane; shared memory of a stage
MAX_VALUES = 2**32 - 1   # ... which keeps offsets into the volumes in 32 bits


def scanline_optimize_cuda(
    cost: torch.Tensor, gray: torch.Tensor, cfg: ScanlineConfig = ScanlineConfig()
) -> torch.Tensor:
    """``ops.scanline.scanline_optimize``: one launch of
    ``scanline_optimize_f32`` per call (D <= 256), or above 256 disparities
    the wide route (four launches of ``scanline_banded_wide_f32``, a
    contiguous result).

    ``scanline_optimize_f32`` reads ``cost`` d-major as it is and writes
    d-major volumes whose rows are padded to a multiple of 4 columns
    (16-byte rows); the result is the ``[D, H, W]`` view of such a volume,
    contiguous when ``W`` is a multiple of 4."""
    global LAUNCHES
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if cost.dim() != 3 or gray.shape != cost.shape[1:] or cost.device != gray.device:
        raise ValueError(
            f"cost must be [D, H, W] and gray [H, W] on one device, got "
            f"{tuple(cost.shape)} on {cost.device} and {tuple(gray.shape)} on {gray.device}"
        )
    d, h, w = cost.shape
    wp = -(-w // 4) * 4
    if d < 1 or h < 1 or w < 1:
        raise ValueError(f"scanline kernel takes a non-empty volume, got D={d}, {h}x{w}")
    require_cuda(cost=cost, gray=gray)
    p1, p2 = cfg.effective_penalties(d)
    if d > MAX_DISP:
        return scanline_optimize_composed(cost, gray, p1, p2, not cfg.faithful_vertical_l2,
                                           cfg.faithful_vertical_p2)
    if d * h * wp > MAX_VALUES:
        raise ValueError(f"scanline_optimize_f32 takes a volume below 2^32 values, got "
                         f"D={d}, {h}x{w}")
    c = cost.to(torch.float32).contiguous()          # d-major, as the pipeline holds it
    g = gray.to(torch.float32).contiguous()
    scratch = torch.empty((2, d, h, wp), dtype=torch.float32, device=c.device)  # rl and ud
    out = torch.empty((d, h, wp), dtype=torch.float32, device=c.device)
    lib = library()
    with torch.cuda.device(c.device):
        err = lib.scanline_optimize_f32(
            c.data_ptr(), g.data_ptr(), scratch.data_ptr(), out.data_ptr(), d, h, w,
            float(p1), float(p2), int(not cfg.faithful_vertical_l2),
            int(cfg.faithful_vertical_p2), stream(c.device),
        )
    if err != 0:
        msg = lib.stereo_kernels_error_string(err).decode()
        raise RuntimeError(f"scanline_optimize_f32 launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out[:, :, :w]
