"""CUDA canonical AD-Census scanline (``csrc/scanline_canonical.cu``).

Counterpart of ``ops.scanline.scanline_optimize_canonical``, its plain
version.  Dispatch is by the device of the inputs, never by a fallback: CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops import scanline
from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current, kernel_inputs, raise_on_error, stream,
)

# Kernel launches so far (one per call of the C entry point, which runs the
# four passes and their combination for one view); a run resets it to show
# its path went through the kernel.  Only the launch below increments it.
LAUNCHES = 0

MAX_DISP = 256   # 8 values a lane in a warp


def scanline_optimize_canonical_cuda(
    cost: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    p1: float = 1.0,
    p2: float = 3.0,
    tso: float = 15.0,
    view: str = "left",
) -> torch.Tensor:
    """Drop-in for ``ops.scanline.scanline_optimize_canonical``: one call of
    the C entry per view for CUDA inputs, the plain version for CPU inputs.

    ``cost`` is the view's d-major ``[D, H, W]`` volume, ``left`` / ``right``
    the gray images (read as they are when both are uint8, else as float32);
    the result is a contiguous float32 ``[D, H, W]``."""
    global LAUNCHES
    devices = {t.device for t in (cost, left, right)}
    if len(devices) != 1:
        raise ValueError(f"cost, left and right must lie on one device, got "
                         f"{sorted(map(str, devices))}")
    if not cost.is_cuda:
        return scanline.scanline_optimize_canonical(cost, left, right, p1, p2, tso, view)
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    if cost.dim() != 3 or left.shape != cost.shape[1:] or right.shape != left.shape:
        raise ValueError(f"cost must be [D, H, W] and the images [H, W], got {tuple(cost.shape)}, "
                         f"{tuple(left.shape)} and {tuple(right.shape)}")
    d, h, w = cost.shape
    if not 1 <= d <= MAX_DISP or h < 1 or w < 1:
        raise ValueError(f"canonical scanline kernel takes 1 <= D <= {MAX_DISP} and a "
                         f"non-empty image, got D={d}, {h}x{w}")
    c = cost.to(torch.float32).contiguous()
    lf, rf, u8 = kernel_inputs(left, right)
    scratch = torch.empty((3, d, h, w), dtype=torch.float32, device=c.device)  # rl, ud, du
    out = torch.empty((d, h, w), dtype=torch.float32, device=c.device)
    lib = library()
    with current(c.device):
        err = lib.scanline_canonical_f32(
            c.data_ptr(), lf.data_ptr(), rf.data_ptr(), u8, scratch.data_ptr(), out.data_ptr(),
            d, h, w, float(p1), float(p2), float(tso), int(view == "right"), stream(c.device))
    raise_on_error(lib, "scanline_canonical_f32", err)
    LAUNCHES += 1
    return out
