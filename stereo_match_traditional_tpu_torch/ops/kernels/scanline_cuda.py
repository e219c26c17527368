"""CUDA 4-path scanline optimizer (``csrc/scanline.cu``).

Counterpart of ``ops.scanline.scanline_optimize``, its plain version.
Dispatch is by the device of the inputs, never by a fallback: CPU tensors
take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.config import ScanlineConfig
from stereo_match_traditional_tpu_torch.ops import scanline
from stereo_match_traditional_tpu_torch.ops.kernels.launch import stream

# Kernel launches so far (one per call of the C entry point, which runs the
# horizontal and the two vertical kernels); a run resets it to show its path
# went through the kernel.  Only the launch below increments it.
LAUNCHES = 0

MAX_DISP = 256           # 8 values a lane in a walker warp; shared memory of a stage
MAX_VALUES = 2**32 - 1   # the kernel keeps offsets into the volumes in 32 bits


def scanline_optimize_cuda(
    cost: torch.Tensor, gray: torch.Tensor, cfg: ScanlineConfig = ScanlineConfig()
) -> torch.Tensor:
    """Drop-in for ``ops.scanline.scanline_optimize``: one launch per call
    for CUDA inputs, the plain version for CPU inputs.

    The kernel reads ``cost`` d-major as it is and writes d-major volumes
    whose rows are padded to a multiple of 4 columns (16-byte rows); the
    result is the ``[D, H, W]`` view of such a volume, contiguous when ``W``
    is a multiple of 4."""
    global LAUNCHES
    if cost.is_cuda != gray.is_cuda:
        raise ValueError(f"cost on {cost.device}, gray on {gray.device}")
    if not cost.is_cuda:
        return scanline.scanline_optimize(cost, gray, cfg)
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if cost.dim() != 3 or gray.shape != cost.shape[1:] or cost.device != gray.device:
        raise ValueError(
            f"cost must be [D, H, W] and gray [H, W] on one device, got "
            f"{tuple(cost.shape)} on {cost.device} and {tuple(gray.shape)} on {gray.device}"
        )
    d, h, w = cost.shape
    wp = -(-w // 4) * 4
    if not 1 <= d <= MAX_DISP or h < 1 or w < 1 or d * h * wp > MAX_VALUES:
        raise ValueError(f"scanline kernel takes 1 <= D <= {MAX_DISP} and a non-empty "
                         f"volume below 2^32 values, got D={d}, {h}x{w}")
    c = cost.to(torch.float32).contiguous()          # d-major, as the pipeline holds it
    g = gray.to(torch.float32).contiguous()
    p1, p2 = cfg.effective_penalties(d)
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
