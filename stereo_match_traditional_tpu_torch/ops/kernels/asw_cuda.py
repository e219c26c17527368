"""CUDA ASW cost volume: the counterpart of the JAX package's
``asw_volume_pallas`` (`ops/kernels/asw_pallas.py:293-324`).

The kernel (``csrc/asw_volume.cu``) computes the left view, without the
border triangle; ``ops.volume.asw_volume`` calls the launcher for CUDA
tensors, fills the triangle and takes the right view through the mirror
identity, as the Pallas wrapper does.  The launcher takes CUDA tensors
only: a CPU tensor raises ``ValueError``.
"""

from __future__ import annotations

import math

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import require_cuda, stream

# Kernel launches so far; a run resets it to show its path went through
# the kernel.  Only the launch below increments it.
LAUNCHES = 0


def asw_volume_left_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    radius: int,
    space_sigma: float,
    color_sigma: float,
    truncation: float,
) -> torch.Tensor:
    """The left view (`ASW/ASW.h:329-431`), one launch: float32 contiguous
    ``[H, W]`` CUDA images -> float32 ``[D, H, W]`` (columns x < d not yet
    border-filled); ``radius`` is ``win_size + 1``."""
    global LAUNCHES
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    for name, t in (("left", left), ("right", right)):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 2-D float32 tensor, got "
                f"{t.dtype} {tuple(t.shape)}"
            )
    if left.shape != right.shape:
        raise ValueError(f"left/right differ: {tuple(left.shape)} vs {tuple(right.shape)}")
    require_cuda(left=left, right=right)
    h, w = left.shape
    if h < 1 or w < 1 or disp_range < 1 or radius < 1:
        raise ValueError(f"empty problem: {h}x{w}, D={disp_range}, radius={radius}")
    lib = library()
    out = torch.empty((disp_range, h, w), dtype=torch.float32, device=left.device)
    with torch.cuda.device(left.device):
        err = lib.asw_volume_left_f32(
            left.data_ptr(), right.data_ptr(), out.data_ptr(), h, w, disp_range,
            radius, math.log2(math.e) / (2.0 * color_sigma**2),
            math.log2(math.e) / space_sigma**2, float(truncation), stream(left.device),
        )
    if err != 0:
        msg = lib.stereo_kernels_error_string(err).decode()
        raise RuntimeError(f"asw_volume_left_f32 launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out
