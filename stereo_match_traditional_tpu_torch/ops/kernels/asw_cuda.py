"""CUDA ASW cost volume: the counterpart of the JAX package's
``asw_volume_pallas`` (`ops/kernels/asw_pallas.py:293-324`).

The kernel (``csrc/asw_volume.cu``) computes the left view; the right view
reuses it through the mirror identity, as the Pallas wrapper does.

Dispatch is by the device of the inputs, never by a fallback: CPU tensors
take the plain version ``ops.volume.asw_volume``; CUDA tensors launch the
kernel or raise.
"""

from __future__ import annotations

import math

import torch

from stereo_match_traditional_tpu_torch.ops import volume
from stereo_match_traditional_tpu_torch.ops.kernels.launch import stream

# Kernel launches so far; a run resets it to show its path went through
# the kernel.  Only the launch below increments it.
LAUNCHES = 0


def _launch_left(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    radius: int,
    space_sigma: float,
    color_sigma: float,
    truncation: float,
) -> torch.Tensor:
    """Raw left-view kernel launch: float32 contiguous [H, W] CUDA inputs
    -> float32 [D, H, W] (columns x < d not yet border-filled)."""
    global LAUNCHES
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    for name, t in (("left", left), ("right", right)):
        if not t.is_cuda or t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(
                f"{name} must be a contiguous 2-D float32 CUDA tensor, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    if left.shape != right.shape or left.device != right.device:
        raise ValueError(
            f"left/right differ: {tuple(left.shape)} on {left.device} vs "
            f"{tuple(right.shape)} on {right.device}"
        )
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


def asw_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    view: str = "left",
) -> torch.Tensor:
    """Drop-in for ``ops.volume.asw_volume`` (`ASW/ASW.h:329-431`): one
    kernel launch per call for CUDA inputs, the plain version for CPU
    inputs.  Inputs are uint8 or float32 ``[H, W]``."""
    if view not in ("left", "right"):
        raise ValueError(view)
    if not (left.is_cuda and right.is_cuda):
        if left.is_cuda or right.is_cuda:
            raise ValueError(f"left on {left.device}, right on {right.device}")
        return volume.asw_volume(
            left, right, disp_range, win_size, space_sigma, color_sigma,
            truncation, view,
        )
    lf = left.to(torch.float32).contiguous()
    rf = right.to(torch.float32).contiguous()
    if view == "right":
        lf, rf = torch.flip(rf, [1]), torch.flip(lf, [1])
    raw = _launch_left(
        lf, rf, disp_range, win_size + 1, space_sigma, color_sigma, truncation
    )
    vol = volume.border_fill(raw, "left")
    return torch.flip(vol, [2]) if view == "right" else vol
