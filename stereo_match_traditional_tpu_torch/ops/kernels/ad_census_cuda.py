"""CUDA AD / Census / fused AD-Census cost volumes (``csrc/ad_census_cost.cu``).

Counterparts of ``ops.volume.ad_volume``, ``census_volume`` and
``ad_census_volume``, which are their plain versions.  Dispatch is by the
device of the inputs, never by a fallback: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops import volume

# Kernel launches so far (one per call of the C entry point, which runs the
# census kernel, except for the AD part, and the volume kernel); a run
# resets it to show its path went through the kernel.  Only the launch
# below increments it.
LAUNCHES = 0

_PARTS = {"cost": 0, "ad": 1, "census": 2}


def _launch(left, right, disp_range, rows, cols, sigma_c, sigma_s, view, part):
    """Raw launch on CUDA ``[H, W]`` images -> float32 [D, H, W]."""
    global LAUNCHES
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
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
    lf = left.to(torch.float32).contiguous()
    rf = right.to(torch.float32).contiguous()
    # census signatures of both images; the AD part computes none
    sig = torch.empty((2, h, w) if part != "ad" else (0,), dtype=torch.int64, device=lf.device)
    out = torch.empty((disp_range, h, w), dtype=torch.float32, device=lf.device)
    lib = library()
    with torch.cuda.device(lf.device):
        err = lib.ad_census_volume_f32(
            lf.data_ptr(), rf.data_ptr(), sig.data_ptr(), out.data_ptr(), h, w,
            disp_range, rows, cols, float(sigma_c), float(sigma_s),
            int(view == "right"), _PARTS[part], torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        msg = lib.stereo_kernels_error_string(err).decode()
        raise RuntimeError(f"ad_census_volume_f32 launch failed: {msg} ({err})")
    LAUNCHES += 1
    return out


def _on_cuda(left: torch.Tensor, right: torch.Tensor) -> bool:
    if left.is_cuda != right.is_cuda:
        raise ValueError(f"left on {left.device}, right on {right.device}")
    return left.is_cuda


def ad_census_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    sigma_c: float = 10.0,
    sigma_s: float = 30.0,
    census_rows: int = 9,
    census_cols: int = 7,
    view: str = "left",
) -> torch.Tensor:
    """Drop-in for ``ops.volume.ad_census_volume``: one launch per call for
    CUDA inputs, the plain version for CPU inputs."""
    if not _on_cuda(left, right):
        return volume.ad_census_volume(
            left, right, disp_range, sigma_c, sigma_s, census_rows, census_cols, view
        )
    return _launch(left, right, disp_range, census_rows, census_cols, sigma_c, sigma_s,
                   view, "cost")


def ad_volume_cuda(left, right, disp_range: int, view: str = "left") -> torch.Tensor:
    """Drop-in for ``ops.volume.ad_volume`` (the kernel's AD part)."""
    if not _on_cuda(left, right):
        return volume.ad_volume(left, right, disp_range, view)
    return _launch(left, right, disp_range, 1, 1, 1.0, 1.0, view, "ad")


def census_volume_cuda(
    left, right, disp_range: int, rows: int = 9, cols: int = 7, view: str = "left"
) -> torch.Tensor:
    """Drop-in for ``ops.volume.census_volume`` (the kernel's Hamming part)."""
    if not _on_cuda(left, right):
        return volume.census_volume(left, right, disp_range, rows, cols, view)
    return _launch(left, right, disp_range, rows, cols, 1.0, 1.0, view, "census")
