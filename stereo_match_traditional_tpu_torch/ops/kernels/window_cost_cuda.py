"""CUDA windowed SAD and NCC cost volumes (``csrc/window_cost.cu``).

Counterparts of ``ops.volume.sad_volume`` and ``ops.volume.ncc_volume``,
which are their plain versions; the kernels replace the JAX package's
``volume.sad_volume`` (`stereo_match_traditional_tpu/ops/volume.py:224`)
and ``volume.ncc_volume`` (`:296`).  Dispatch is by the device of the
inputs, never by a fallback: CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.

Exactness: for u8-valued inputs every window sum is an integer below 2^24,
so SAD volumes (any radius the kernel takes) and NCC volumes up to
``win_size`` 15 are bit-exact with the plain versions; above that, or for
non-integer inputs, the float sums round in another order and agree within
a tolerance.  Border rule: a SAD output takes the window at the effective
disparity ``min(d, j)`` (``min(d, W-1-j)`` for the right view) with reads
clamped into the image, which is ``border_fill`` of the padded box sum; the
NCC cross sum is zero outside the image and the volume holds the sentinel
where ``j - win_size - d < 0``.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops import volume
from stereo_match_traditional_tpu_torch.ops.kernels.ad_census_cuda import _on_cuda

# Kernel launches so far, one per call of each C entry point; a run resets
# them to show its path went through the kernels.  Only the launches below
# increment them.
LAUNCHES = {"sad_volume_f32": 0, "ncc_volume_f32": 0}

MAX_RADIUS = 32  # shared memory: base tile, band and column sums, < 63 KB


def _check(left, right, disp_range, radius):
    if left.dim() != 2 or left.shape != right.shape or left.device != right.device:
        raise ValueError(
            f"left/right must be [H, W] on one device: {tuple(left.shape)} on "
            f"{left.device} vs {tuple(right.shape)} on {right.device}"
        )
    h, w = left.shape
    if h < 1 or w < 1 or disp_range < 1:
        raise ValueError(f"empty problem: {h}x{w}, D={disp_range}")
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"window radius must be in [1, {MAX_RADIUS}], got {radius}")


def _count_launch(lib, name, err):
    """Raise if the C entry point reported an error, else count the launch."""
    if err != 0:
        msg = lib.stereo_kernels_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({err})")
    LAUNCHES[name] += 1


def sad_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    winsize: int,
    view: str = "left",
    mean: bool = False,
    channel_min: bool = False,
) -> torch.Tensor:
    """Drop-in for ``ops.volume.sad_volume``: one launch of
    ``sad_volume_f32`` per call for CUDA inputs (the window sums, then the
    border triangle), the plain version for CPU inputs.  The kernel has no
    ``channel_min`` mode, so CUDA inputs with it raise."""
    if not _on_cuda(left, right):
        return volume.sad_volume(left, right, disp_range, winsize, view, mean, channel_min)
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if channel_min:
        raise NotImplementedError(
            "sad_volume_f32 has no channel_min mode "
            "(ROADMAP.md Queue 1 item 7, dormant variants)"
        )
    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    _check(left, right, disp_range, winsize + 1)
    lf = left.to(torch.float32).contiguous()
    rf = right.to(torch.float32).contiguous()
    h, w = lf.shape
    out = torch.empty((disp_range, h, w), dtype=torch.float32, device=lf.device)
    lib = library()
    with torch.cuda.device(lf.device):
        err = lib.sad_volume_f32(
            lf.data_ptr(), rf.data_ptr(), out.data_ptr(), h, w, disp_range, winsize + 1,
            int(view == "right"), int(mean), torch.cuda.current_stream().cuda_stream,
        )
    _count_launch(lib, "sad_volume_f32", err)
    return out


def ncc_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int,
    invalid_mode: str = "ignore",
    eps: float = 1e-12,
):
    """Drop-in for ``ops.volume.ncc_volume`` -> ``(volume, interior)``: the
    centred images and their four 2-D window sums in PyTorch, then one
    launch of ``ncc_volume_f32`` (cross sums fused with the epilogue) for
    CUDA inputs; the plain version for CPU inputs."""
    if not _on_cuda(left, right):
        return volume.ncc_volume(left, right, disp_range, win_size, invalid_mode, eps)
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    sentinel = volume._ncc_sentinel(invalid_mode)
    _check(left, right, disp_range, win_size)
    lf, rf, sums = volume.ncc_sums(left.contiguous(), right.contiguous(), win_size)
    h, w = lf.shape
    out = torch.empty((disp_range, h, w), dtype=torch.float32, device=lf.device)
    lib = library()
    with torch.cuda.device(lf.device):
        err = lib.ncc_volume_f32(
            lf.data_ptr(), rf.data_ptr(), *(s.data_ptr() for s in sums), out.data_ptr(),
            h, w, disp_range, win_size, float(eps), sentinel,
            torch.cuda.current_stream().cuda_stream,
        )
    _count_launch(lib, "ncc_volume_f32", err)
    return out, volume.ncc_interior_mask(h, w, win_size, lf.device)
