"""CUDA windowed SAD and NCC cost volumes (``csrc/window_cost.cu``).

The launchers of ``ops.volume.sad_volume``, ``ops.volume.ncc_volume`` and
``ops.volume.ncc_sums``, which call them for CUDA tensors and run their
plain bodies for CPU tensors; the kernels replace the JAX package's
``volume.sad_volume`` (`stereo_match_traditional_tpu/ops/volume.py:224`)
and ``volume.ncc_volume`` (`:296`).  A launcher takes CUDA tensors only: a
CPU tensor raises ``ValueError``.

The kernels slide their sums (a column sum down the rows of a run, a window
sum along a short run of columns) instead of summing each window anew.
Exactness: for u8-valued inputs every partial sum is an integer below 2^24,
so SAD volumes (any radius the kernel takes), the four NCC window sums and
NCC volumes up to ``win_size`` 15 are bit-exact with the plain bodies.
Above that only the last, horizontal sums round (differences of ~1e-6,
held to 1e-5).  For non-integer inputs a sliding float32 sum carries its
roundings along the walk, which the kernel restarts every run of at most 24
rows and 8 columns: a sum of terms of one sign (SAD, the sums of squares)
stays within ``FLOAT_RTOL`` of the plain body's float64 sum, and a
signed sum (the NCC cross sums) within ``FLOAT_RTOL`` of the sum of its
terms' magnitudes.  Both images uint8 are read by the kernels as they are;
anything else is handed over as float32.

Colour: ``sad_volume_cuda(channel_min=True)`` takes ``[H, W, 3]`` pairs and
forms each term as ``min_c |L_c - R_c|`` in the same kernel (its
``channels = 3`` mode); both-u8 pairs are exact as the grey mode is, float32
pairs take radii up to ``MAX_RADIUS_RGBF``.  A sliding sum's partial sums are
sums over parts of the windows its walk passed, so a non-integer sum's
roundings are bounded by ``FLOAT_RTOL`` of the largest of those window sums:
for colour terms, which vary more between neighbouring windows than grey
ones, hold it to ``FLOAT_RTOL`` of the volume's largest value.

Border rule: a SAD output takes the window at the effective disparity ``min(d, j)`` (``min(d, W-1-j)`` for the right view) with reads
clamped into the image, which is ``border_fill`` of the padded box sum; the
NCC cross sum is zero outside the image and the volume holds the sentinel
where ``j - win_size - d < 0``.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current,
    kernel_inputs,
    raise_on_error,
    require_cuda,
    stream,
)

# Kernel launches so far, one per call of each C entry point; a run resets
# them to show its path went through the kernels.  Only the launches below
# increment them.
LAUNCHES = {"sad_volume_f32": 0, "ncc_volume_f32": 0}

# The widest strip a block holds is 128 columns of column sums, of which 2 *
# radius are halo: at radius 32 a block still writes 64 columns, from 169 KB
# of shared memory (two image bands of 24 + 2 * radius rows, the
# double-buffered tiles of column sums and window sums) of the 227 KB a block
# may take.  The kernels take any H, W and D >= 1.
MAX_RADIUS = 32
# float32 colour pairs stage three planes of each band: 226 KB of shared
# memory at radius 15, the most that fits
MAX_RADIUS_RGBF = 15
# What non-integer inputs are held to against the plain body (above): at
# most 2 * 24 + 65 + 16 roundings of half an ulp (2^-24) each, were they all
# of one sign.
FLOAT_RTOL = 1e-5


def _check(left, right, disp_range, radius, channel_min=False):
    """Raise ``ValueError`` for what the kernels do not take: a pair that is
    not ``[H, W]`` (``[H, W, 3]`` with ``channel_min``, and only then) on one
    device, an empty problem, a radius out of range (``MAX_RADIUS``, and
    ``MAX_RADIUS_RGBF`` for colour pairs that are not both uint8)."""
    want = 3 if channel_min else 2
    if (left.dim() != want or left.shape != right.shape or left.device != right.device
            or (channel_min and left.shape[-1] != 3)):
        layout = "[H, W, 3] (channel_min)" if channel_min else "[H, W]"
        raise ValueError(
            f"left/right must be {layout} on one device: {tuple(left.shape)} on "
            f"{left.device} vs {tuple(right.shape)} on {right.device}"
        )
    h, w = left.shape[:2]
    if h < 1 or w < 1 or disp_range < 1:
        raise ValueError(f"empty problem: {h}x{w}, D={disp_range}")
    u8 = left.dtype == right.dtype == torch.uint8
    limit = MAX_RADIUS_RGBF if channel_min and not u8 else MAX_RADIUS
    if not 1 <= radius <= limit:
        raise ValueError(f"window radius must be in [1, {limit}], got {radius}")


def sad_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    winsize: int,
    view: str = "left",
    mean: bool = False,
    channel_min: bool = False,
) -> torch.Tensor:
    """``ops.volume.sad_volume``: one launch of ``sad_volume_f32`` (one
    kernel writes the window sums and the border triangle; ``channel_min``
    its colour mode on ``[H, W, 3]`` pairs)."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    _check(left, right, disp_range, winsize + 1, channel_min)
    require_cuda(left=left, right=right)
    lk, rk, u8 = kernel_inputs(left, right)
    h, w = lk.shape[:2]
    out = torch.empty((disp_range, h, w), dtype=torch.float32, device=lk.device)
    lib = library()
    with current(lk.device):
        err = lib.sad_volume_f32(
            lk.data_ptr(), rk.data_ptr(), u8, out.data_ptr(), h, w, disp_range, winsize + 1,
            int(view == "right"), int(mean), 3 if channel_min else 1, stream(lk.device),
        )
    raise_on_error(lib, "sad_volume_f32", err)
    LAUNCHES["sad_volume_f32"] += 1
    return out


def _ncc_planes(like):
    """The ``[8, H, W]`` float32 scratch the sums kernel writes: ``sum_l,
    sum_l2, sum_r, sum_r2``, then the pairs ``(sum_l, var_l)`` and ``(sum_r,
    var_r)`` as the volume kernel reads them."""
    return torch.empty((8, *like.shape), dtype=torch.float32, device=like.device)


def ncc_sums_cuda(left: torch.Tensor, right: torch.Tensor, win_size: int):
    """The four window sums of ``ops.volume.ncc_sums`` (``sum_l, sum_l2,
    sum_r, sum_r2`` of the 128-centred images, zero-padded, float32
    ``[H, W]``): the sums kernel alone (``ncc_window_sums_f32``, the first of
    ``ncc_volume_f32``'s two kernels).  It is no launch of
    ``ncc_volume_f32`` and is not counted."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    _check(left, right, 1, win_size)
    require_cuda(left=left, right=right)
    lk, rk, u8 = kernel_inputs(left, right)
    planes = _ncc_planes(lk)
    h, w = lk.shape
    lib = library()
    with current(lk.device):
        err = lib.ncc_window_sums_f32(
            lk.data_ptr(), rk.data_ptr(), u8, planes.data_ptr(), h, w, win_size,
            stream(lk.device),
        )
    raise_on_error(lib, "ncc_window_sums_f32", err)
    return planes[:4].unbind(0)


def ncc_volume_cuda(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int,
    sentinel: float,
    eps: float = 1e-12,
    d_offset: int = 0,
) -> torch.Tensor:
    """The volume of ``ops.volume.ncc_volume``, ``sentinel`` where the right
    window would cross the left edge: one launch of ``ncc_volume_f32`` (the
    sums kernel, then the cross sums fused with the epilogue).  ``d_offset``
    builds the slice of global disparities ``d_offset .. d_offset +
    disp_range - 1``."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    _check(left, right, disp_range, win_size)
    if d_offset < 0:
        raise ValueError(f"d_offset must be >= 0, got {d_offset}")
    require_cuda(left=left, right=right)
    lk, rk, u8 = kernel_inputs(left, right)
    planes = _ncc_planes(lk)
    h, w = lk.shape
    out = torch.empty((disp_range, h, w), dtype=torch.float32, device=lk.device)
    lib = library()
    with current(lk.device):
        err = lib.ncc_volume_f32(
            lk.data_ptr(), rk.data_ptr(), u8, planes.data_ptr(), out.data_ptr(), h, w,
            disp_range, int(d_offset), win_size, float(eps), float(sentinel),
            stream(lk.device),
        )
    raise_on_error(lib, "ncc_volume_f32", err)
    LAUNCHES["ncc_volume_f32"] += 1
    return out
