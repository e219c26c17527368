"""CUDA 8-direction hole fill and speckle removal (``csrc/post.cu``).

Counterparts of ``ops.post.fill_holes_8dir`` (and of one of its passes,
``ops.post._fill_from_candidates``) and ``ops.post.remove_speckles``,
whose private ``_plain`` bodies are their plain versions.  No Pallas kernel
stands behind them: they replace the XLA ops of the JAX package's
``fill_holes_8dir`` (`stereo_match_traditional_tpu/ops/post.py:658`) and
``remove_speckles`` (`:169`).  Dispatch is by the device of the inputs,
never by a fallback: CPU tensors take the plain version; CUDA tensors launch
the kernel or raise.  ``ops.post``'s public functions call these for CUDA
tensors.

Both are bit-exact with their plain versions: the fill selects among the
map's own values, and the speckle filter's output depends only on the
component areas, which any exact labelling gives.  The speckle kernel
labels to the fixpoint on the device, so the plain version's ``max_iters``
cap has no counterpart: an explicit cap below the plain version's default
raises rather than give another result.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current,
    raise_on_error,
    stream,
)

# Kernel launches so far, one per call of each C entry point (a
# fill_holes_8dir call is three: one a pass); a run resets them to show its
# path went through the kernels.  Only the launches below increment them.
LAUNCHES = {"fill_pass_f32": 0, "remove_speckles_f32": 0}


def _check_map(name: str, x: torch.Tensor, like: torch.Tensor = None) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name} must be [H, W], got {tuple(x.shape)}")
    if like is not None and (x.shape != like.shape or x.device != like.device):
        raise ValueError(f"{name} must be {tuple(like.shape)} on {like.device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    if x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"empty map: {tuple(x.shape)}")


def _mask(m: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    _check_map("mask", m, like)
    if m.dtype != torch.bool:
        raise ValueError(f"masks must be bool, got {m.dtype}")
    return m.contiguous()


def _caps(max_axis: Optional[int], max_diag: Optional[int], h: int, w: int):
    """The rays' step caps as the kernel takes them: None runs to the
    border (no ray has more than max(H, W) steps)."""
    if max_axis is None:
        return max(h, w), max(h, w)
    return max(int(max_axis), 0), max(int(max_diag), 0)


def _fill_pass(src, mask, raw, invalid, need_nonfinite, second, caps, finalize):
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    h, w = src.shape
    out = torch.empty_like(src)
    lib = library()
    with current(src.device):
        err = lib.fill_pass_f32(
            src.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(), h, w,
            int(raw), float(invalid), int(need_nonfinite), int(second), caps[0], caps[1],
            int(finalize), stream(src.device),
        )
    raise_on_error(lib, "fill_pass_f32", err)
    LAUNCHES["fill_pass_f32"] += 1
    return out


def fill_from_candidates_cuda(disp, target, second_smallest: bool, max_axis_steps,
                              max_diag_steps):
    """Drop-in for ``ops.post._fill_from_candidates`` (one pass of the fill
    on a float32 map, ``target`` the bool pixels to fill): one launch of
    ``fill_pass_f32`` for CUDA tensors, the plain version for CPU ones."""
    from stereo_match_traditional_tpu_torch.ops import post

    if not disp.is_cuda:
        return post._fill_from_candidates_plain(disp, target, second_smallest, max_axis_steps,
                                                max_diag_steps)
    _check_map("disp", disp)
    if disp.dtype != torch.float32:
        raise ValueError(f"disp must be float32, got {disp.dtype}")
    h, w = disp.shape
    return _fill_pass(disp.contiguous(), _mask(target, disp), False, float("inf"), False,
                      second_smallest, _caps(max_axis_steps, max_diag_steps, h, w), False)


def fill_holes_8dir_cuda(disp, occlusion, mismatch, invalid_value: float = float("inf"),
                         max_search: Optional[int] = None):
    """Drop-in for ``ops.post.fill_holes_8dir``: three launches of
    ``fill_pass_f32`` (occlusions, mismatches, what stays invalid) for CUDA
    tensors, the plain version for CPU ones.  The first pass reads
    ``invalid_value`` as +inf, the last writes it back."""
    from stereo_match_traditional_tpu_torch.ops import post

    if not disp.is_cuda:
        return post._fill_holes_8dir_plain(disp, occlusion, mismatch, invalid_value,
                                           max_search)
    _check_map("disp", disp)
    occlusion, mismatch = _mask(occlusion, disp), _mask(mismatch, disp)
    h, w = disp.shape
    max_axis = None if max_search is None else max(max_search - 1, 0)
    max_diag = None if max_search is None else int(round(max_axis * 0.70710678))
    caps = _caps(max_axis, max_diag, h, w)
    raw = disp.dtype == torch.float32
    if raw:     # the first pass maps invalid_value as it reads
        d = disp.contiguous()
    else:       # compared in disp's own dtype, as the plain version does
        d = torch.where(disp == invalid_value, float("inf"), disp.to(torch.float32))
    d = _fill_pass(d, occlusion, raw, invalid_value, True, True, caps, False)
    d = _fill_pass(d, mismatch, False, invalid_value, True, False, caps, False)
    return _fill_pass(d, None, False, invalid_value, True, False, caps, True)


def speckle_iteration_cap(h: int, w: int) -> int:
    """The plain version's default ``max_iters``: the JAX package's cap."""
    return 32 + 8 * max(1, (h * w - 1).bit_length())


def remove_speckles_cuda(
    disp: torch.Tensor,
    diff_insame: float = 1.0,
    min_speckle_area: int = 80,
    invalid_value: float = float("inf"),
    background: Optional[float] = None,
    max_iters: Optional[int] = None,
    connectivity: int = 8,
) -> torch.Tensor:
    """Drop-in for ``ops.post.remove_speckles`` (``block`` changes nothing
    there): one launch of ``remove_speckles_f32`` (four kernels: tile-local
    labels in shared memory, the links across tile borders, the tile roots'
    counts, the kill; no host round trip) for a CUDA map, the plain version
    for a CPU one.  The kernel labels to the fixpoint: an explicit
    ``max_iters`` below :func:`speckle_iteration_cap`, where the plain
    version could stop short of it, raises ``ValueError``."""
    from stereo_match_traditional_tpu_torch.ops import post

    if not disp.is_cuda:
        return post._remove_speckles_plain(disp, diff_insame, min_speckle_area, invalid_value,
                                           background, max_iters, connectivity)
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    _check_map("disp", disp)
    h, w = disp.shape
    cap = speckle_iteration_cap(h, w)
    if max_iters is not None and max_iters < cap:
        raise ValueError(
            f"remove_speckles(max_iters={max_iters}): the CUDA kernel labels to the fixpoint, "
            f"so a cap below the plain version's {cap} sweeps has no counterpart on the card")
    if h * w >= 2**31:
        raise ValueError(f"map too large for int32 labels: {h}x{w}")
    d = disp.to(torch.float32).contiguous()
    out = torch.empty_like(d)
    # 64-bit totals, then the labels and the tile roots' counts
    scratch = torch.empty(4 * h * w, dtype=torch.int32, device=d.device)
    # the area test in int32 (area < x iff area < ceil(x)): every area lies
    # in [0, H*W]
    min_area = int(min(max(math.ceil(min_speckle_area), -1), h * w + 1))
    lib = library()
    with current(d.device):
        err = lib.remove_speckles_f32(
            d.data_ptr(), out.data_ptr(), scratch.data_ptr(), h, w, float(invalid_value),
            float(diff_insame), min_area, int(connectivity == 8), int(background is not None),
            0.0 if background is None else float(background), stream(d.device),
        )
    raise_on_error(lib, "remove_speckles_f32", err)
    LAUNCHES["remove_speckles_f32"] += 1
    return out
