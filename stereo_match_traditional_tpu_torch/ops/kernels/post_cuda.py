"""CUDA 8-direction hole fill and speckle removal (``csrc/post.cu``) and
iterative region voting (``csrc/region_voting.cu``).

The launchers of ``ops.post.fill_holes_8dir`` (and of one of its passes,
``ops.post._fill_from_candidates``), ``ops.post.remove_speckles`` and
``ops.post.iterative_region_voting``, which call them for CUDA tensors and
run their private ``_plain`` bodies for CPU tensors.  No Pallas kernel
stands behind them: they replace the XLA ops of the JAX package's
``fill_holes_8dir`` (`stereo_match_traditional_tpu/ops/post.py:658`),
``remove_speckles`` (`:169`) and ``iterative_region_voting`` (`:886`).  A
launcher takes CUDA tensors only: a CPU tensor raises ``ValueError``.

The fill's kernels search bitsets of the map's finite pixels along its
rows, columns, diagonals and anti-diagonals, not the map itself, a thread a
target from a compacted list (``csrc/post.cu``'s header).  Both are
bit-exact with their plain bodies: the fill selects among the map's own
values, and the speckle filter's output depends only on the component
areas, which any exact labelling gives.  The speckle kernel
labels to the fixpoint on the device, so the plain body's ``max_iters``
cap has no counterpart: an explicit cap below the plain body's default
raises rather than give another result.  The voting counts each invalid
pixel's region in a histogram of its own, integers in any order, and
decides by the plain body's float32 tests: bit for bit too.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current,
    raise_on_error,
    require_cuda,
    stream,
)
from stereo_match_traditional_tpu_torch.utils import profiling

# Kernel launches so far, one per call of each C entry point (a
# fill_holes_8dir call is one of fill_holes_8dir_f32: three passes, each the
# tile kernel and the search kernel); a run resets them to show its path
# went through the kernels.  Only the launches below increment them.
LAUNCHES = {"fill_pass_f32": 0, "fill_holes_8dir_f32": 0, "remove_speckles_f32": 0,
            "region_voting_f32": 0}

# The voting's bins are int16 (-1 for a pixel that votes in none) and its
# spans two uint16 columns: the disparities and the widths it takes.
VOTE_MAX_DISPARITIES = 32767
VOTE_MAX_WIDTH = 65536


def fill_bits_words(h: int, w: int) -> int:
    """The 32-bit words of a fill pass's bitsets (``csrc/post.cu``'s
    ``FillBits``): the rows, ceil(w / 32) words each, then ceil(h / 32)
    words of each column, diagonal and anti-diagonal (h + w - 1 of each)."""
    return h * -(-w // 32) + -(-h // 32) * (w + 2 * (h + w - 1))


def fill_scratch_words(h: int, w: int, maps: int = 0) -> int:
    """A fill call's scratch in 32-bit words: the bitsets, four target
    counts, a target index a pixel at most, and ``maps`` float32 maps (one
    for the three-pass entry)."""
    return fill_bits_words(h, w) + 4 + (1 + maps) * h * w


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


def _scratch(like: torch.Tensor, maps: int = 0) -> torch.Tensor:
    """Scratch for a call's bitsets and target list (its passes share it:
    each rebuilds it on the stream before its search reads it)."""
    h, w = like.shape
    if h * w >= 2**31:
        raise ValueError(f"map too large for int32 target indices: {h}x{w}")
    return torch.empty(fill_scratch_words(h, w, maps), dtype=torch.int32, device=like.device)


def fill_from_candidates_cuda(disp, target, second_smallest: bool, max_axis_steps,
                              max_diag_steps):
    """``ops.post._fill_from_candidates`` (one pass of the fill on a float32
    map, ``target`` the bool pixels to fill): one launch of
    ``fill_pass_f32`` (the map's bitsets and its target list, then the
    targets' searches)."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    _check_map("disp", disp)
    if disp.dtype != torch.float32:
        raise ValueError(f"disp must be float32, got {disp.dtype}")
    h, w = disp.shape
    src, mask = disp.contiguous(), _mask(target, disp)
    require_cuda(disp=src)
    caps = _caps(max_axis_steps, max_diag_steps, h, w)
    out, scratch = torch.empty_like(src), _scratch(src)
    lib = library()
    with current(src.device):
        err = lib.fill_pass_f32(
            src.data_ptr(), mask.data_ptr(), out.data_ptr(), scratch.data_ptr(), h, w, 0,
            float("inf"), 0, int(second_smallest), caps[0], caps[1], 0, stream(src.device))
    raise_on_error(lib, "fill_pass_f32", err)
    LAUNCHES["fill_pass_f32"] += 1
    return out


def fill_holes_8dir_cuda(disp, occlusion, mismatch, invalid_value: float = float("inf"),
                         max_search: Optional[int] = None):
    """``ops.post.fill_holes_8dir``: one launch of ``fill_holes_8dir_f32``
    (three passes: occlusions, mismatches, what stays invalid; each builds
    the bitsets of its input map and the list of its targets, then searches
    the targets' rays in the bitsets).  The first pass reads
    ``invalid_value`` as +inf, the last writes it back."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    _check_map("disp", disp)
    occlusion, mismatch = _mask(occlusion, disp), _mask(mismatch, disp)
    require_cuda(disp=disp)
    h, w = disp.shape
    max_axis = None if max_search is None else max(max_search - 1, 0)
    max_diag = None if max_search is None else int(round(max_axis * 0.70710678))
    caps = _caps(max_axis, max_diag, h, w)
    raw = disp.dtype == torch.float32
    if raw:     # the first pass maps invalid_value as it reads
        d = disp.contiguous()
    else:       # compared in disp's own dtype, as the plain body does
        d = torch.where(disp == invalid_value, float("inf"), disp.to(torch.float32))
    out, scratch = torch.empty_like(d), _scratch(d, maps=1)
    lib = library()
    with current(d.device):
        err = lib.fill_holes_8dir_f32(
            d.data_ptr(), occlusion.data_ptr(), mismatch.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), h, w, int(raw), float(invalid_value), caps[0], caps[1],
            stream(d.device))
    raise_on_error(lib, "fill_holes_8dir_f32", err)
    LAUNCHES["fill_holes_8dir_f32"] += 1
    return out


def speckle_iteration_cap(h: int, w: int) -> int:
    """The plain body's default ``max_iters``: the JAX package's cap."""
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
    """``ops.post.remove_speckles``: one launch of ``remove_speckles_f32``
    (four kernels: tile-local labels in shared memory, the links across tile
    borders, the tile roots' counts, the kill; no host round trip).  The
    kernel labels to the fixpoint: an explicit ``max_iters`` below
    :func:`speckle_iteration_cap`, where the plain body could stop short of
    it, raises ``ValueError``."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    _check_map("disp", disp)
    h, w = disp.shape
    cap = speckle_iteration_cap(h, w)
    if max_iters is not None and max_iters < cap:
        raise ValueError(
            f"remove_speckles(max_iters={max_iters}): the CUDA kernel labels to the fixpoint, "
            f"so a cap below the plain body's {cap} sweeps has no counterpart on the card")
    if h * w >= 2**31:
        raise ValueError(f"map too large for int32 labels: {h}x{w}")
    require_cuda(disp=disp)
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


def voting_scratch_words(h: int, w: int, num_iters: int) -> int:
    """A voting call's scratch in 32-bit words: ``num_iters + 1`` target
    counts (rounded up to 4 words), each pixel's packed horizontal span, two
    target lists and a decision a target, and an int16 bin a pixel."""
    n = h * w
    return (num_iters + 4) // 4 * 4 + 4 * n + -(-n // 2)


def region_voting_cuda(disp, arms, disp_range: int, ts: float = 20.0, th: float = 0.4,
                       num_iters: int = 5, invalid_value: float = float("inf")):
    """``ops.post.iterative_region_voting`` on a CUDA map (float32
    ``[H, W]``; the arms int32 ``[H, W]`` on its device): one launch of
    ``region_voting_f32``: the bins, spans and target list,
    then two kernels an iteration (each target's region counted by a warp,
    then the fills applied and the targets left listed); no ``[D, H, W]``
    tensor.  Arms below 0 are read as 0.  Inside ``record_spans()`` the
    counter ``region_voting.targets`` gets the targets counted, summed over
    the iterations (a host sync; nothing is read outside a record)."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    _check_map("disp", disp)
    if disp.dtype != torch.float32:
        raise ValueError(f"disp must be float32, got {disp.dtype}")
    h, w = disp.shape
    if not 1 <= disp_range <= VOTE_MAX_DISPARITIES:
        raise ValueError(f"disp_range must lie in [1, {VOTE_MAX_DISPARITIES}], got {disp_range}")
    if w > VOTE_MAX_WIDTH or h * w >= 2**31:
        raise ValueError(f"map outside the kernel's shapes: {h}x{w}")
    maps = [getattr(arms, k) for k in ("left", "right", "up", "down")]
    for name, a in zip(("left", "right", "up", "down"), maps):
        if a.shape != disp.shape or a.device != disp.device or a.dtype != torch.int32:
            raise ValueError(f"arms.{name} must be int32 [{h}, {w}] on {disp.device}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    require_cuda(disp=disp)
    if num_iters < 1:
        return disp
    maps = [a.contiguous() for a in maps]
    src = disp.contiguous()
    out = torch.empty_like(src)
    scratch = torch.empty(voting_scratch_words(h, w, num_iters), dtype=torch.int32,
                          device=src.device)
    lib = library()
    with current(src.device):
        err = lib.region_voting_f32(
            src.data_ptr(), *(a.data_ptr() for a in maps), h, w, int(disp_range), float(ts),
            float(th), int(num_iters), float(invalid_value), out.data_ptr(), scratch.data_ptr(),
            stream(src.device))
    raise_on_error(lib, "region_voting_f32", err)
    LAUNCHES["region_voting_f32"] += 1
    if profiling.recording():
        profiling.count("region_voting.targets", int(scratch[:num_iters].sum()))
    return out
