"""CUDA cross arms, arm-rectangle mean (``csrc/aggregate.cu``) and cross
aggregation (``csrc/cross_aggregate.cu``).

The launchers of ``ops.aggregate.cross_arms``,
``ops.aggregate.rect_mean_aggregate`` and ``ops.aggregate.cross_aggregate``,
which call them for CUDA tensors and run their private ``_plain`` bodies
for CPU tensors.  No Pallas kernel stands behind them: they replace the XLA
ops of the JAX package's ``cross_arms``
(`stereo_match_traditional_tpu/ops/aggregate.py:119`),
``rect_mean_aggregate`` (`:486`) and ``cross_aggregate`` (`:792`).  A
launcher takes CUDA tensors only: a CPU tensor raises ``ValueError``.

The arms and the rect mean are bit-exact with their plain bodies: the
arms are integer counts of float32 comparisons, and the rectangle sums are
float64 sums of a summed-area table, exact for AD-Census volumes in any
order (otherwise within a float32 ulp of the mean).  The cross
aggregation's float64 span sums are exact on AD-Census volumes in its first
iteration (bit for bit); later iterations sum float32 means, whose float64
sums the kernel and the plain body round alike but where a sum lies near
a float32 rounding boundary (one ulp of the sum, two of the mean it is
divided into) or is tiny (below ~1e-6: more ulps, under 2^-40).

The rect mean takes one of two routes, chosen by its arguments and not by a
failure: with a cap on the arms (``max_span``, as the JAX package's call
sites pass ``cfg.arms.max_length``) whose ring fits a block
(:func:`walker_takes`), the strip walker ``rect_mean_walker_f32`` (no
float64 table in device memory); without one, or with a cap above 48, the
three kernels of ``rect_mean_f32`` on a chunked float64 table.
``csrc/aggregate.cu``'s header describes both.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current,
    raise_on_error,
    require_cuda,
    stream,
)

# Kernel launches so far, one per call of each C entry point; a run resets
# them to show its path went through the kernels.  Only the launches below
# increment them.
LAUNCHES = {"cross_arms_i32": 0, "rect_mean_f32": 0, "rect_mean_walker_f32": 0,
            "cross_support_f32": 0, "cross_aggregate_f32": 0}

# The three-kernel route builds its float64 summed-area table a chunk of
# slices at a time in a scratch of at most this many bytes (one slice at the
# least): a 720p slice is 7.4 MB, so 138 slices a chunk; the plain body
# holds float64 copies of the whole volume.
SCRATCH_BYTES = 1 << 30

# The strip walker's output columns a strip (``csrc/aggregate.cu``'s WALK_S:
# it sizes the carries) and its largest cap (WALK_MAX_SPAN: the largest whose
# ring fits a block's shared memory; the C source holds the layout).
WALKER_STRIP = 128
WALKER_MAX_SPAN = 48

# The cross aggregation's largest cap, and the one a call without
# ``span_cap`` takes: the most ``ops.aggregate.canonical_cross_arms`` gives
# (min(cross_l1, 255)).  ``csrc/cross_aggregate.cu`` picks its instance
# (strip width, rows a step) by the pass order and the cap.
CROSS_MAX_SPAN = 255

# A word a device that the walkers add the arms outside their cap to (read
# by :func:`arms_over_cap`; the main path reads nothing back).
_OVER_CAP = {}


def walker_takes(max_span, slices: int = 1) -> bool:
    """Whether a call with this cap on a volume of ``slices`` slices takes
    the strip walker: a cap is given, lies in [0, WALKER_MAX_SPAN], and the
    slices fit the grid's second dimension (<= 65535)."""
    return (max_span is not None and 0 <= int(max_span) <= WALKER_MAX_SPAN
            and slices <= 65535)


def _over_cap_word(device: torch.device) -> torch.Tensor:
    """The word of a CUDA device (``cuda`` is the current one)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    word = _OVER_CAP.get(index)
    if word is None:
        word = _OVER_CAP[index] = torch.zeros(1, dtype=torch.int32, device=f"cuda:{index}")
    return word


def arms_over_cap(device, reset: bool = False) -> int:
    """The number of arms outside their cap that the walkers have met on
    ``device`` since the word was last reset (a host sync: for checks, not
    for the main path); ``reset`` sets the word to 0 after reading it."""
    word = _over_cap_word(torch.device(device))
    n = int(word.item())
    if reset:
        word.zero_()
    return n


def cross_arms_cuda(img: torch.Tensor, cfg, row_offset: int = 0,
                    global_rows: int = None) -> torch.Tensor:
    """The arms of ``ops.aggregate.cross_arms``: one launch of
    ``cross_arms_i32`` on a CUDA image (grey ``[H, W]`` or colour
    ``[H, W, 3]``, uint8 or float32, any strides; a grey uint8 image, the
    pipelines', takes the kernel that tests four pixels a word).  Returns
    the int32 ``[4, H, W]`` planes left, right, up, down."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if not (img.dim() == 2 or (img.dim() == 3 and img.shape[-1] == 3)):
        raise ValueError(f"img must be [H, W] or [H, W, 3], got {tuple(img.shape)}")
    if img.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"img must be uint8 or float32, got {img.dtype}")
    h, w = img.shape[:2]
    if h < 1 or w < 1:
        raise ValueError(f"empty image: {tuple(img.shape)}")
    if cfg.max_length < 1:
        raise ValueError(f"max_length must be >= 1, got {cfg.max_length}")
    if 4 * h * w >= 2**31:
        raise ValueError(f"image too large for int32 indices of its four maps: {h}x{w}")
    if global_rows is None:
        global_rows = h
    require_cuda(img=img)
    img = img.contiguous()
    out = torch.empty((4, h, w), dtype=torch.int32, device=img.device)
    lib = library()
    with current(img.device):
        err = lib.cross_arms_i32(
            img.data_ptr(), 1 if img.dim() == 2 else 3, int(img.dtype == torch.uint8), h, w,
            int(row_offset), int(global_rows), cfg.max_length, cfg.sec_length,
            float(cfg.tao1), float(cfg.tao2), out.data_ptr(), stream(img.device),
        )
    raise_on_error(lib, "cross_arms_i32", err)
    LAUNCHES["cross_arms_i32"] += 1
    return out


def rect_mean_cuda(vol: torch.Tensor, arms, inclusive: bool = True,
                   max_span: Optional[int] = None) -> torch.Tensor:
    """``ops.aggregate.rect_mean_aggregate`` on a CUDA volume (float32
    ``[D, H, W]``, any strides; a batch of volumes sharing the arms
    concatenated along D).  Where :func:`walker_takes` ``max_span``, one
    launch of ``rect_mean_walker_f32`` (arms outside [0, max_span] are
    clamped and counted, see :func:`arms_over_cap`); else one launch of
    ``rect_mean_f32``."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"vol must be float32 [D, H, W], got {vol.dtype} {tuple(vol.shape)}")
    n, h, w = vol.shape
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"empty volume: {tuple(vol.shape)}")
    maps = [arms.left, arms.right, arms.up, arms.down]
    for name, a in zip(("left", "right", "up", "down"), maps):
        if a.shape != (h, w) or a.device != vol.device:
            raise ValueError(f"arms.{name} must be [{h}, {w}] on {vol.device}, got "
                             f"{tuple(a.shape)} on {a.device}")
    require_cuda(vol=vol)
    maps = [a.to(torch.int32).contiguous() for a in maps]
    vol = vol.contiguous()
    out = torch.empty_like(vol)
    lib = library()
    if walker_takes(max_span, n):
        strips = -(-w // WALKER_STRIP)
        carries = torch.empty((n, strips, h), dtype=torch.float64, device=vol.device)
        geom = torch.empty((h, w, 2), dtype=torch.int32, device=vol.device)
        word = _over_cap_word(vol.device)
        with current(vol.device):
            err = lib.rect_mean_walker_f32(
                vol.data_ptr(), n, h, w, *(a.data_ptr() for a in maps), int(bool(inclusive)),
                int(max_span), carries.data_ptr(), geom.data_ptr(), word.data_ptr(),
                out.data_ptr(), stream(vol.device),
            )
        raise_on_error(lib, "rect_mean_walker_f32", err)
        LAUNCHES["rect_mean_walker_f32"] += 1
        return out
    chunk = int(max(1, min(n, SCRATCH_BYTES // (8 * (h + 1) * (w + 1)))))
    scratch = torch.empty((chunk, h + 1, w + 1), dtype=torch.float64, device=vol.device)
    with current(vol.device):
        err = lib.rect_mean_f32(
            vol.data_ptr(), n, h, w, *(a.data_ptr() for a in maps), int(bool(inclusive)),
            scratch.data_ptr(), chunk, out.data_ptr(), stream(vol.device),
        )
    raise_on_error(lib, "rect_mean_f32", err)
    LAUNCHES["rect_mean_f32"] += 1
    return out


def cross_checks(vol: torch.Tensor, arms, span_cap: Optional[int]) -> int:
    """Raise ``ValueError`` for what ``cross_aggregate_f32`` does not take
    (a volume that is not float32 ``[D, H, W]`` and contiguous, arms that
    are not int32 ``[H, W]`` on its device, a negative cap); return the
    kernel's cap."""
    if vol.dim() != 3 or vol.dtype != torch.float32:
        raise ValueError(f"vol must be float32 [D, H, W], got {vol.dtype} {tuple(vol.shape)}")
    if not vol.is_contiguous():
        raise ValueError("vol must be contiguous")
    n, h, w = vol.shape
    if n < 1 or h < 1 or w < 1 or n > 65535 or h * w >= 2**31:
        raise ValueError(f"volume outside the kernel's shapes: {tuple(vol.shape)}")
    for name in ("left", "right", "up", "down"):
        a = getattr(arms, name)
        if a.shape != (h, w) or a.device != vol.device or a.dtype != torch.int32:
            raise ValueError(f"arms.{name} must be int32 [{h}, {w}] on {vol.device}, got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
    cap = CROSS_MAX_SPAN if span_cap is None else int(span_cap)
    if cap < 0:
        raise ValueError(f"span_cap must be >= 0, got {span_cap}")
    return min(cap, CROSS_MAX_SPAN)


def cross_aggregate_cuda(vol: torch.Tensor, arms, num_iters: int = 4,
                         horizontal_first: bool = True,
                         span_cap: Optional[int] = None) -> torch.Tensor:
    """``ops.aggregate.cross_aggregate`` on a CUDA volume (float32
    ``[D, H, W]``, contiguous; int32 ``[H, W]`` arms on its device): one
    launch of ``cross_support_f32`` (the packed arms and both supports),
    then one of ``cross_aggregate_f32`` an iteration.  The cap is
    ``span_cap``, at most :data:`CROSS_MAX_SPAN` (none: that); arms outside
    [0, cap] are clamped and counted, see :func:`arms_over_cap`."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    cap = cross_checks(vol, arms, span_cap)
    require_cuda(vol=vol)
    if num_iters < 1:
        return vol
    n, h, w = vol.shape
    maps = [a.contiguous() for a in (arms.left, arms.right, arms.up, arms.down)]
    packed = torch.empty((h, w), dtype=torch.int32, device=vol.device)
    sups = torch.empty((2, h, w), dtype=torch.float32, device=vol.device)
    lib = library()
    st = stream(vol.device)
    with current(vol.device):
        err = lib.cross_support_f32(
            *(a.data_ptr() for a in maps), h, w, cap, packed.data_ptr(), sups[0].data_ptr(),
            sups[1].data_ptr(), _over_cap_word(vol.device).data_ptr(), st)
        raise_on_error(lib, "cross_support_f32", err)
        LAUNCHES["cross_support_f32"] += 1
        out, hf = vol, bool(horizontal_first)
        for _ in range(num_iters):
            nxt = torch.empty_like(vol)
            err = lib.cross_aggregate_f32(
                out.data_ptr(), n, h, w, packed.data_ptr(), sups[0 if hf else 1].data_ptr(),
                cap, int(hf), nxt.data_ptr(), st)
            raise_on_error(lib, "cross_aggregate_f32", err)
            LAUNCHES["cross_aggregate_f32"] += 1
            out, hf = nxt, not hf
    return out
