"""CUDA banded scanline passes (``csrc/scanline_banded.cu``, and the band
entries of ``csrc/scanline.cu`` and ``csrc/scanline_canonical.cu``).

The launchers of ``ops.scanline.directional_pass_banded`` and
``canonical_pass_banded``: one directional pass over a band of path steps,
continued from a carry.  And of ``ops.scanline.horizontal_passes_banded``
and ``canonical_horizontal_passes_banded``: both horizontal passes of a
band of rows in one launch, by the whole-image kernels' horizontal design (a
block a row and direction: a walker warp with the D values in registers,
mover warps staging 128-byte runs of a row through shared memory).  Those
public functions call the launchers for CUDA tensors and run their plain
bodies for CPU tensors.  A launcher takes CUDA tensors only: a CPU tensor
raises ``ValueError``.

A pass runs on one of two kernels, chosen explicitly (:func:`pass_entry`):
for D <= 256 with the lanes contiguous in the band, its penalties (the
canonical scales) and the result, the walker / mover kernel
(``scanline_banded_f32``, ``scanline_banded_canonical_f32``: the vertical
passes of both executors); otherwise, D > 256 or lanes along strided
memory, the wide kernel (``scanline_banded_wide_f32``,
``scanline_banded_wide_canonical_f32``: any D up to :data:`WIDE_MAX_DISP`,
any strides; walker warps with the values in registers up to 1024
disparities, its movers copying along whichever of the steps or the lanes
is contiguous).  ``LAUNCHES`` counts each by its C entry.  Above 256
disparities the band entries and the whole-image scanline launchers run
their horizontal passes as two wide launches on the d-major volume as it
lies (:func:`scanline_optimize_composed`,
:func:`scanline_canonical_composed`), bit for bit the plain bodies.  Those
routes take their penalties from the plain-torch helpers of
``ops.scanline`` (``horizontal_p2``, ``vertical_p2``, ``horizontal_scales``,
``vertical_scales``), imported where they run: the one edge from this
module up to ``ops``.  The two composed routes open the ranges
``stereo/scanline_rows`` and ``stereo/scanline_columns`` around their
horizontal and vertical passes, and each pass from a zero carry counts in
``scanline.wide_passes`` (``utils.profiling``).

The kernels read ``cost`` and the penalties and write the result through
their strides, so a caller hands them a permuted view of a ``[D, t, W]``
band (``band.permute(1, 0, 2)`` for a vertical pass, ``band.permute(2, 0,
1)`` for a horizontal one) and gets the result in the same layout (the same
memory order of the dimensions), with no transposed copy.  ``reverse=True``
runs the path from the last step to the first; the result and ``reset``
keep the array's order.  ``store=False`` keeps only the outgoing carry.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops.kernels.launch import (
    current, edge_bit_words, kernel_inputs, raise_on_error, require_cuda, stream,
)
from stereo_match_traditional_tpu_torch.utils.profiling import count, stage_scope

# Kernel launches so far, one per call of each C entry point; a run resets
# them to show its path went through the kernel.  Only the launches below
# increment them.
LAUNCHES = {"scanline_banded_f32": 0, "scanline_banded_canonical_f32": 0,
            "scanline_banded_wide_f32": 0, "scanline_banded_wide_canonical_f32": 0,
            "scanline_horizontal_band_f32": 0, "scanline_canonical_horizontal_band_f32": 0}

MAX_DISP = 256         # the walker / mover kernel and the band entries: 8 values a walker lane
WIDE_MAX_DISP = 7232   # the wide kernel above 1024 (its shared-memory route): 32 D + 1 KB <= 227 KB
WALKER = {False: "scanline_banded_f32", True: "scanline_banded_canonical_f32"}
WIDE = {False: "scanline_banded_wide_f32", True: "scanline_banded_wide_canonical_f32"}


def _reset_index(reset, n: int) -> int:
    """The array index of the one step where the path restarts, or -1:
    from None, an int or a ``[T]`` bool tensor with at most one True."""
    if reset is None:
        return -1
    if isinstance(reset, int):
        return reset if 0 <= reset < n else -1
    idx = torch.nonzero(reset).flatten().tolist()
    if len(idx) > 1:
        raise ValueError(f"the banded kernel restarts a path once, got resets at {idx}")
    return idx[0] if idx else -1


def _path(x: torch.Tensor, reverse: bool):
    """Base pointer and step stride of ``x`` along its path: from the last
    step, with a negative stride, when ``reverse``."""
    n, st = x.shape[0], x.stride(0)
    if not reverse:
        return x.data_ptr(), st
    return x.data_ptr() + (n - 1) * st * x.element_size(), -st


def _empty_in_layout(x: torch.Tensor) -> torch.Tensor:
    """A dense tensor of ``x``'s shape whose dimensions lie in memory in the
    order of ``x``'s strides (a permuted view of a ``[D, t, W]`` band gives
    the same permutation of a new band), also where ``x`` is not dense."""
    order = sorted(range(x.dim()), key=lambda i: -x.stride(i))
    buf = torch.empty([x.shape[i] for i in order], dtype=x.dtype, device=x.device)
    return buf.permute([order.index(i) for i in range(x.dim())])


def _lanes_contiguous(x) -> bool:
    return x is None or x.shape[-1] == 1 or x.stride(-1) == 1


def pass_entry(canonical: bool, d: int, cost: torch.Tensor, pen: torch.Tensor,
               out: torch.Tensor = None) -> str:
    """The C entry that runs a pass of ``d`` disparities: the walker / mover
    kernel for D <= 256 with the lanes contiguous in ``cost``, ``out`` and
    (canonical) the scales ``pen``; else the wide kernel."""
    if (d <= MAX_DISP and _lanes_contiguous(cost) and _lanes_contiguous(out)
            and (not canonical or _lanes_contiguous(pen))):
        return WALKER[canonical]
    return WIDE[canonical]


def _launch(canonical, cost, pen, carry, reset, p1, p2, dm1, reverse, store, entry=None):
    """Raw launch of a pass of either family on CUDA tensors, by ``entry``
    (default :func:`pass_entry`'s)."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if cost.dim() != 3:
        raise ValueError(f"cost must be [T, D, M], got {tuple(cost.shape)}")
    n, d, m = cost.shape
    want = (n, d, m) if canonical else (n, m)
    prev, prev_min = carry
    if tuple(pen.shape) != want or prev.shape != (d, m) or prev_min.shape != (m,):
        raise ValueError(f"penalties {tuple(pen.shape)} (want {want}), carry "
                         f"{tuple(prev.shape)} / {tuple(prev_min.shape)} for cost {(n, d, m)}")
    if not 1 <= d <= WIDE_MAX_DISP or n < 1 or m < 1:
        raise ValueError(f"the banded kernels take 1 <= D <= {WIDE_MAX_DISP} (the wide "
                         f"kernel's shared memory) and a non-empty band, got D={d}, "
                         f"{n} steps, {m} lanes")
    tensors = (cost, pen, prev, prev_min)
    if any(t.dtype != torch.float32 or t.device != cost.device for t in tensors):
        raise ValueError("cost, penalties and carry must be float32 on one device")
    require_cuda(cost=cost)
    prev, prev_min = prev.contiguous(), prev_min.contiguous()
    out = _empty_in_layout(cost) if store else None
    name = entry or pass_entry(canonical, d, cost, pen, out)
    if name == WALKER[canonical] and d > MAX_DISP:
        raise ValueError(f"{name} takes D <= {MAX_DISP}, got D={d}")
    new_prev, new_min = torch.empty_like(prev), torch.empty_like(prev_min)
    r = _reset_index(reset, n)
    if r >= 0 and reverse:
        r = n - 1 - r
    c_ptr, c_st = _path(cost, reverse)
    p_ptr, p_st = _path(pen, reverse)
    o_ptr, o_st = _path(out, reverse) if store else (None, 0)
    o_strides = (o_st, out.stride(1), out.stride(2)) if store else (0, 0, 0)
    lib = library()
    with current(cost.device):
        args = [c_ptr, c_st, cost.stride(1), cost.stride(2), p_ptr, p_st,
                *((pen.stride(1), pen.stride(2)) if canonical else (pen.stride(1),)),
                o_ptr, *o_strides, prev.data_ptr(), prev_min.data_ptr(),
                new_prev.data_ptr(), new_min.data_ptr(), n, d, m, float(p1)]
        args += [float(p2), r] if canonical else [r, int(dm1)]
        err = getattr(lib, name)(*args, stream(cost.device))
    raise_on_error(lib, name, err)
    LAUNCHES[name] += 1
    return out, (new_prev, new_min)


def directional_pass_banded_cuda(
    cost: torch.Tensor,
    p2: torch.Tensor,
    carry,
    reset,
    p1: float,
    l2_uses_dm1: bool = True,
    reverse: bool = False,
    store: bool = True,
):
    """``ops.scanline.directional_pass_banded`` on ``cost`` [T, D, M] and
    ``p2`` [T, M] (any strides): one launch of ``scanline_banded_f32`` (D <=
    256, lanes contiguous) or ``scanline_banded_wide_f32``.  ``reset``: None,
    a step index or a ``[T]`` bool tensor (one True at most).  Returns
    (aggregated [T, D, M] in the memory order of ``cost``'s dimensions, or
    None without ``store``; outgoing carry)."""
    return _launch(False, cost, p2, carry, reset, p1, 0.0, l2_uses_dm1, reverse, store)


def canonical_pass_banded_cuda(
    cost: torch.Tensor,
    scale: torch.Tensor,
    carry,
    reset,
    p1_base: float,
    p2_base: float,
    reverse: bool = False,
    store: bool = True,
):
    """``ops.scanline.canonical_pass_banded`` on ``cost`` and ``scale``
    [T, D, M] (any strides): one launch of ``scanline_banded_canonical_f32``
    (D <= 256, lanes contiguous) or ``scanline_banded_wide_canonical_f32``;
    the rest as :func:`directional_pass_banded_cuda`."""
    return _launch(True, cost, scale, carry, reset, p1_base, p2_base, True, reverse, store)


def _pass(canonical, cost, pen, a, b, dm1, reverse):
    """One pass from a zero carry (the exact path seed) by the kernel
    :func:`pass_entry` picks (the wide one above 256 disparities).  Counted
    in ``scanline.wide_passes``."""
    count("scanline.wide_passes")
    zero = cost.new_zeros(cost.shape[1:]), cost.new_zeros(cost.shape[2:])
    return _launch(canonical, cost, pen, zero, None, a, b, dm1, reverse, True)[0]


def _rows(canonical, cost, pen_lr, pen_rl, a, b):
    """Both passes along the rows of a ``[D, t, W]`` volume, each row a
    whole path, read as it lies: the passes run on its ``[W, D, t]`` view
    (the wide kernel's movers copy along the columns, its contiguous
    dimension) and write their results in its memory order.
    ``pen_lr`` / ``pen_rl``: the penalties of each direction's steps in
    column order, ``[W, t]`` (legacy; ``a, b = p1, 0``) or ``[W, D, t]``
    (canonical; ``a, b = p1, p2``).  Returns ``(lr, rl)``, ``[D, t, W]``
    views of ``cost``'s layout (contiguous for a contiguous or halo-cropped
    band)."""
    ch = cost.permute(2, 0, 1)                                          # [W, D, t]
    lr = _pass(canonical, ch, pen_lr, a, b, True, False)
    rl = _pass(canonical, ch, pen_rl, a, b, True, True)
    return lr.permute(1, 2, 0), rl.permute(1, 2, 0)


def _columns(canonical, cost, pen_dn, pen_up, a, b, dm1):
    """``ud + du`` of a ``[D, H, W]`` volume, passes down its columns, as a
    ``[D, H, W]`` view."""
    cv = cost.permute(1, 0, 2)                                          # [H, D, W]
    ud = _pass(canonical, cv, pen_dn, a, b, dm1, False)
    ud += _pass(canonical, cv, pen_up, a, b, dm1, True)
    return ud.permute(1, 0, 2)


def scanline_optimize_composed(cost: torch.Tensor, gray: torch.Tensor, p1: float,
                               p2_init: float, vert_dm1: bool, first_ref: bool) -> torch.Tensor:
    """``ops.scanline.scanline_optimize`` as four banded passes from a zero
    carry: the horizontal ones along the volume's rows with P2 of
    ``ops.scanline.horizontal_p2``, the vertical ones with ``vertical_p2``,
    summed in the plain body's order, ``(lr + rl) + (ud + du)``; bit for
    bit the plain body.  The route of ``scanline_optimize_cuda`` above 256
    disparities: four launches of ``scanline_banded_wide_f32``.  ``cost``
    [D, H, W] and ``gray`` [H, W] on one CUDA device; returns a contiguous
    ``[D, H, W]`` volume."""
    from stereo_match_traditional_tpu_torch.ops import scanline

    c = cost.to(torch.float32)
    with stage_scope("scanline_rows"):
        lr, rl = _rows(False, c, *scanline.horizontal_p2(gray, p1, p2_init), p1, 0.0)
    with stage_scope("scanline_columns"):
        vert = _columns(False, c, *scanline.vertical_p2(gray, p1, p2_init, first_ref), p1, 0.0,
                        vert_dm1)
    out = torch.add(lr, rl, out=torch.empty(c.shape, dtype=torch.float32, device=c.device))
    out += vert
    return out


def scanline_canonical_composed(cost: torch.Tensor, left: torch.Tensor, right: torch.Tensor,
                                p1: float, p2: float, tso: float, view: str) -> torch.Tensor:
    """``ops.scanline.scanline_optimize_canonical`` of one view as four
    canonical banded passes: the horizontal ones along the volume's rows,
    the scales of ``ops.scanline.horizontal_scales`` and
    ``vertical_scales``, averaged in the plain body's order,
    ``((lr + rl) + (ud + du)) * 0.25``; bit for bit the plain body.  The
    route of ``scanline_optimize_canonical_cuda`` above 256 disparities:
    four launches of ``scanline_banded_wide_canonical_f32``.  Returns a
    contiguous ``[D, H, W]`` volume."""
    from stereo_match_traditional_tpu_torch.ops import scanline

    c = cost.to(torch.float32)
    d = c.shape[0]
    right_view = view == "right"
    base, match = (right, left) if right_view else (left, right)
    with stage_scope("scanline_rows"):
        s = scanline.horizontal_scales(d, base, match, tso, right_view)        # [W + 1, D, H]
        lr, rl = _rows(True, c, s[:-1], s[1:], p1, p2)
    with stage_scope("scanline_columns"):
        s = scanline.vertical_scales(d, base, match, tso, right_view)          # [H + 1, D, W]
        vert = _columns(True, c, s[:-1], s[1:], p1, p2, True)
    del s
    out = torch.add(lr, rl, out=torch.empty(c.shape, dtype=torch.float32, device=c.device))
    out += vert
    out *= 0.25
    return out


def _check_band(cost, images):
    """Raise unless ``cost`` is a float32 ``[D, t, W]`` band with its
    ``[t, W]`` image rows on one device."""
    if cost.dim() != 3 or any(tuple(g.shape) != tuple(cost.shape[1:]) for g in images):
        raise ValueError(f"cost must be a [D, t, W] band and the image rows [t, W], got "
                         f"{tuple(cost.shape)} and {[tuple(g.shape) for g in images]}")
    if any(g.device != cost.device for g in images):
        raise ValueError(f"cost and image rows must lie on one device, got {cost.device} and "
                         f"{sorted({str(g.device) for g in images})}")
    d, t, w = cost.shape
    if not 1 <= d <= WIDE_MAX_DISP or t < 1 or w < 1:
        raise ValueError(f"the band passes take 1 <= D <= {WIDE_MAX_DISP} and a non-empty "
                         f"band, got {(d, t, w)}")
    if cost.dtype != torch.float32:
        raise ValueError(f"cost must be float32, got {cost.dtype}")


def _band_launch(name, cost, call):
    """Allocate lr and rl ([D, t, wp], rows padded to 4 columns) for a
    checked band of D <= 256 and launch ``name`` by ``call(lib, cost, lr,
    rl)``; returns the [D, t, W] views of lr and rl."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    if cost.stride(2) != 1:
        cost = cost.contiguous()       # the kernel reads a row's columns side by side
    d, t, w = cost.shape
    wp = -(-w // 4) * 4
    lr = torch.empty((d, t, wp), dtype=torch.float32, device=cost.device)
    rl = torch.empty_like(lr)
    lib = library()
    with current(cost.device):
        err = call(lib, cost, lr, rl)
    raise_on_error(lib, name, err)
    LAUNCHES[name] += 1
    return lr[:, :, :w], rl[:, :, :w]


def horizontal_passes_banded_cuda(cost: torch.Tensor, grey: torch.Tensor, p1: float,
                                  p2_init: float):
    """``ops.scanline.horizontal_passes_banded`` on a ``[D, t, W]`` band
    (any strides; a halo-cropped view is read in place) and its ``[t, W]``
    grey rows: one launch of ``scanline_horizontal_band_f32`` (D <= 256),
    both directions, or above 256 disparities two launches of
    ``scanline_banded_wide_f32`` on the band as it lies (:func:`_rows`).
    Returns ``(lr, rl)``, ``[D, t, W]`` views: for D <= 256 of volumes whose
    rows are padded to a multiple of 4 columns (contiguous when ``W % 4 ==
    0``), above 256 contiguous."""
    require_cuda(cost=cost, grey=grey)
    _check_band(cost, (grey,))
    if cost.shape[0] > MAX_DISP:
        from stereo_match_traditional_tpu_torch.ops import scanline

        return _rows(False, cost, *scanline.horizontal_p2(grey, p1, p2_init), p1, 0.0)

    def call(lib, c, lr, rl):
        g = grey.to(torch.float32).contiguous()
        d, t, w = c.shape
        return lib.scanline_horizontal_band_f32(
            c.data_ptr(), c.stride(0), c.stride(1), g.data_ptr(), lr.data_ptr(), rl.data_ptr(),
            d, t, w, float(p1), float(p2_init), stream(c.device))

    return _band_launch("scanline_horizontal_band_f32", cost, call)


def canonical_horizontal_passes_banded_cuda(cost: torch.Tensor, base: torch.Tensor,
                                            match: torch.Tensor, p1: float, p2: float,
                                            tso: float, right_view: bool):
    """``ops.scanline.canonical_horizontal_passes_banded`` on a ``[D, t, W]``
    band (any strides) and its ``[t, W]`` rows of the view's own grey image
    (``base``) and the other one (``match``; both read as they are when both
    are uint8, else as float32): one call of
    ``scanline_canonical_horizontal_band_f32`` (D <= 256: the edge bits of
    the band's rows, then both directions in one launch), or above 256
    disparities two launches of ``scanline_banded_wide_canonical_f32`` on the
    scales of ``ops.scanline.horizontal_scales``.  Returns ``(lr, rl)`` as
    :func:`horizontal_passes_banded_cuda`."""
    require_cuda(cost=cost, base=base, match=match)
    _check_band(cost, (base, match))
    if cost.shape[0] > MAX_DISP:
        from stereo_match_traditional_tpu_torch.ops import scanline

        s = scanline.horizontal_scales(cost.shape[0], base, match, tso, right_view)
        return _rows(True, cost, s[:-1], s[1:], p1, p2)

    def call(lib, c, lr, rl):
        b, m, u8 = kernel_inputs(base, match)
        d, t, w = c.shape
        bits = torch.empty(edge_bit_words(t, w), dtype=torch.int32, device=c.device)
        return lib.scanline_canonical_horizontal_band_f32(
            c.data_ptr(), c.stride(0), c.stride(1), b.data_ptr(), m.data_ptr(), u8,
            bits.data_ptr(), lr.data_ptr(), rl.data_ptr(), d, t, w, float(p1), float(p2),
            float(tso), int(bool(right_view)), stream(c.device))

    return _band_launch("scanline_canonical_horizontal_band_f32", cost, call)
