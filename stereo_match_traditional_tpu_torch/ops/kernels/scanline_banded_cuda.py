"""CUDA banded scanline passes (``csrc/scanline_banded.cu``).

Counterparts of ``ops.scanline.directional_pass_banded`` and
``canonical_pass_banded``, their plain versions: one directional pass over a
band of path steps, continued from a carry.  Dispatch is by the device of
the inputs, never by a fallback: CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.

The kernel reads ``cost`` and the penalties and writes the result through
their strides, so a caller hands it a permuted view of a ``[D, t, W]`` band
(``band.permute(1, 0, 2)`` for a vertical pass, ``band.permute(2, 0, 1)``
for a horizontal one) and gets the result in the same layout
(the same memory order of the dimensions), with no transposed copy.  ``reverse=True`` runs the
path from the last step to the first; the result and ``reset`` keep the
array's order.  ``store=False`` keeps only the outgoing carry.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops import scanline
from stereo_match_traditional_tpu_torch.ops.kernels.launch import current, raise_on_error, stream

# Kernel launches so far, one per call of each C entry point; a run resets
# them to show its path went through the kernel.  Only the launch below
# increments them.
LAUNCHES = {"scanline_banded_f32": 0, "scanline_banded_canonical_f32": 0}

MAX_DISP = 256   # 16 disparities a thread, 16 warps a block


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


def _plain(fn, cost, pen, carry, reset, reverse, store):
    """The plain version, run along the reversed path for ``reverse``."""
    if reverse:
        if reset is not None and not isinstance(reset, int):
            reset = reset.flip(0)
        elif reset is not None:
            reset = cost.shape[0] - 1 - reset
        out, carry = fn(cost.flip(0), pen.flip(0), carry, reset)
        out = out.flip(0)
    else:
        out, carry = fn(cost, pen, carry, reset)
    return (out if store else None), carry


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


def _launch(name, cost, pen, carry, reset, p1, p2, dm1, reverse, store):
    """Raw launch of ``name`` on CUDA tensors."""
    from stereo_match_traditional_tpu_torch.ops.kernels.build import library

    canonical = name == "scanline_banded_canonical_f32"
    if cost.dim() != 3:
        raise ValueError(f"cost must be [T, D, M], got {tuple(cost.shape)}")
    n, d, m = cost.shape
    want = (n, d, m) if canonical else (n, m)
    prev, prev_min = carry
    if tuple(pen.shape) != want or prev.shape != (d, m) or prev_min.shape != (m,):
        raise ValueError(f"penalties {tuple(pen.shape)} (want {want}), carry "
                         f"{tuple(prev.shape)} / {tuple(prev_min.shape)} for cost {(n, d, m)}")
    if not 1 <= d <= MAX_DISP or n < 1 or m < 1:
        raise ValueError(f"banded kernel takes 1 <= D <= {MAX_DISP} and a non-empty band, "
                         f"got {(n, d, m)}")
    tensors = (cost, pen, prev, prev_min)
    if any(t.dtype != torch.float32 or t.device != cost.device for t in tensors):
        raise ValueError("cost, penalties and carry must be float32 on one device")
    prev, prev_min = prev.contiguous(), prev_min.contiguous()
    out = _empty_in_layout(cost) if store else None
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
    ``p2`` [T, M] (any strides): one launch of ``scanline_banded_f32`` for
    CUDA inputs, the plain version for CPU inputs.  ``reset``: None, a step
    index or a ``[T]`` bool tensor (one True at most on the card).  Returns
    (aggregated [T, D, M], on the card in the memory order of ``cost``'s
    dimensions, or None without ``store``; outgoing carry)."""
    if not cost.is_cuda:
        def fn(c, p, cr, rs):
            return scanline.directional_pass_banded(c, p, cr, rs, p1, l2_uses_dm1)
        return _plain(fn, cost, p2, carry, reset, reverse, store)
    return _launch("scanline_banded_f32", cost, p2, carry, reset, p1, 0.0, l2_uses_dm1,
                   reverse, store)


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
    for CUDA inputs, the plain version for CPU inputs; the rest as
    :func:`directional_pass_banded_cuda`."""
    if not cost.is_cuda:
        def fn(c, s, cr, rs):
            return scanline.canonical_pass_banded(c, s, cr, rs, p1_base, p2_base)
        return _plain(fn, cost, scale, carry, reset, reverse, store)
    return _launch("scanline_banded_canonical_f32", cost, scale, carry, reset, p1_base,
                   p2_base, True, reverse, store)
