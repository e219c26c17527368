"""Cost aggregation (torch counterpart of
``stereo_match_traditional_tpu.ops.aggregate``): cross arms (the
reference's and the canonical CrossAggregator's), the arm-rectangle mean
and the two-pass cross aggregation.

Arm growth is a leading-ones count over a stack of shifted threshold
predicates; the rectangle mean is a summed-area table (two cumsums) plus
four corner picks per pixel; a cross pass is a prefix sum along one axis
plus two picks per pixel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_match_traditional_tpu_torch.config import CrossAggregatorParams, CrossArmConfig
from stereo_match_traditional_tpu_torch.ops import on_cuda
from stereo_match_traditional_tpu_torch.ops.kernels import aggregate_cuda

# The JAX package's rect_mean_aggregate layouts; each runs the port's one layout
RECT_LAYOUTS = ("auto", "dmajor", "pixel_major")
# The JAX package's cross_aggregate methods; each runs the port's one layout
CROSS_METHODS = ("auto", "matmul", "gather", "pixel_major")


class Arms(NamedTuple):
    """Per-pixel cross-arm lengths, int32 [H, W] each."""

    left: torch.Tensor
    right: torch.Tensor
    up: torch.Tensor
    down: torch.Tensor


def _max_channel_diff(a: torch.Tensor, b: torch.Tensor, color: bool) -> torch.Tensor:
    d = torch.abs(a.to(torch.float32) - b.to(torch.float32))
    if color:
        d = d.amax(dim=-1)
    return d


def _directional_shifts(img: torch.Tensor, n: int, axis: int, sign: int) -> torch.Tensor:
    """``values[o-1, i, j(, c)]`` = img shifted by ``o*sign`` along ``axis``,
    edge-clamped."""
    size = img.shape[axis]
    offs = torch.arange(1, n + 1, device=img.device)
    idx = (torch.arange(size, device=img.device)[None, :] + sign * offs[:, None]).clamp_(0, size - 1)
    out = img.index_select(axis, idx.reshape(-1))
    out = out.reshape(img.shape[:axis] + (n, size) + img.shape[axis + 1:])
    return out.movedim(axis, 0)


def _arm_one_direction(img: torch.Tensor, cfg: CrossArmConfig, axis: int, sign: int,
                       offset: int = 0, global_size: int = None) -> torch.Tensor:
    """Arm length along one direction (`CrossArm.cpp:147-260`).

    Offset o is accepted iff in bounds and the max channel difference to
    the *centre* pixel is <= tao(o), tao1 for o <= sec_length else tao2.
    The arm is the number of leading accepted offsets, capped at
    max_length; a threshold failure at o=1 still gives arm 1 when the
    pixel is >= 2 pixels from the border (`CrossArm.cpp:186-196`).

    ``offset`` / ``global_size`` place the image's ``axis`` inside a larger
    one (a row band, ``cross_arms``): both rules read global positions.
    """
    n = cfg.max_length
    size = img.shape[axis]
    if global_size is None:
        global_size = size
    pos = torch.arange(size, device=img.device) + offset       # global positions
    offs = torch.arange(1, n + 1, device=img.device)
    tgt = pos[None, :] + sign * offs[:, None]                  # [n, size]
    shape = [n, 1, 1]
    shape[axis + 1] = size
    inb = ((tgt >= 0) & (tgt <= global_size - 1)).reshape(shape)

    diff = _max_channel_diff(_directional_shifts(img, n, axis, sign), img[None],
                             color=img.dim() == 3)
    tao = torch.where(offs <= cfg.sec_length, float(cfg.tao1), float(cfg.tao2))
    tao = tao.to(torch.float32).reshape(n, 1, 1)
    ok = inb & (diff <= tao)
    leading = ok.to(torch.int32).cumprod(dim=0).sum(dim=0, dtype=torch.int32)

    # min-1 rule: the first offset failed the threshold (not the border)
    # and the pixel is at least 2 from the border in this direction
    fail1 = inb[0] & (diff[0] > tao[0])
    border_ok = pos >= 2 if sign < 0 else pos <= global_size - 3
    shape2 = [1, 1]
    shape2[axis] = size
    min1 = (leading == 0) & fail1 & border_ok.reshape(shape2)
    return torch.where(min1, 1, leading).to(torch.int32)


def cross_arms(
    img: torch.Tensor, cfg: CrossArmConfig, row_offset: int = 0, global_rows: int = None
) -> Arms:
    """All four arms of one image, gray ``[H, W]`` or colour ``[H, W, 3]``
    (`CrossArm.cpp:147-598`, with the ``col=_row`` right-arm bug at
    `CrossArm.cpp:265` fixed as the JAX package does).  ``row_offset`` /
    ``global_rows`` place a row band in an image of ``global_rows`` rows
    (the row executors, ``parallel``): the vertical arms stop at the
    image's borders, not the band's.

    A CUDA image launches the arm kernel
    (``ops.kernels.aggregate_cuda.cross_arms_cuda``: a grey uint8 image four
    pixels a thread, an offset of the four tested by SIMD instructions on
    one word), a CPU image runs the plain body below; the two agree bit
    for bit."""
    if on_cuda(img):
        return Arms(*aggregate_cuda.cross_arms_cuda(img, cfg, row_offset, global_rows).unbind(0))
    return _cross_arms_plain(img, cfg, row_offset, global_rows)


def _cross_arms_plain(
    img: torch.Tensor, cfg: CrossArmConfig, row_offset: int = 0, global_rows: int = None
) -> Arms:
    """The plain body of :func:`cross_arms`: a stack of shifted images and
    a leading-ones count a direction."""
    return Arms(
        left=_arm_one_direction(img, cfg, 1, -1),
        right=_arm_one_direction(img, cfg, 1, +1),
        up=_arm_one_direction(img, cfg, 0, -1, row_offset, global_rows),
        down=_arm_one_direction(img, cfg, 0, +1, row_offset, global_rows),
    )


def _canonical_arm_one_direction(
    img: torch.Tensor, params: CrossAggregatorParams, axis: int, sign: int,
    offset: int = 0, global_size: int = None,
) -> torch.Tensor:
    """Arm length along one direction by the vendored CrossAggregator's
    rules (`cross_aggregator.cpp:135-269`): the pixel at offset o (1-based)
    extends the arm iff it is in bounds, its max channel difference to the
    centre is < t1, to the pixel at offset o - 1 is < t1 (for o > 1), and to
    the centre is < t2 beyond L2; the arm is the number of leading such
    offsets, capped at min(L1, 255); ``offset`` / ``global_size`` as in
    :func:`_arm_one_direction`."""
    n = min(params.cross_l1, 255)
    size = img.shape[axis]
    if global_size is None:
        global_size = size
    pos = torch.arange(size, device=img.device) + offset       # global positions
    offs = torch.arange(1, n + 1, device=img.device)
    tgt = pos[None, :] + sign * offs[:, None]                  # [n, size]
    shape = [n, 1, 1]
    shape[axis + 1] = size
    inb = ((tgt >= 0) & (tgt <= global_size - 1)).reshape(shape)

    color = img.dim() == 3
    shifts = _directional_shifts(img, n, axis, sign)
    d_center = _max_channel_diff(shifts, img[None], color)
    d_prev = _max_channel_diff(shifts, torch.cat([img[None], shifts[:-1]]), color)
    ok = (d_center < params.cross_t1) & inb
    ok[1:] &= d_prev[1:] < params.cross_t1
    beyond_l2 = (offs > params.cross_l2).reshape(n, 1, 1)
    ok &= ~beyond_l2 | (d_center < params.cross_t2)
    return ok.to(torch.int32).cumprod(dim=0).sum(dim=0, dtype=torch.int32)


def canonical_cross_arms(
    img: torch.Tensor, params: CrossAggregatorParams, row_offset: int = 0,
    global_rows: int = None,
) -> Arms:
    """All four arms of one image, gray ``[H, W]`` or colour ``[H, W, 3]``,
    by the vendored Ethan-Li CrossAggregator (`cross_aggregator.cpp:76-86`);
    ``row_offset`` / ``global_rows`` as in :func:`cross_arms`."""
    return Arms(
        left=_canonical_arm_one_direction(img, params, 1, -1),
        right=_canonical_arm_one_direction(img, params, 1, +1),
        up=_canonical_arm_one_direction(img, params, 0, -1, row_offset, global_rows),
        down=_canonical_arm_one_direction(img, params, 0, +1, row_offset, global_rows),
    )


def _sat(x: torch.Tensor) -> torch.Tensor:
    """Summed-area table in float64 with a zero border, ``S[..., i, j] =
    sum x[..., :i, :j]``; columns first, then rows.

    float64, where the JAX package sums in float32: a float32 SAT of a
    Teddy slice reaches ~3e5 (ulp 0.03) and of a 720p slice ~2e6 (ulp
    0.125), and the rectangle sums are differences of such entries.  In
    float64 the AD-Census costs (0 or >= 1 - exp(-1/30), so no bit below
    2^-28) sum exactly below 2^25, so the sums are exact, equal on the CPU
    and the card whatever the summation order, and a rectangle's mean is
    the same for two disparities whose costs agree on it (the clamp
    triangle), where a float32 SAT breaks such ties by rounding.
    """
    c = x.to(torch.float64).cumsum(dim=-1).cumsum(dim=-2)
    return torch.nn.functional.pad(c, (1, 0, 1, 0))


def _rect_sums(vol: torch.Tensor, i0, i1, j0, j1) -> torch.Tensor:
    """Inclusive rectangle sums of every d-slice of ``vol`` [D, H, W] with
    ``[H, W]`` bounds shared across the disparity axis: four corner picks
    from the SAT, combined in the JAX package's order, rounded to
    ``vol``'s dtype."""
    d, h, w = vol.shape
    sat = _sat(vol)
    wp = sat.shape[-1]
    flat = sat.reshape(d, -1)

    def g(ii, jj):
        return flat.index_select(1, (ii * wp + jj).reshape(-1))

    out = g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)
    return out.reshape(d, h, w).to(vol.dtype)


def rect_mean_aggregate(
    vol: torch.Tensor,
    arms: Arms,
    inclusive: bool = True,
    max_span: Optional[int] = None,
    layout: str = "auto",
) -> torch.Tensor:
    """Per-pixel arm-rectangle mean over each disparity slice of ``vol``
    [D, H, W].

    ``inclusive=True`` is the active `AggregationVertical`
    (`CrossArm.cpp:60-102`, bounds -L..R x -up..down inclusive);
    ``inclusive=False`` the dormant exclusive-upper `Aggregation`
    (`CrossArm.cpp:104-145`).  Where an exclusive rectangle is empty the
    centre cost is kept (the reference divides 0/0 there).

    ``max_span`` and ``layout`` take the JAX package's positions and values
    so that its call sites copy across.  ``max_span`` is, as there, a static
    bound on the arm lengths (the callers pass ``cfg.arms.max_length``): on
    the card it picks the strip walker, whose ring of table rows it sizes
    (``ops.kernels.aggregate_cuda.walker_takes``); without it the card runs
    the chunked-table kernels, and on the CPU it changes nothing.  A cap
    below the arms breaks that contract: the card clamps such arms to the
    cap (and counts them, ``aggregate_cuda.arms_over_cap``), the CPU does
    not, so the two then give different means.  The TPU's
    ``'dmajor'`` and ``'pixel_major'`` SAT layouts are not ported (ROADMAP.md,
    North star), so every ``layout`` runs the port's one layout.  An unknown
    ``layout`` raises ``ValueError``.

    A CUDA volume launches a rect-mean kernel
    (``ops.kernels.aggregate_cuda.rect_mean_cuda``), a CPU volume runs the
    plain body below: bit for bit the same on AD-Census volumes, whose
    float64 sums are exact, and within a float32 ulp on others.
    """
    if layout not in RECT_LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {RECT_LAYOUTS}")
    if on_cuda(vol, *arms):
        return aggregate_cuda.rect_mean_cuda(vol, arms, inclusive, max_span)
    return _rect_mean_aggregate_plain(vol, arms, inclusive)


def _rect_mean_aggregate_plain(vol: torch.Tensor, arms: Arms, inclusive: bool = True):
    """The plain body of :func:`rect_mean_aggregate`: a float64 SAT of the
    whole volume and four corner gathers."""
    h, w = vol.shape[-2:]
    ii = torch.arange(h, device=vol.device, dtype=torch.int64)[:, None]
    jj = torch.arange(w, device=vol.device, dtype=torch.int64)[None, :]
    up, down, left, right = (a.to(torch.int64) for a in (arms.up, arms.down, arms.left, arms.right))
    if inclusive:
        i0, i1 = ii - up, ii + down
        j0, j1 = jj - left, jj + right
        count = (up + down + 1) * (left + right + 1)
    else:
        i0, i1 = ii - up, ii + down - 1
        j0, j1 = jj - left, jj + right - 1
        count = (up + down) * (left + right)
    total = _rect_sums(
        vol, i0.clamp(0, h - 1), i1.clamp(0, h - 1), j0.clamp(0, w - 1), j1.clamp(0, w - 1)
    )
    mean = total / count.clamp(min=1).to(vol.dtype)
    return torch.where(count > 0, mean, vol)


def _span_sum(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, dim: int) -> torch.Tensor:
    """``sum x[lo <= t < hi]`` along ``dim`` (-1 or -2) of ``x`` [..., H, W]
    with ``[H, W]`` bounds in ``[0, size]``: a prefix sum along ``dim`` with
    a zero in front and two picks per pixel, rounded to ``x``'s dtype once.

    Floating ``x`` sums in float64 and is rounded once: the AD-Census costs
    (0, or float32 values in [2^-5, 2), all multiples of 2^-28) and their
    first-pass span sums add exactly there whatever the summation order, and
    later passes carry 29 bits more than float32 keeps, so the CPU and the
    card give the same float32 but for a sum within ~2^-29 of a rounding
    boundary, and a sum of tiny values (below ~1e-6), whose float32 ulp is
    finer than the prefix's float64 error (~1e-13 at 720p), differs by more
    ulps but not by more absolutely.  Integer ``x`` sums in its own dtype,
    exactly."""
    acc = torch.float64 if x.is_floating_point() else x.dtype
    h, w = x.shape[-2:]
    pad = (1, 0) if dim == -1 else (0, 0, 1, 0)
    cs = torch.nn.functional.pad(x.cumsum(dim=dim, dtype=acc), pad)
    flat = cs.reshape(*cs.shape[:-2], -1)
    if dim == -1:       # rows of W + 1 prefix values
        base = torch.arange(h, device=x.device)[:, None] * (w + 1)
    else:               # H + 1 rows of W
        base = torch.arange(w, device=x.device)[None, :]
        lo, hi = lo * w, hi * w
    out = (flat.index_select(-1, (base + hi).reshape(-1))
           - flat.index_select(-1, (base + lo).reshape(-1)))
    return out.reshape(x.shape).to(x.dtype)


def _hsum(x: torch.Tensor, left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """``sum_{t=-left..right} x[..., i, j+t]`` (`cross_aggregator.cpp:362-364`),
    clipped to the image."""
    w = x.shape[-1]
    jj = torch.arange(w, device=x.device)[None, :]
    return _span_sum(x, (jj - left.to(torch.int64)).clamp(0, w),
                     (jj + right.to(torch.int64) + 1).clamp(0, w), -1)


def _vsum(x: torch.Tensor, up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """``sum_{t=-up..down} x[..., i+t, j]`` (`cross_aggregator.cpp:367-369`),
    clipped to the image."""
    h = x.shape[-2]
    ii = torch.arange(h, device=x.device)[:, None]
    return _span_sum(x, (ii - up.to(torch.int64)).clamp(0, h),
                     (ii + down.to(torch.int64) + 1).clamp(0, h), -2)


def cross_aggregate(
    vol: torch.Tensor,
    arms: Arms,
    num_iters: int = 4,
    horizontal_first: bool = True,
    max_arm: Optional[int] = None,
    method: str = "auto",
    span_cap: Optional[int] = None,
) -> torch.Tensor:
    """Iterative two-pass cross aggregation (`cross_aggregator.cpp:89-118,
    327-394`): each iteration sums every d-slice of ``vol`` [D, H, W] along
    one axis inside each pixel's arm span, then along the other axis inside
    the arm span of the first pass's result, divides by the matching
    support-pixel count (`cross_aggregator.cpp:271-325`), and flips the pass
    order.

    ``max_arm``, ``method`` and ``span_cap`` take the JAX package's
    positions and values so that its call sites copy across.  There they
    choose how the TPU sums a span (banded selects, dense band matmuls, a
    pixel-major layout, its row-chunk halos): the TPU layouts are not
    ported, so every ``method`` runs the port's one layout, a float64
    prefix sum along the axis and two picks rounded to float32 once a pass,
    and ``max_arm`` changes nothing.  ``span_cap`` is, as there, a static
    bound on the arm lengths (the callers pass ``cross_l1``): on the card it
    sizes the kernel's halo and ring (no cap: 255, the most
    :func:`canonical_cross_arms` gives), on the CPU it changes nothing.  A
    cap below the arms breaks that contract: the card clamps such arms to
    the cap (and counts them, ``aggregate_cuda.arms_over_cap``), the CPU
    does not.  An unknown ``method`` raises ``ValueError``.

    A CUDA volume launches the span walker
    (``ops.kernels.aggregate_cuda.cross_aggregate_cuda``: one launch an
    iteration, both passes in shared memory), a CPU volume runs the plain
    version below: bit for bit the same first iteration on AD-Census
    volumes, whose float64 sums are exact; later ones within two float32
    ulps, or within 2^-40 for means below ~1e-6 (:func:`_span_sum`).
    """
    if method not in CROSS_METHODS:
        raise ValueError(f"method must be one of {CROSS_METHODS}: {method!r}")
    if on_cuda(vol, *arms):
        return aggregate_cuda.cross_aggregate_cuda(vol, arms, num_iters, horizontal_first,
                                                   span_cap)
    return _cross_aggregate_plain(vol, arms, num_iters, horizontal_first)


def _cross_aggregate_plain(vol: torch.Tensor, arms: Arms, num_iters: int = 4,
                           horizontal_first: bool = True) -> torch.Tensor:
    """The plain body of :func:`cross_aggregate`: per pass a float64
    prefix sum along the axis and two picks a pixel (:func:`_hsum`,
    :func:`_vsum`), rounded to float32."""
    ones = torch.ones(vol.shape[-2:], dtype=torch.float32, device=vol.device)
    sup_h_first = _vsum(_hsum(ones, arms.left, arms.right), arms.up, arms.down)
    sup_v_first = _hsum(_vsum(ones, arms.up, arms.down), arms.left, arms.right)
    out = vol
    hf = horizontal_first
    for _ in range(num_iters):
        if hf:
            out = _vsum(_hsum(out, arms.left, arms.right), arms.up, arms.down) / sup_h_first
        else:
            out = _hsum(_vsum(out, arms.up, arms.down), arms.left, arms.right) / sup_v_first
        hf = not hf
    return out


# ---------------------------------------------------------------------------
# dormant CBLSM variants: disparity-conditioned arm volumes (`CBLSM.h:65-236`),
# the V4 rectangle mean and the arm-region mean costs
# ---------------------------------------------------------------------------


def rect_mean_aggregate_volume(
    vol: torch.Tensor,
    arm_left: torch.Tensor,
    arm_right: torch.Tensor,
    arm_up: torch.Tensor,
    arm_down: torch.Tensor,
    inclusive: bool = False,
) -> torch.Tensor:
    """Rectangle mean with disparity-conditioned arm volumes
    (`costAggregationV4`, `CBLSM.h:1128-1176`, dormant at `CBLSM.cpp:111`).

    The arms are ``[D, H, W]`` (from :func:`cblsm_arm_volumes`); V4's bounds
    exclude the upper ends, ``[-up, down) x [-L, R)`` (`CBLSM.h:1162-1169`).
    Indices clamp into the image and an empty region keeps the centre cost
    (the reference reads out of bounds and divides by zero there).  Every
    element picks its own corners: one flat gather a corner from the float64
    SAT, rounded to ``vol``'s dtype once.
    """
    d, h, w = vol.shape
    dev = vol.device
    ii = torch.arange(h, device=dev)[None, :, None]
    jj = torch.arange(w, device=dev)[None, None, :]
    up, down, left, right = (a.to(torch.int64) for a in (arm_up, arm_down, arm_left, arm_right))
    if inclusive:
        i0, i1 = ii - up, ii + down
        j0, j1 = jj - left, jj + right
        count = (up + down + 1) * (left + right + 1)
    else:
        i0, i1 = ii - up, ii + down - 1
        j0, j1 = jj - left, jj + right - 1
        count = (up + down) * (left + right)
    i0, i1 = i0.clamp(0, h - 1), i1.clamp(0, h - 1)
    j0, j1 = j0.clamp(0, w - 1), j1.clamp(0, w - 1)
    flat = _sat(vol).reshape(-1)            # [D, H+1, W+1]
    base = torch.arange(d, device=dev)[:, None, None] * ((h + 1) * (w + 1))

    def g(i, j):
        return flat.gather(0, (base + i * (w + 1) + j).reshape(-1)).reshape(d, h, w)

    total = (g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)).to(vol.dtype)
    mean = total / count.clamp(min=1).to(vol.dtype)
    return torch.where(count > 0, mean, vol)


def _arm_region_mean(img: torch.Tensor, up, down, left, right, col_shift) -> torch.Tensor:
    """Mean of ``img`` [H, W] over rows [i-up, i+down] x columns
    [j-left-s, j+right-s] (inclusive, clamped); the bounds broadcast against
    the output, the sums come from the float64 SAT and round once."""
    h, w = img.shape
    ii = torch.arange(h, device=img.device)[:, None]
    jj = torch.arange(w, device=img.device)[None, :]
    up, down, left, right, col_shift = (
        torch.as_tensor(a, device=img.device).to(torch.int64)
        for a in (up, down, left, right, col_shift))
    i0 = (ii - up).clamp(0, h - 1)
    i1 = (ii + down).clamp(0, h - 1)
    j0 = (jj - left - col_shift).clamp(0, w - 1)
    j1 = (jj + right - col_shift).clamp(0, w - 1)
    i0, i1, j0, j1 = torch.broadcast_tensors(i0, i1, j0, j1)
    flat = _sat(img).reshape(-1)            # [H+1, W+1]

    def g(i, j):
        return flat[i * (w + 1) + j]

    total = (g(i1 + 1, j1 + 1) - g(i0, j1 + 1) - g(i1 + 1, j0) + g(i0, j0)).to(torch.float32)
    count = (i1 - i0 + 1) * (j1 - j0 + 1)
    return total / count.clamp(min=1).to(torch.float32)


def local_mean_cost(
    left: torch.Tensor,
    right: torch.Tensor,
    arms_l: Arms,
    arms_r: Arms,
    disp_range: int,
) -> torch.Tensor:
    """On-the-fly aggregated cost (`ComputeLocalValue` / `costAggregation`,
    `CBLSM.h:969-1085`, dormant): ``cost(p, d) = |mean of the left image
    over p's left arm region - mean of the right image over p's right arm
    region shifted left by d|``, with the intended semantics the JAX package
    implements (inclusive spans, exact counts, clamped borders; the
    reference's plumbing is scrambled, `CBLSM.h:1012,1076-1078`)."""
    mean_l = _arm_region_mean(left, arms_l.up[None], arms_l.down[None], arms_l.left[None],
                              arms_l.right[None], 0)                        # [1, H, W]
    ds = torch.arange(disp_range, device=left.device)[:, None, None]
    mean_r = _arm_region_mean(right, arms_r.up[None], arms_r.down[None], arms_r.left[None],
                              arms_r.right[None], ds)                       # [D, H, W]
    return torch.abs(mean_l - mean_r)


def local_mean_cost_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    arm_left: torch.Tensor,
    arm_right: torch.Tensor,
    arm_up: torch.Tensor,
    arm_down: torch.Tensor,
) -> torch.Tensor:
    """`costAggregationNew` (`CBLSM.h:1087-1126`, dormant): as
    :func:`local_mean_cost`, but both means take the same
    disparity-conditioned support (the ``[D, H, W]`` arm volumes of
    :func:`cblsm_arm_volumes`); the right mean's columns shift by d."""
    ds = torch.arange(arm_left.shape[0], device=left.device)[:, None, None]
    mean_l = _arm_region_mean(left, arm_up, arm_down, arm_left, arm_right, 0)
    mean_r = _arm_region_mean(right, arm_up, arm_down, arm_left, arm_right, ds)
    return torch.abs(mean_l - mean_r)


def cblsm_arm_volumes(arms_l: Arms, arms_r: Arms, disp_range: int, max_steps: int = 34):
    """The dormant CBLSM support proper (`chooseArmLengthLeft/Right/Up/Down`,
    `CBLSM.h:65-236`, disabled at `CBLSM.cpp:108-111`): per (pixel, d)
    extents that intersect the left image's arms with the right image's,
    with the reference's exact bounds.  Returns int32 ``[D, H, W]`` volumes
    (left, right, up, down).

    The right image's arms are read at the same column (the reference
    indexes them at (i, j), not (i, j - d), `CBLSM.h:74-76`).
    * left (`CBLSM.h:65-102`): 0 if d > RL or d > RR, else min(LL, RL - d);
    * right (`CBLSM.h:104-148`): 0 if d > RL, else min(LR, RR + d - 1);
    * up and down: :func:`_cblsm_vertical_volume`.
    """
    d = torch.arange(disp_range, device=arms_l.left.device, dtype=torch.int32)[:, None, None]
    ll, lr = arms_l.left[None], arms_l.right[None]
    rl, rr = arms_r.left[None], arms_r.right[None]
    vol_l = torch.where((d > rl) | (d > rr), 0, torch.clamp(torch.minimum(ll, rl - d), min=0))
    vol_r = torch.where(d > rl, 0, torch.clamp(torch.minimum(lr, rr + d - 1), min=0))
    vol_up = _cblsm_vertical_volume(arms_l, arms_r, disp_range, up=True, max_steps=max_steps)
    vol_dn = _cblsm_vertical_volume(arms_l, arms_r, disp_range, up=False, max_steps=max_steps)
    return vol_l.to(torch.int32), vol_r.to(torch.int32), vol_up, vol_dn


def _cblsm_vertical_volume(
    arms_l: Arms, arms_r: Arms, disp_range: int, up: bool, max_steps: int = 34
) -> torch.Tensor:
    """Vertical disparity-conditioned extents of :func:`cblsm_arm_volumes`.

    Up (`chooseArmLengthUp`, `CBLSM.h:151-192`): the count of steps
    s = 1..min(LUp, max_steps) whose right-image horizontal arms at row i - s
    strictly contain column j - d (`CBLSM.h:175`), 0 where LUp > RUp
    (`CBLSM.h:181-184`).  Down (`CBLSM.h:195-236`): steps s = 1..min(LDown,
    RDown) whose arms at row i + s contain it inclusively (`CBLSM.h:220`).
    Both are 0 where j < d (`CBLSM.h:170-173,215-219`).

    The JAX package forms all ``max_steps`` steps at once (an
    ``[S, D, H, W]`` boolean); here they are added one step at a time into
    an int32 count, which is exact.
    """
    h, w = arms_l.left.shape
    dev = arms_l.left.device
    sign = -1 if up else +1
    l_arm = arms_l.up if up else arms_l.down
    r_arm = arms_r.up if up else arms_r.down
    d = torch.arange(disp_range, device=dev, dtype=torch.int32)[:, None, None]
    walk = torch.clamp(l_arm, max=max_steps) if up else torch.minimum(l_arm, r_arm)
    count = torch.zeros((disp_range, h, w), dtype=torch.int32, device=dev)
    ii = torch.arange(h, device=dev)
    for s in range(1, max_steps + 1):
        rows = (ii + sign * s).clamp(0, h - 1)
        ptr_l = arms_r.left.index_select(0, rows)[None]
        if up:
            ptr_r = arms_r.right.index_select(0, rows)[None]
            contains = (d < ptr_l) & ((ptr_r > 0) | (d > 0))
        else:
            contains = d <= ptr_l
        count += (contains & (s <= walk)[None]).to(torch.int32)
    if up:
        count = torch.where(l_arm[None] > r_arm[None], 0, count)
    jj = torch.arange(w, device=dev, dtype=torch.int32)[None, None, :]
    return torch.where(jj - d >= 0, count, 0).to(torch.int32)
