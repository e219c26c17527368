"""Cost-volume construction (torch counterpart of
``stereo_match_traditional_tpu.ops.volume``).

Volumes are dense ``[D, H, W]`` float32 tensors, the JAX package's layout,
so the two are compared like for like.

Border semantics: the reference copies the previous-d cost when the match
column underflows (`SAD/Sad.h:125-128`, `AD-Census.h:88-92`), which equals
evaluating the cost at the last valid disparity ``min(d, j)`` (or
``min(d, W-1-j)`` for right-view volumes) — :func:`border_fill`.
"""

from __future__ import annotations

import torch

from stereo_match_traditional_tpu_torch.ops import on_cuda
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_cuda,
    asw_cuda,
    window_cost_cuda,
)

# The invalid-disparity marker of the post chains (``ops.post.INVALID``)
INVALID = float("inf")


def _clamped_range(start: int, stop: int, size: int, device) -> torch.Tensor:
    return torch.arange(start, stop, device=device).clamp_(0, size - 1)


def replicate_pad(img: torch.Tensor, pad_r: int, pad_c: int = None) -> torch.Tensor:
    """`copyMakeBorder(BORDER_REPLICATE)` on the last two axes."""
    if pad_c is None:
        pad_c = pad_r
    h, w = img.shape[-2:]
    rows = _clamped_range(-pad_r, h + pad_r, h, img.device)
    cols = _clamped_range(-pad_c, w + pad_c, w, img.device)
    return img.index_select(-2, rows).index_select(-1, cols)


def shifted_stack(
    img: torch.Tensor, disp_range: int, view: str = "left", d_offset: int = 0
) -> torch.Tensor:
    """Stack of horizontally shifted copies ``S[d, ..., i, j]``.

    view='left':  ``S[d, i, j] = img[i, max(j - d, 0)]`` (`SAD/Sad.h:130`).
    view='right': ``S[d, i, j] = img[i, min(j + d, W-1)]`` (`SAD/Sad.h:173`).
    ``d_offset`` starts the disparity block at ``d_offset``.
    """
    w = img.shape[-1]
    cols = torch.arange(w, device=img.device)[None, :]
    ds = torch.arange(disp_range, device=img.device)[:, None] + d_offset
    if view == "left":
        idx = (cols - ds).clamp_(0, w - 1)  # [D, W]
    elif view == "right":
        idx = (cols + ds).clamp_(0, w - 1)
    else:
        raise ValueError(view)
    # img [..., H, W] indexed on the last axis by [D, W] -> [..., H, D, W]
    return img[..., idx].movedim(-2, 0)


def border_fill(vol: torch.Tensor, view: str = "left") -> torch.Tensor:
    """Replace the invalid triangle with the last-valid-d cost:
    ``out[d, i, j] = vol[min(d, j), i, j]`` for the left view and
    ``min(d, W-1-j)`` for the right view (`ASW/ASW.h:371`,
    `AD-Census.h:88-92`)."""
    d, h, w = vol.shape
    if min(d - 1, w) <= 0:
        return vol
    cols = torch.arange(w, device=vol.device)[None, :]
    dd = torch.arange(d, device=vol.device)[:, None]
    lim = cols if view == "left" else (w - 1 - cols)
    eff = torch.minimum(dd, lim)  # [D, W], always in [0, D)
    return torch.gather(vol, 0, eff[:, None, :].expand(d, h, w))


def right_volume_from_left(vol_left: torch.Tensor) -> torch.Tensor:
    """Right-view volume by the exact shift identity
    ``costR(q, d) = costL(q + d, d)`` (`ASW/ASW.h:382-431`), with the
    ``q + d > W - 1`` triangle filled by :func:`border_fill` ``('right')``."""
    d, h, w = vol_left.shape
    cols = torch.arange(w, device=vol_left.device)[None, :]
    ds = torch.arange(d, device=vol_left.device)[:, None]
    idx = torch.clamp(cols + ds, max=w - 1)  # [D, W]
    shifted = torch.gather(vol_left, 2, idx[:, None, :].expand(d, h, w))
    return border_fill(shifted, "right")


def true_div(x: torch.Tensor, n: float) -> torch.Tensor:
    """``x / n`` by IEEE division on every device.  torch's CUDA kernels turn
    a division by a Python number into a multiplication by its reciprocal,
    which can differ in the last bit; a divisor tensor on ``x``'s device is
    divided elementwise, as the JAX package's (unjitted) ops do."""
    return torch.div(x, torch.tensor(n, dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# box sums
# ---------------------------------------------------------------------------


def _window_sums(x: torch.Tensor, radius: int, dim: int) -> torch.Tensor:
    """Sums of ``2*radius+1`` consecutive entries along ``dim`` ('valid'):
    differences of a float64 cumulative sum with a leading zero."""
    n = 2 * radius + 1
    c = x.cumsum(dim)
    c = torch.cat([torch.zeros_like(c.narrow(dim, 0, 1)), c], dim)
    m = x.shape[dim] - n + 1
    return c.narrow(dim, n, m) - c.narrow(dim, 0, m)


def box_sum_valid(x: torch.Tensor, radius_r: int, radius_c: int) -> torch.Tensor:
    """Sum over (2rr+1)x(2rc+1) windows, 'valid' mode: ``[..., Hp, Wp]`` ->
    ``[..., Hp-2rr, Wp-2rc]`` (the JAX package's banded matmuls at HIGHEST
    precision, `SAD/Sad.h:15-20`).

    Summed in float64 and rounded once to ``x``'s dtype.  For integer
    values whose window sums stay below 2^24 (u8 SAD terms, 128-centred NCC
    products up to 31x31 windows) every float32 partial sum is exact too, so
    the result is bit-exact with JAX and with the CUDA kernel in any order.
    No conv or matmul, so TF32 never enters.
    """
    s = _window_sums(x.to(torch.float64), radius_r, -2)
    return _window_sums(s, radius_c, -1).to(x.dtype)


def box_sum_same(x: torch.Tensor, radius_r: int, radius_c: int) -> torch.Tensor:
    """Box sum with zero padding, output the shape of the input."""
    xp = torch.nn.functional.pad(x, (radius_c, radius_c, radius_r, radius_r))
    return box_sum_valid(xp, radius_r, radius_c)


# ---------------------------------------------------------------------------
# SAD cost
# ---------------------------------------------------------------------------


def sad_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    winsize: int,
    view: str = "left",
    mean: bool = False,
    channel_min: bool = False,
) -> torch.Tensor:
    """Windowed SAD volume (`SAD/Sad.h:96-182`; ``mean`` is the window mean
    of `CBLSM/CBLSM.h:17-22`).

    The radius is ``winsize + 1`` (`SAD/Sad.h:109`): a 9x9 window for
    winsize=3.  Inputs are the unpadded ``[H, W]`` images; they are
    replicate-padded here (`SAD/SADmain.cpp:47-48`), the shifted stack of
    the padded image is differenced, box-summed and border-filled.

    ``channel_min=True`` is the dormant colour variant `sadvalueMeanV4`
    (`CBLSM/CBLSM.h:45-63` via `ComputeDispV4` `:494-532`): the inputs are
    ``[H, W, C]``, rows and columns are edge-padded, and a pixel's term is
    the minimum over channels of ``|L_c - R_c|`` (the reference's uchar
    accumulator overflow is not reproduced, as in the JAX package).

    CUDA tensors launch ``window_cost_cuda.sad_volume_cuda``, CPU tensors
    run :func:`_sad_volume_plain`.
    """
    if on_cuda(left, right):
        return window_cost_cuda.sad_volume_cuda(left, right, disp_range, winsize, view, mean,
                                                channel_min)
    return _sad_volume_plain(left, right, disp_range, winsize, view, mean, channel_min)


def _sad_volume_plain(left, right, disp_range, winsize, view="left", mean=False,
                      channel_min=False):
    """The plain body of :func:`sad_volume`: the shifted stack of the
    padded image, differenced, box-summed and border-filled."""
    if view not in ("left", "right"):
        raise ValueError(f"view must be 'left' or 'right', got {view!r}")
    if channel_min and (left.dim() != 3 or left.shape != right.shape):
        raise ValueError(
            f"channel_min needs a pair of [H, W, C] images, got {tuple(left.shape)} "
            f"and {tuple(right.shape)}"
        )
    r = winsize + 1
    lf = left.to(torch.float32)
    rf = right.to(torch.float32)
    # one [Hp, Wp] plane a channel; the term is the minimum over the planes
    planes_l = replicate_pad(lf.movedim(-1, 0) if channel_min else lf[None], r)
    planes_r = replicate_pad(rf.movedim(-1, 0) if channel_min else rf[None], r)
    diff = None
    for lp, rp in zip(planes_l, planes_r):
        if view == "left":
            t = torch.abs(lp[None] - shifted_stack(rp, disp_range, "left"))
        else:
            t = torch.abs(shifted_stack(lp, disp_range, "right") - rp[None])
        diff = t if diff is None else torch.minimum(diff, t)
    vol = box_sum_valid(diff, r, r)
    if mean:
        vol = true_div(vol, float((2 * r + 1) ** 2))
    return border_fill(vol, view)


# ---------------------------------------------------------------------------
# NCC cost
# ---------------------------------------------------------------------------


def ncc_interior_mask(
    h: int, w: int, win_size: int, row_offset: int = 0, global_rows: int = None, device=None
) -> torch.Tensor:
    """Pixels the NCC reference computes (loop bounds `NCC/NCC.h:72-75`);
    the rest keep 0 disparity from `Mat::zeros` (`NCC_main.cpp:20`).
    ``row_offset`` / ``global_rows`` place an ``[h, w]`` row band in an image
    of ``global_rows`` rows (the row executors, ``parallel``)."""
    if global_rows is None:
        global_rows = h
    rows = torch.arange(h, device=device)[:, None] + row_offset
    cols = torch.arange(w, device=device)[None, :]
    return ((rows >= win_size) & (rows < global_rows - win_size)
            & (cols >= win_size) & (cols < w - win_size))


def ncc_sums(left: torch.Tensor, right: torch.Tensor, win_size: int):
    """The 128-centred images and their four window sums (``sum_l``,
    ``sum_l2``, ``sum_r``, ``sum_r2``), zero-padded as ``box_sum_same``.

    Centring at 128 is exact for u8 inputs and keeps the one-pass
    sum-of-products formula from cancelling on raw u8 magnitudes (sums near
    1.7e7, where the float32 ulp is 2).  CUDA tensors take the sums from
    ``window_cost_cuda.ncc_sums_cuda``, CPU tensors from
    :func:`_ncc_sums_plain`."""
    if on_cuda(left, right):
        sums = window_cost_cuda.ncc_sums_cuda(left, right, win_size)
        return left.to(torch.float32) - 128.0, right.to(torch.float32) - 128.0, sums
    return _ncc_sums_plain(left, right, win_size)


def _ncc_sums_plain(left, right, win_size):
    """The plain body of :func:`ncc_sums`: four box sums."""
    lf = left.to(torch.float32) - 128.0
    rf = right.to(torch.float32) - 128.0
    sums = box_sum_same(torch.stack([lf, lf * lf, rf, rf * rf]), win_size, win_size)
    return lf, rf, sums.unbind(0)


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device (torch's CPU
    float32 ``sqrt`` is an ulp off for ~0.6 % of inputs): taken in float64
    and rounded once."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def ncc_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int,
    invalid_mode: str = "ignore",
    eps: float = 1e-12,
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
):
    """Normalized cross-correlation volume (`NCC/NCC.h:15-95`).

    ``d_offset`` builds the slice of disparities ``d_offset .. d_offset +
    disp_range - 1`` (the ``(tile, disp)`` runners, ``parallel``): entry d
    is global disparity ``d_offset + d``, in the shifted reads and in the
    validity test.

    Returns ``(volume [D, H, W], interior [H, W] bool)``.  The volume holds
    the correlation in [-1, 1]; where the right window would cross the left
    edge (``j - win_size - d < 0``, `NCC.h:81-89`) it holds -2 under
    ``invalid_mode='ignore'`` (never wins the argmax) or 255 under
    ``'sentinel'`` (the reference's 0xff quirk, `NCC.h:59,88`).  The window
    sums are zero-padded at the image border.  A window whose sum of squared
    deviations is below 0.5 (flat, for u8 inputs) gets the never-wins -2,
    as the reference's 0/0 NaN never wins its tracker (`NCC.h:46,59`).
    ``row_offset`` / ``global_rows`` place a row band in the image for the
    interior mask, as in :func:`ncc_interior_mask`.

    The correlation follows the JAX package's operation order, and every
    operation is correctly rounded, so the result is the same on every
    device: torch's CPU float32 ``sqrt`` is not (it is an ulp off for ~0.6 %
    of inputs), so the root is taken in float64 and rounded once.

    CUDA tensors launch ``window_cost_cuda.ncc_volume_cuda`` (the mask is
    built beside it), CPU tensors run :func:`_ncc_volume_plain`.
    """
    if on_cuda(left, right):
        vol = window_cost_cuda.ncc_volume_cuda(left, right, disp_range, win_size,
                                               _ncc_sentinel(invalid_mode), eps, d_offset)
        h, w = left.shape
        return vol, ncc_interior_mask(h, w, win_size, row_offset, global_rows, left.device)
    return _ncc_volume_plain(left, right, disp_range, win_size, invalid_mode, eps, row_offset,
                             global_rows, d_offset)


def _ncc_volume_plain(left, right, disp_range, win_size, invalid_mode="ignore", eps=1e-12,
                      row_offset=0, global_rows=None, d_offset=0):
    """The plain body of :func:`ncc_volume`: box sums of the centred images
    and of their shifted products."""
    sentinel = _ncc_sentinel(invalid_mode)
    w = win_size
    n = float((2 * w + 1) ** 2)
    h, wd = left.shape
    lf, rf, (sum_l, sum_l2, sum_r, sum_r2) = _ncc_sums_plain(left, right, w)
    sum_lr = box_sum_same(lf[None] * shifted_stack(rf, disp_range, "left", d_offset), w, w)
    sum_r_d = shifted_stack(sum_r, disp_range, "left", d_offset)
    sum_r2_d = shifted_stack(sum_r2, disp_range, "left", d_offset)
    num = sum_lr - true_div(sum_l[None] * sum_r_d, n)
    var_l = torch.clamp(sum_l2 - true_div(sum_l * sum_l, n), min=0.0)
    var_r = torch.clamp(sum_r2_d - true_div(sum_r_d * sum_r_d, n), min=0.0)
    ncc = num / _sqrt_rn(torch.clamp(var_l[None] * var_r, min=eps))
    ncc = torch.where((var_l[None] < 0.5) | (var_r < 0.5), -2.0, ncc)
    cols = torch.arange(wd, device=lf.device)[None, None, :]
    ds = torch.arange(disp_range, device=lf.device)[:, None, None] + d_offset
    vol = torch.where(cols - w - ds >= 0, ncc, sentinel)
    return vol, ncc_interior_mask(h, wd, w, row_offset, global_rows, lf.device)


def _ncc_sentinel(invalid_mode: str) -> float:
    if invalid_mode not in ("ignore", "sentinel"):
        raise ValueError(f"invalid_mode must be 'ignore' or 'sentinel', got {invalid_mode!r}")
    return 255.0 if invalid_mode == "sentinel" else -2.0


def ncc_shifted_depth(
    left: torch.Tensor,
    right: torch.Tensor,
    max_offset: int = 79,
    kernel_size: int = 5,
    view: str = "left",
    add_constant: bool = False,
    depth_scale: int = 3,
    row_offset: int = 0,
    global_rows: int = None,
) -> torch.Tensor:
    """Dormant whole-image shifted-NCC depth map (`ncc`, `NCC/NCC.h:117-272`,
    disabled at `NCC_main.cpp:24`).

    For each offset 1..max_offset the matching image is shifted along the
    columns, its first (left view) or last ``offset`` columns keeping their
    unshifted values (`NCC.h:150-158`); a border-truncated
    ``(2k+1)^2`` NCC is formed and the first strictly greatest offset wins;
    the output is ``(offset) * depth_scale`` (`NCC.h:262`), 0 where no NCC
    exceeds the tracker's -2 start.  The reference's quirks are kept: the
    divisor ``(rows_in - 1)(cols_in - 1)`` (`NCC.h:188`), the second division
    by it (`NCC.h:221`) and NaN never winning (mapped to -inf);
    ``add_constant`` adds 10 to the right image (`NCC.h:128-131`).

    ``row_offset`` / ``global_rows`` place an edge-padded row band in an
    image of ``global_rows`` rows (the row executors, ``parallel``): rows
    outside the image count as absent from the window sums and the counts
    use global rows, so a band's own rows equal the whole image's.
    Divisions are IEEE and the roots correctly rounded, as in unjitted JAX.
    """
    k = kernel_size
    lf = left.to(torch.float32)
    rf = right.to(torch.float32)
    if add_constant:
        rf = rf + 10.0
    h, w = lf.shape
    dev = lf.device
    banded = global_rows is not None
    if global_rows is None:
        global_rows = h
    grow = torch.arange(h, device=dev) + row_offset            # global row ids
    if banded:
        inrow = ((grow >= 0) & (grow < global_rows))[:, None]
        lf = torch.where(inrow, lf, 0.0)
        rf = torch.where(inrow, rf, 0.0)
    cols = torch.arange(w, device=dev)[None, :]
    offs = torch.arange(1, max_offset + 1, device=dev)[:, None]   # [O, 1]
    if view == "left":
        idx = torch.where(cols >= offs, cols - offs, cols)
        moving, fixed = rf[:, idx].movedim(1, 0), lf                 # [O, H, W]
    else:
        idx = torch.where(cols < w - offs, cols + offs, cols)
        moving, fixed = lf[:, idx].movedim(1, 0), rf

    # border-truncated window sums (zero padding == skipping out-of-range)
    s_fix, s_fix2 = box_sum_same(torch.stack([fixed, fixed * fixed]), k, k).unbind(0)
    s_mov = box_sum_same(moving, k, k)
    s_mov2 = box_sum_same(moving * moving, k, k)
    s_cross = box_sum_same(fixed[None] * moving, k, k)

    ii = grow[:, None]
    jj = torch.arange(w, device=dev)[None, :]
    rows_in = (ii + k).clamp(max=global_rows - 1) - (ii - k).clamp(min=0) + 1
    cols_in = (jj + k).clamp(max=w - 1) - (jj - k).clamp(min=0) + 1
    cnt = (rows_in * cols_in).to(torch.float32)             # true element count
    n = ((rows_in - 1) * (cols_in - 1)).to(torch.float32)   # the reference's divisor

    mu_f = s_fix / n
    mu_m = s_mov / n
    num = s_cross - mu_f[None] * s_mov - mu_m * s_fix[None] + cnt[None] * mu_f[None] * mu_m
    var_f = s_fix2 - 2.0 * mu_f * s_fix + cnt * mu_f * mu_f
    var_m = s_mov2 - 2.0 * mu_m * s_mov + cnt[None] * mu_m * mu_m
    res = (num / n[None]) / (
        _sqrt_rn(torch.clamp(var_f / n, min=0.0))[None]
        * _sqrt_rn(torch.clamp(var_m / n[None], min=0.0))
    ) / n[None]
    res = torch.where(torch.isnan(res), float("-inf"), res)   # NaN never wins `>`

    # strict-greater tracker started at -2 (`NCC.h:139,254`): the first max wins
    best = torch.argmax(res, dim=0)
    best_val = torch.amax(res, dim=0)
    depth = (best + 1) * depth_scale
    return torch.where(best_val > -2.0, depth, 0).to(torch.float32)


# ---------------------------------------------------------------------------
# AD cost, census transform + Hamming volume, fused AD-Census
# ---------------------------------------------------------------------------


def ad_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    view: str = "left",
    d_offset: int = 0,
) -> torch.Tensor:
    """Pixelwise absolute-difference volume (`AD-Census.h:75-129`).  The
    reference's previous-d copy at the border equals the clamped-column
    gather for a pixelwise cost, so no fill pass is needed, which also makes
    any slice of disparities ``d_offset .. d_offset + disp_range - 1``
    computable on its own (the ``(tile, disp)`` runners, ``parallel``).

    CUDA tensors launch ``ad_census_cuda.ad_volume_cuda``, CPU tensors run
    :func:`_ad_volume_plain`."""
    if on_cuda(left, right):
        return ad_census_cuda.ad_volume_cuda(left, right, disp_range, view, d_offset)
    return _ad_volume_plain(left, right, disp_range, view, d_offset)


def _ad_volume_plain(left, right, disp_range, view="left", d_offset=0):
    """The plain body of :func:`ad_volume`: the shifted stack, differenced."""
    left = left.to(torch.float32)
    right = right.to(torch.float32)
    if view == "left":
        return torch.abs(left[None] - shifted_stack(right, disp_range, "left", d_offset))
    return torch.abs(shifted_stack(left, disp_range, "right", d_offset) - right[None])


def census_transform(
    img: torch.Tensor,
    rows: int = 9,
    cols: int = 7,
    row_offset: int = 0,
    global_rows: int = None,
) -> torch.Tensor:
    """Census signature per pixel as one int64 (`AD-Census.h:166-192`).

    For each offset of the rows x cols window in row-major order the code
    shifts left once and gains a 1 iff ``center > neighbor`` and the
    neighbor lies inside the image; the centre offset takes part (always 0).
    The JAX package keeps the same bits in two int32 words;
    ``(hi << 32) | (lo & 0xFFFFFFFF)`` is this value.  At most 63 bits, so
    the signature is never negative and an arithmetic shift is safe on it.

    ``row_offset`` / ``global_rows`` place an ``[h, w]`` row band in an image
    of ``global_rows`` rows (the row executors, ``parallel``): a neighbour
    is in the image by its global row.  A neighbour row beyond the band
    wraps around it, as the JAX package's ``jnp.roll`` does (only the band's
    halo rows, which the executors drop, read one).
    """
    if rows * cols > 63:
        raise ValueError(
            f"census window {rows}x{cols} needs {rows * cols} bits; the "
            "signature holds at most 63"
        )
    x = img.to(torch.float32)
    h, w = x.shape
    if global_rows is None:
        global_rows = h
    sig = torch.zeros((h, w), dtype=torch.int64, device=x.device)
    for r in range(-(rows // 2), rows // 2 + 1):
        ri = torch.arange(h, device=x.device) + r
        r_in = (ri + row_offset >= 0) & (ri + row_offset < global_rows)
        xr = x.index_select(0, ri % h)
        for c in range(-(cols // 2), cols // 2 + 1):
            ci = torch.arange(w, device=x.device) + c
            inb = r_in[:, None] & ((ci >= 0) & (ci < w))[None, :]
            bit = (x > xr.index_select(1, ci.clamp(0, w - 1))) & inb
            sig = (sig << 1) | bit.to(torch.int64)
    return sig


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each non-negative int64 (SWAR; torch has no popcount)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def census_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    rows: int = 9,
    cols: int = 7,
    view: str = "left",
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
) -> torch.Tensor:
    """Hamming-distance census volume (`AD-Census.h:142-269`), float32.

    Signatures are computed once and gathered at the clamped match column,
    as the JAX package does; inside the d > j triangle this differs from
    the C++ reference, which recomputes the right signature per (pixel, d).
    ``row_offset`` / ``global_rows`` as in :func:`census_transform`;
    ``d_offset`` as in :func:`ad_volume`.

    CUDA tensors launch ``ad_census_cuda.census_volume_cuda``, CPU tensors
    run :func:`_census_volume_plain`.
    """
    if on_cuda(left, right):
        return ad_census_cuda.census_volume_cuda(left, right, disp_range, rows, cols, view,
                                                 row_offset, global_rows, d_offset)
    return _census_volume_plain(left, right, disp_range, rows, cols, view, row_offset,
                                global_rows, d_offset)


def _census_volume_plain(left, right, disp_range, rows=9, cols=7, view="left", row_offset=0,
                         global_rows=None, d_offset=0):
    """The plain body of :func:`census_volume`: both signatures, the
    shifted stack of one, XOR and a popcount."""
    cl = census_transform(left, rows, cols, row_offset, global_rows)
    cr = census_transform(right, rows, cols, row_offset, global_rows)
    if view == "left":
        x = cl[None] ^ shifted_stack(cr, disp_range, "left", d_offset)
    else:
        x = shifted_stack(cl, disp_range, "right", d_offset) ^ cr[None]
    return popcount64(x).to(torch.float32)


def ad_census_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    sigma_c: float = 10.0,
    sigma_s: float = 30.0,
    census_rows: int = 9,
    census_cols: int = 7,
    view: str = "left",
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
) -> torch.Tensor:
    """Fused AD-Census cost (`AD-Census.h:271-318`):
    ``(1 - exp(-AD/sigmaC)) + (1 - exp(-census/sigmaS))``; ``row_offset`` /
    ``global_rows`` as in :func:`census_transform`, ``d_offset`` as in
    :func:`ad_volume`.

    CUDA tensors launch ``ad_census_cuda.ad_census_volume_cuda``, CPU
    tensors run :func:`_ad_census_volume_plain`.
    """
    if on_cuda(left, right):
        return ad_census_cuda.ad_census_volume_cuda(
            left, right, disp_range, sigma_c, sigma_s, census_rows, census_cols, view,
            row_offset, global_rows, d_offset)
    return _ad_census_volume_plain(left, right, disp_range, sigma_c, sigma_s, census_rows,
                                   census_cols, view, row_offset, global_rows, d_offset)


def _ad_census_volume_plain(left, right, disp_range, sigma_c=10.0, sigma_s=30.0,
                            census_rows=9, census_cols=7, view="left", row_offset=0,
                            global_rows=None, d_offset=0):
    """The plain body of :func:`ad_census_volume`: the AD and census
    volumes' plain bodies, each through its exponential."""
    ad = _ad_volume_plain(left, right, disp_range, view, d_offset)
    cen = _census_volume_plain(left, right, disp_range, census_rows, census_cols, view,
                               row_offset, global_rows, d_offset)
    return (1.0 - torch.exp(-ad / sigma_c)) + (1.0 - torch.exp(-cen / sigma_s))


def ad_census_volumes(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    sigma_c: float = 10.0,
    sigma_s: float = 30.0,
    census_rows: int = 9,
    census_cols: int = 7,
    row_offset: int = 0,
    global_rows: int = None,
    d_offset: int = 0,
):
    """Both views ``(vol_l, vol_r)`` of :func:`ad_census_volume`: one launch
    of ``ad_census_cuda.ad_census_volumes_cuda`` for CUDA tensors (each
    value computed once and stored to both views), a plain body a view for
    CPU tensors."""
    if on_cuda(left, right):
        return ad_census_cuda.ad_census_volumes_cuda(
            left, right, disp_range, sigma_c, sigma_s, census_rows, census_cols, row_offset,
            global_rows, d_offset)
    return _ad_census_volumes_plain(left, right, disp_range, sigma_c, sigma_s, census_rows,
                                    census_cols, row_offset, global_rows, d_offset)


def _ad_census_volumes_plain(left, right, disp_range, sigma_c=10.0, sigma_s=30.0,
                             census_rows=9, census_cols=7, row_offset=0, global_rows=None,
                             d_offset=0):
    """The plain body of :func:`ad_census_volumes`."""
    return tuple(
        _ad_census_volume_plain(left, right, disp_range, sigma_c, sigma_s, census_rows,
                                census_cols, v, row_offset, global_rows, d_offset)
        for v in ("left", "right")
    )


def ad_volumes(left: torch.Tensor, right: torch.Tensor, disp_range: int):
    """Both views ``(vol_l, vol_r)`` of :func:`ad_volume`: one launch of
    ``ad_census_cuda.ad_volumes_cuda`` for CUDA tensors, a plain body a view
    for CPU tensors."""
    if on_cuda(left, right):
        return ad_census_cuda.ad_volumes_cuda(left, right, disp_range)
    return _ad_volumes_plain(left, right, disp_range)


def _ad_volumes_plain(left, right, disp_range):
    """The plain body of :func:`ad_volumes`."""
    return tuple(_ad_volume_plain(left, right, disp_range, v) for v in ("left", "right"))


# ---------------------------------------------------------------------------
# ASW (adaptive support weight) cost
# ---------------------------------------------------------------------------


def _space_mask(radius: int, space_sigma: float, device=None) -> torch.Tensor:
    """Gaussian proximity mask over the support window (`ASW/ASW.h:16-35`;
    never normalized)."""
    ax = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    return torch.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / (2.0 * space_sigma**2))


def asw_volume(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    view: str = "left",
) -> torch.Tensor:
    """Adaptive-support-weight cost volume (`ASW/ASW.h:210-257,329-431`).

    cost(p, d) = sum_o wL(p,o) * wR(p-d,o) * e(p,o,d) / sum_o wL*wR with
    w(p,o) = exp(-|I(p)-I(p+o)|^2 / 2 sigma_c^2) * exp(-|o|^2 / 2 sigma_s^2)
    and e = min(|L(p+o) - R(p+o-d)|, T).

    CUDA tensors launch ``asw_cuda.asw_volume_left_cuda`` on the pair (the
    right view on the mirrored pair, as :func:`asw_volume_right` takes it)
    and fill its border triangle; CPU tensors run :func:`_asw_volume_plain`.
    """
    if not on_cuda(left, right):
        return _asw_volume_plain(left, right, disp_range, win_size, space_sigma, color_sigma,
                                 truncation, view)
    if view not in ("left", "right"):
        raise ValueError(view)
    lf = left.to(torch.float32).contiguous()
    rf = right.to(torch.float32).contiguous()
    if view == "right":
        lf, rf = torch.flip(rf, [1]), torch.flip(lf, [1])
    raw = asw_cuda.asw_volume_left_cuda(lf, rf, disp_range, win_size + 1, space_sigma,
                                        color_sigma, truncation)
    vol = border_fill(raw, "left")
    return torch.flip(vol, [2]) if view == "right" else vol


def _asw_volume_plain(left, right, disp_range, win_size=11, space_sigma=50.0,
                      color_sigma=30.0, truncation=40.0, view="left"):
    """The plain body of :func:`asw_volume`: a loop over the (2R+1)^2
    window offsets, R = win_size + 1, doing the JAX reference's
    ``lax.scan`` step math in the same order on [D, H, W] tensors."""
    if view == "right":
        return asw_volume_right(
            left, right, disp_range, win_size, space_sigma, color_sigma, truncation
        )
    radius = win_size + 1
    lf = left.to(torch.float32)
    rf = right.to(torch.float32)
    h, w = lf.shape
    side = 2 * radius + 1
    space = _space_mask(radius, space_sigma, lf.device).tolist()

    lp = replicate_pad(lf, radius)
    rp = replicate_pad(rf, radius)
    # A[d] = min(|L - R(. - d)|, T) on padded images; the shift stack clamps
    # at the left edge but those entries are overwritten by border_fill.
    err = torch.clamp(torch.abs(lp[None] - shifted_stack(rp, disp_range, "left")),
                      max=truncation)  # [D, Hp, Wp]
    l_c = lp[radius : radius + h, radius : radius + w]
    r_c = rp[radius : radius + h, radius : radius + w]
    inv = 2.0 * color_sigma**2

    num = torch.zeros((disp_range, h, w), dtype=torch.float32, device=lf.device)
    den = torch.zeros_like(num)
    for dy in range(side):
        for dx in range(side):
            sp = space[dy][dx]
            l_sh = lp[dy : dy + h, dx : dx + w]
            r_sh = rp[dy : dy + h, dx : dx + w]
            w_l = torch.exp(-((l_sh - l_c) ** 2) / inv) * sp
            w_r = torch.exp(-((r_sh - r_c) ** 2) / inv) * sp
            # wR evaluated at p - d: the weight map shifted by d
            wlr = w_l[None] * shifted_stack(w_r, disp_range, "left")
            num += wlr * err[:, dy : dy + h, dx : dx + w]
            den += wlr
    vol = num / torch.clamp(den, min=1e-20)
    return border_fill(vol, "left")


def asw_volume_right(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
) -> torch.Tensor:
    """Right-view ASW volume (`ASW/ASW.h:382-431`) by mirror symmetry: the
    left-view problem on horizontally flipped images with the roles
    swapped: plain PyTorch on every device."""
    vol = _asw_volume_plain(
        torch.flip(right, [1]), torch.flip(left, [1]), disp_range, win_size,
        space_sigma, color_sigma, truncation, "left",
    )
    return torch.flip(vol, [2])


def _gauss_band_matrix(n: int, radius: int, sigma: float, device=None) -> torch.Tensor:
    """Banded Gaussian matrix ``G[q, p] = exp(-(q-p)^2 / 2 sigma^2)`` for
    ``|q - p| <= radius``, 0 outside: a truncated 1-D Gaussian blur as a
    matrix product.  Two of them factor the 2-D ASW space mask
    (`getGausssianMask`, `ASW/ASW.h:16-35`, is separable)."""
    i = torch.arange(n, device=device)
    dqp = (i[:, None] - i[None, :]).to(torch.float32)
    g = torch.exp(true_div(-(dqp * dqp), 2.0 * sigma * sigma))
    return torch.where(torch.abs(dqp) <= radius, g, 0.0)


def _linspace_f32(start: float, stop: float, num: int) -> list:
    """``num`` float32 values from ``start`` to ``stop`` by ``jnp.linspace``'s
    formula: ``start * (1 - t) + stop * t`` with ``t = i / (num - 1)`` for
    i < num - 1, then ``stop``.  (``torch.linspace`` steps from both ends; JAX
    compiles its formula and rounds some values an ulp apart from it.)"""
    div = num - 1
    f32 = dict(dtype=torch.float32)
    t = torch.arange(div, **f32) / torch.tensor(float(div), **f32)
    head = torch.tensor(start, **f32) * (1.0 - t) + torch.tensor(stop, **f32) * t
    return head.tolist() + [float(torch.tensor(stop, **f32))]


def asw_volume_approx_grid(
    left: torch.Tensor,
    right: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    bins: int = 12,
    row_offset: int = 0,
    global_rows: int = None,
) -> torch.Tensor:
    """Approximate left-view ASW volume by an intensity-binned bilateral grid
    (``ASWConfig(approx='grid')``, opt-in and not the reference's cost):

        J_b(p) = blur(k_b * e_d)(p) / blur(k_b)(p),
        cost(p, d) = sum_b hat_b(I_L(p)) J_b(p),

    with ``k_b = exp(-(I_L - c_b)^2 / 2 sigma_c^2)`` over ``bins`` centres
    ``linspace(0, 255, bins)``, ``e_d = min(|L - R(. - d)|, T)``, ``blur``
    the truncated Gaussian space mask as two banded matrix products, and
    hat weights interpolating the two nearest centres.  The right window
    weight is dropped (a single-guidance grid).

    The blurs are float64 matrix products rounded to float32 once, so no
    TF32 setting of the caller's enters and the CPU and the card agree; the
    JAX package multiplies in float32 at HIGHEST precision.

    ``row_offset`` / ``global_rows`` place an edge-padded row band in an
    image of ``global_rows`` rows (the row executors, ``parallel``): rows
    outside the image weigh nothing in the blurs, as the whole image's blur
    has nothing there.
    """
    if bins < 2:
        raise ValueError(
            f"asw approx='grid' needs bins >= 2 (got {bins}): the hat "
            "interpolation between intensity centers is degenerate below "
            "two bins — raise ASWConfig(approx_bins=...)"
        )
    lf = left.to(torch.float32)
    rf = right.to(torch.float32)
    h, w = lf.shape
    radius = win_size + 1
    e = torch.clamp(torch.abs(lf[None] - shifted_stack(rf, disp_range, "left")),
                    max=truncation)                                    # [D, H, W]
    gh = _gauss_band_matrix(h, radius, space_sigma, lf.device).to(torch.float64)
    gw = _gauss_band_matrix(w, radius, space_sigma, lf.device).to(torch.float64)
    row_ok = None
    if global_rows is not None:
        gr = torch.arange(h, device=lf.device) + row_offset
        row_ok = ((gr >= 0) & (gr < global_rows)).to(torch.float32)[:, None]

    def blur(x):
        return torch.matmul(torch.matmul(gh, x.to(torch.float64)), gw).to(torch.float32)

    step = 255.0 / (bins - 1)
    inv2sc = 1.0 / (2.0 * color_sigma * color_sigma)
    out = torch.zeros_like(e)
    for c in _linspace_f32(0.0, 255.0, bins):
        kb = torch.exp(-((lf - c) ** 2) * inv2sc)                     # [H, W]
        if row_ok is not None:
            kb = kb * row_ok
        jb = blur(kb[None] * e) / torch.clamp(blur(kb), min=1e-20)[None]
        hat = torch.clamp(1.0 - true_div(torch.abs(lf - c), step), min=0.0)
        out = out + hat[None] * jb
    return border_fill(out, "left")


def asw_lab_volume(
    left_gray: torch.Tensor,
    right_gray: torch.Tensor,
    left_lab: torch.Tensor,
    right_lab: torch.Tensor,
    disp_range: int,
    win_size: int = 11,
    space_sigma: float = 50.0,
    color_sigma: float = 30.0,
    truncation: float = 40.0,
    faithful_lut: bool = False,
) -> torch.Tensor:
    """Dormant Yoon-Kweon-style Lab-weight ASW variant (`ComputeWeigtColor`
    `ASW/ASW.h:49-80`, `ComputeProximity` `:82-105`, `ComputeCost`
    `:148-175`).

    A window pixel's colour weight is the mean of three per-Lab-channel
    Gaussians, its proximity weight the space mask; the cost is the weighted
    mean absolute grey difference, truncated at the cost level
    (`ASW.h:171-173`, unlike the active path, which truncates each pixel's
    error).  ``faithful_lut=True`` reproduces the reference's cast of that
    mean (in (0, 1]) to an int used as an index into the colour LUT
    (`ASW.h:76-77`); ``.to(torch.int32)`` truncates as the cast does.

    Plain PyTorch on every device: a loop over the (2R+1)^2 window offsets,
    R = win_size + 1, each step the JAX package's ``lax.scan`` step on
    ``[D, H, W]`` tensors.
    """
    radius = win_size + 1
    side = 2 * radius + 1
    lg = replicate_pad(left_gray.to(torch.float32), radius)
    rg = replicate_pad(right_gray.to(torch.float32), radius)
    ll = replicate_pad(left_lab.to(torch.float32).movedim(-1, 0), radius)    # [3, Hp, Wp]
    rl = replicate_pad(right_lab.to(torch.float32).movedim(-1, 0), radius)
    h, w = left_gray.shape
    space = _space_mask(radius, space_sigma, lg.device).tolist()
    inv2sc = 1.0 / (2.0 * color_sigma * color_sigma)

    def channel_weight(lab_sh, lab_c):
        g3 = torch.exp(-((lab_sh - lab_c) ** 2) * inv2sc)      # [3, H, W]
        mean3 = true_div(g3[0] + g3[1] + g3[2], 3.0)
        if faithful_lut:
            idx = mean3.to(torch.int32).to(torch.float32)      # 0 or 1
            return torch.exp(-(idx * idx) * inv2sc)
        return mean3

    err = torch.abs(lg[None] - shifted_stack(rg, disp_range, "left"))   # [D, Hp, Wp]
    ll_c = ll[:, radius : radius + h, radius : radius + w]
    rl_c = rl[:, radius : radius + h, radius : radius + w]
    num = torch.zeros((disp_range, h, w), dtype=torch.float32, device=lg.device)
    den = torch.zeros_like(num)
    for dy in range(side):
        for dx in range(side):
            sp = space[dy][dx]
            w_l = channel_weight(ll[:, dy : dy + h, dx : dx + w], ll_c) * sp
            w_r = channel_weight(rl[:, dy : dy + h, dx : dx + w], rl_c) * sp
            wlr = w_l[None] * shifted_stack(w_r, disp_range, "left")
            num += wlr * err[:, dy : dy + h, dx : dx + w]
            den += wlr
    vol = torch.clamp(num / torch.clamp(den, min=1e-20), max=truncation)
    return border_fill(vol, "left")
