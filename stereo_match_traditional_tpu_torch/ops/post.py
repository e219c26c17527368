"""Post-processing (torch counterpart of
``stereo_match_traditional_tpu.ops.post``): the functions the ASW post
chain runs, each bit-exact with its JAX counterpart."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from stereo_match_traditional_tpu_torch.ops.volume import replicate_pad

INVALID = float("inf")


class LRResult(NamedTuple):
    disp: torch.Tensor
    occlusion: torch.Tensor  # bool [H, W]
    mismatch: torch.Tensor   # bool [H, W]


def lr_check_simple(
    disp_left: torch.Tensor,
    disp_right: torch.Tensor,
    gate: float = 5.0,
    invalid_value: float = INVALID,
) -> LRResult:
    """Integer-index LR check (`SAD/Sad.h:184-222`, `ASW/ASW.h:108-145`).

    Compares dL(j) with dR(j - int(dL)); |diff| > gate invalidates the
    pixel, classified as occlusion when dL < dR else mismatch.  The column
    is clamped into the image (the reference reads out of bounds).
    """
    h, w = disp_left.shape
    dl = disp_left.to(torch.float32)
    drf = disp_right.to(torch.float32)
    jj = torch.arange(w, device=dl.device)[None, :]
    idx = (jj - dl.to(torch.int32)).clamp_(0, w - 1)
    dr = torch.gather(drf, 1, idx)
    bad = torch.abs(dl - dr) > gate
    occl = bad & (dl < dr)
    mism = bad & ~occl
    return LRResult(torch.where(bad, invalid_value, dl), occl, mism)


def _speckle_edges(d, valid, diff_insame, connectivity):
    """Flat (p, q) index pairs of every connected neighbor pair: both
    members valid and ``|d(p) - d(q)| <= diff_insame`` (`Sad.h:294`)."""
    h, w = d.shape
    idx = torch.arange(h * w, device=d.device).reshape(h, w)
    dirs = [(0, -1), (-1, 0)]
    if connectivity == 8:
        dirs += [(-1, 1), (-1, -1)]
    src, dst = [], []
    for dy, dx in dirs:
        r0, r1 = max(0, -dy), h - max(0, dy)
        c0, c1 = max(0, -dx), w - max(0, dx)
        p = (slice(r0, r1), slice(c0, c1))
        q = (slice(r0 + dy, r1 + dy), slice(c0 + dx, c1 + dx))
        m = valid[p] & valid[q] & (torch.abs(d[p] - d[q]) <= diff_insame)
        src.append(idx[p][m])
        dst.append(idx[q][m])
    return torch.cat(src), torch.cat(dst)


def remove_speckles(
    disp: torch.Tensor,
    diff_insame: float = 1.0,
    min_speckle_area: int = 80,
    invalid_value: float = INVALID,
    background: Optional[float] = None,
    connectivity: int = 8,
    block: Optional[int] = None,
) -> torch.Tensor:
    """Connected-component speckle filter (`SAD/Sad.h:251-315`; OpenCV
    ``filterSpeckles`` with ``connectivity=4``, `ASW/ASWeight.cpp:73`).

    Members are pixels ``!= invalid_value``; neighbors connect when their
    disparities differ by <= ``diff_insame``; components smaller than
    ``min_speckle_area`` become ``invalid_value``.

    Only component areas reach the output, so any exact labelling gives the
    JAX result.  Here: every pixel starts labelled with its own flat index;
    each sweep takes the min label across every connected pair, hooks that
    min onto both old labels, and pointer-jumps once (``label[label]``).
    Labels always name a pixel of their own component and only decrease,
    so the loop stops at the fixpoint, where each component holds one
    label.  The loop checks for the fixpoint on the host once per sweep.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if background is not None or block is not None:
        raise NotImplementedError(
            "remove_speckles(background=..., block=...) is not ported yet "
            "(ROADMAP.md Queue 1 items 5 and 7)"
        )
    h, w = disp.shape
    d = disp.to(torch.float32)
    valid = torch.isfinite(d) & (d != invalid_value)
    src, dst = _speckle_edges(d, valid, diff_insame, connectivity)

    labels = torch.arange(h * w, device=d.device)
    while True:
        ls, ld = labels[src], labels[dst]
        m = torch.minimum(ls, ld)
        new = labels.clone()
        for target in (src, dst, ls, ld):
            new.scatter_reduce_(0, target, m, "amin")
        new = new[new]
        if torch.equal(new, labels):
            break
        labels = new

    vflat = valid.reshape(-1)
    counts = torch.bincount(labels[vflat], minlength=h * w)
    area = counts[labels].reshape(h, w)
    kill = valid & (area < min_speckle_area)
    return torch.where(kill, invalid_value, d)


def median_filter(x: torch.Tensor, size: int, border: str = "truncate") -> torch.Tensor:
    """Window median with OpenCV ``medianBlur`` borders
    (``border='replicate'``, `ASWeight.cpp:74,78`): the middle of the
    ``(2*(size//2)+1)^2`` window values."""
    if border != "replicate":
        raise NotImplementedError(
            f"median_filter(border={border!r}) is not ported yet "
            "(ROADMAP.md Queue 1 item 3, ad_census FULL)"
        )
    radius = size // 2
    side = 2 * radius + 1
    h, w = x.shape
    xp = replicate_pad(x.to(torch.float32), radius)
    stack = torch.stack(
        [xp[dy : dy + h, dx : dx + w] for dy in range(side) for dx in range(side)]
    )
    # odd count: the lower median is the middle element
    return stack.median(dim=0).values


def fill_image_new(disp: torch.Tensor) -> torch.Tensor:
    """`FillImageNew` (`ASW/ASW.h:434-511`): zero-valued pixels take the
    nearest non-zero value to the left, else the nearest to the right,
    else 0, all read from the pre-fill map."""
    d = disp.to(torch.float32)
    h, w = d.shape
    valid = d != 0
    pos = torch.arange(w, device=d.device)[None, :].expand(h, w)
    # for a zero pixel the nearest valid column at-or-before (at-or-after)
    # it is strictly before (after) it
    prev = torch.where(valid, pos, -1).cummax(dim=1).values
    nxt = torch.where(valid, pos, w).flip(1).cummin(dim=1).values.flip(1)
    lv = torch.gather(d, 1, prev.clamp(min=0))
    rv = torch.gather(d, 1, nxt.clamp(max=w - 1))
    fill = torch.where(prev >= 0, lv, torch.where(nxt < w, rv, 0.0))
    return torch.where(valid, d, fill)
