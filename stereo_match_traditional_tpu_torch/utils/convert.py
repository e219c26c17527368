"""Carry inputs and results between NumPy and the port.

The system has no learned weights: its parameters are the frozen config
dataclasses (shared with the JAX package) and the input pair.  These two
functions are the whole carry-across; tests and ``chip_smoke.py`` feed both
packages through them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stereo_match_traditional_tpu_torch.models.base import StereoResult


def pair_to_torch(
    left_np: np.ndarray, right_np: np.ndarray, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 ``[H, W]`` gray pair -> uint8 tensors on ``device`` (copies)."""
    left_np = np.asarray(left_np)
    right_np = np.asarray(right_np)
    for name, a in (("left", left_np), ("right", right_np)):
        if a.dtype != np.uint8 or a.ndim != 2:
            raise ValueError(
                f"{name} image must be uint8 [H, W], got {a.dtype} {a.shape}"
            )
    if left_np.shape != right_np.shape:
        raise ValueError(f"pair shapes differ: {left_np.shape} vs {right_np.shape}")
    return tuple(torch.tensor(a, device=device) for a in (left_np, right_np))


def result_to_numpy(res: StereoResult) -> StereoResult:
    """A `StereoResult` of tensors -> the same fields as NumPy arrays."""
    return StereoResult(
        *(None if v is None else v.detach().cpu().numpy() for v in res)
    )
