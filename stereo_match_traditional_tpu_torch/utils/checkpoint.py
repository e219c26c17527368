"""Stage checkpointing, the counterpart of
``stereo_match_traditional_tpu.utils.checkpoint``.

Every stage artifact (cost volume, aggregated volume, raw / filtered
disparity, masks) can be saved as ``.npy`` and any stage re-entered from disk
(`models.registry.finish_from_volumes`): a rerun after a failure restarts
from the last saved stage instead of from the images.

Tensors (on any device) or arrays go in; the files are the ones the JAX
package writes for the same values (same names, dtypes, shapes and
``manifest.json``), so a stage directory written by either package can be
re-entered by the other.  Loads return NumPy arrays, as the JAX package's do.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from stereo_match_traditional_tpu_torch.models.base import StereoResult

_MANIFEST = "manifest.json"


def _numpy(arr) -> np.ndarray:
    """The logical values of ``arr`` as a C-contiguous array.  A tensor may
    be a strided view (the scanline kernels return ``[D, H, W]`` views of
    rows padded to 4 columns); only the view's values are kept."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(arr)


def save_array(directory: str, name: str, arr) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{name}.npy")
    np.save(path, _numpy(arr))
    return path


def load_array(directory: str, name: str) -> np.ndarray:
    return np.load(os.path.join(directory, f"{name}.npy"))


def has_stage(directory: str, name: str) -> bool:
    return os.path.exists(os.path.join(directory, f"{name}.npy"))


def save_result(directory: str, result: StereoResult, meta: Optional[Dict] = None) -> None:
    """Persist every populated StereoResult field plus a manifest."""
    os.makedirs(directory, exist_ok=True)
    fields = {}
    for name in result._fields:
        val = getattr(result, name)
        if val is not None:
            save_array(directory, name, val)
            fields[name] = f"{name}.npy"
    with open(os.path.join(directory, _MANIFEST), "w") as f:
        json.dump({"fields": fields, "meta": meta or {}}, f, indent=2)


def load_result(directory: str) -> StereoResult:
    """The saved fields as NumPy arrays (absent fields None)."""
    with open(os.path.join(directory, _MANIFEST)) as f:
        manifest = json.load(f)
    kwargs = {
        name: np.load(os.path.join(directory, fname))
        for name, fname in manifest["fields"].items()
    }
    return StereoResult(**kwargs)
