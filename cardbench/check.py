"""Whether the maps the window delivered are right.

The plain reference that the configuration names (``cardbench/reference/``)
computes each sampled map's pair again from the pair's pixels alone, on the
run's device, after the window has closed and the program's state is
freed.  The number compared is ``pixels_off``: the largest share, over the
sampled maps, of pixels whose served disparity differs from the
reference's (two invalid pixels agree).  Its limit is the cell's, in
``limits/<workload>.json``, set from the readings that
``cardbench/control.py`` takes on the card.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def reference_module(name: str):
    """``cardbench/reference/<name>.py``, the plain reference a configuration
    file names; it has ``disparity(left, right, fields, disp_range, dtype)``."""
    if not name.isidentifier():
        raise ValueError(f"not a reference module's name: {name!r}")
    return importlib.import_module(f"cardbench.reference.{name}")


def reference_maps(pairs: Sequence[Tuple[np.ndarray, np.ndarray]], indices, conf: dict,
                   disp_range: int, device, dtype=torch.float32) -> Dict[int, np.ndarray]:
    """``{k: the reference's map of pairs[k]}`` for each ``k`` in ``indices``,
    under the configuration file ``conf``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_module(conf["reference"])
    out = {}
    for k in sorted(set(indices)):
        left, right = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in pairs[k])
        out[k] = ref.disparity(left, right, conf["fields"], disp_range, dtype).cpu().numpy()
    return out


def pixels_off(served: np.ndarray, ref: np.ndarray) -> float:
    """The share of pixels where the two maps differ."""
    if served.shape != ref.shape:
        return 1.0
    return float(np.count_nonzero(served != ref)) / served.size


def readings(sample: Dict[int, np.ndarray], pairs: Sequence, conf: dict, disp_range: int,
             device) -> List[float]:
    """``pixels_off`` of each sampled map (delivered as the ``k``-th map of
    the window, of the pair ``k % len(pairs)``)."""
    refs = reference_maps(pairs, [k % len(pairs) for k in sample], conf, disp_range, device)
    return [pixels_off(m, refs[k % len(pairs)]) for k, m in sorted(sample.items())]
