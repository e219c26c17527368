"""Carry inputs, configs and results between the outside and the port.

The system has no learned weights: its parameters are the frozen config
dataclasses and the input pair.  A JAX-package config comes across as plain
data (:func:`config_from_dict`), a NumPy pair through :func:`pair_to_torch`,
and a result goes back through :func:`result_to_numpy`; tests and
``chip_smoke.py`` feed the port through them.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from stereo_match_traditional_tpu_torch import config as _cfg
from stereo_match_traditional_tpu_torch.models.base import StereoResult


def config_from_dict(name: str, data: Mapping[str, Any]):
    """The port's config ``name`` from ``dataclasses.asdict`` of the
    JAX-package config of the same name.

    Nested configs (``arms``, ``scanline``, ``cross_params``) arrive as
    dicts and are rebuilt from the field's annotated class; a key the
    port's class does not have raises, so the two packages cannot drift
    apart unnoticed.
    """
    cls = getattr(_cfg, name, None)
    if not (isinstance(cls, type) and dataclasses.is_dataclass(cls)):
        raise KeyError(f"the port has no config class {name!r}")
    unknown = sorted(set(data) - {f.name for f in dataclasses.fields(cls)})
    if unknown:
        raise ValueError(f"{name} has no field(s) {unknown}")
    hints = typing.get_type_hints(cls)
    kw = {}
    for key, value in data.items():
        if isinstance(value, Mapping):
            # the field is annotated `SomeConfig` or `Optional[SomeConfig]`
            hint = hints[key]
            nested = next(
                t for t in (hint, *typing.get_args(hint)) if dataclasses.is_dataclass(t)
            )
            value = config_from_dict(nested.__name__, value)
        kw[key] = value
    return cls(**kw)


def pair_to_torch(
    left_np: np.ndarray, right_np: np.ndarray, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 ``[H, W]`` gray pair -> uint8 tensors on ``device`` (copies).

    The default is the card; where there is none the copy raises.  Pass
    ``"cpu"`` to run the plain versions, as the CPU tests do.
    """
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
