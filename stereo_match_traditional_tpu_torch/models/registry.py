"""Pipeline registry of the port: the JAX package's five pipelines, and
re-entry into them from saved stage volumes."""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

import numpy as np
import torch

from stereo_match_traditional_tpu_torch import config as _cfg
from stereo_match_traditional_tpu_torch.models.ad_census import (
    ad_census_finish,
    ad_census_pipeline,
)
from stereo_match_traditional_tpu_torch.models.asw import asw_finish, asw_pipeline
from stereo_match_traditional_tpu_torch.models.cblsm import cblsm_finish, cblsm_pipeline
from stereo_match_traditional_tpu_torch.models.ncc import ncc_finish, ncc_pipeline
from stereo_match_traditional_tpu_torch.models.sad import sad_finish, sad_pipeline
from stereo_match_traditional_tpu_torch.ops.aggregate import Arms

PIPELINES: Dict[str, Tuple[Callable, Type]] = {
    "sad": (sad_pipeline, _cfg.SADConfig),
    "ncc": (ncc_pipeline, _cfg.NCCConfig),
    "asw": (asw_pipeline, _cfg.ASWConfig),
    "ad_census": (ad_census_pipeline, _cfg.ADCensusConfig),
    "cblsm": (cblsm_pipeline, _cfg.CBLSMConfig),
}


def get_pipeline(name: str):
    """``(pipeline_fn, config_class)`` of a pipeline."""
    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(PIPELINES)}")
    return PIPELINES[name]


def _tensor(x):
    """A tensor keeps its device; anything else goes to the card (the
    entry-point rule: pass CPU tensors to finish on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device="cuda")


def finish_from_volumes(name: str, vol_l, vol_r, cfg, arms_left=None):
    """Re-enter a pipeline at the WTA stage from saved stage volumes.

    ``vol_l``/``vol_r`` are the ``aggregated_left``/``aggregated_right``
    (or ``cost_*`` for pipelines without aggregation) volumes that a
    ``return_stages=True`` run produced, e.g. reloaded with
    `utils.checkpoint.load_array` after a failure (by either package): on
    the same device the result equals the original run's maps bit for bit.
    Tensors keep their device; NumPy arrays go to the card.

    The canonical ad_census mode (``aggregation='cross_two_pass'`` with
    ``run_post``) also needs ``arms_left``, the left arm maps its region
    voting fills from, saved by ``return_stages`` / ``--save-stages`` as
    ``arms_left_{left,right,up,down}``: an `ops.aggregate.Arms`, a 4-tuple
    in that field order, or a dict with those keys.
    """
    if name not in PIPELINES:
        raise KeyError(f"unknown pipeline {name!r}; have {sorted(PIPELINES)}")
    vol_l = _tensor(vol_l)
    vol_r = None if vol_r is None else _tensor(vol_r)
    if name == "sad":
        return sad_finish(vol_l, vol_r, cfg)
    if name == "ncc":
        return ncc_finish(vol_l, cfg)
    if vol_r is None:
        raise ValueError(
            f"finish_from_volumes({name!r}) needs both views' volumes "
            "(the reference driver computes left AND right maps); only "
            "'sad'/'ncc' re-enter from a left volume alone"
        )
    if name == "asw":
        return asw_finish(vol_l, vol_r, cfg)
    if name == "cblsm":
        return cblsm_finish(vol_l, vol_r, cfg)
    arms = None
    if cfg.run_post and cfg.aggregation == "cross_two_pass":
        if arms_left is None:
            raise ValueError(
                "finish_from_volumes: the canonical (cross_two_pass) post "
                "chain needs the left arm maps — pass arms_left= (saved by "
                "--save-stages / return_stages as arms_left_{left,right,"
                "up,down}), or finish with run_post=False"
            )
        if isinstance(arms_left, dict):
            arms_left = [arms_left[k] for k in Arms._fields]
        arms = Arms(*(_tensor(a) for a in arms_left))
    return ad_census_finish(vol_l, vol_r, cfg, arms)
