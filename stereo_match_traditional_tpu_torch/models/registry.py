"""Pipeline registry of the port: the JAX package's five pipelines."""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from stereo_match_traditional_tpu_torch import config as _cfg
from stereo_match_traditional_tpu_torch.models.ad_census import ad_census_pipeline
from stereo_match_traditional_tpu_torch.models.asw import asw_pipeline
from stereo_match_traditional_tpu_torch.models.cblsm import cblsm_pipeline
from stereo_match_traditional_tpu_torch.models.ncc import ncc_pipeline
from stereo_match_traditional_tpu_torch.models.sad import sad_pipeline

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
