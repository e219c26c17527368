"""Pipeline registry of the port."""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Type

from stereo_match_traditional_tpu.config import ADCensusConfig, ASWConfig
from stereo_match_traditional_tpu_torch.models.ad_census import ad_census_pipeline
from stereo_match_traditional_tpu_torch.models.asw import asw_pipeline

PIPELINES: Dict[str, Tuple[Callable, Type]] = {
    "ad_census": (ad_census_pipeline, ADCensusConfig),
    "asw": (asw_pipeline, ASWConfig),
}

# Pipelines of the JAX package that the port does not run yet, with the
# ROADMAP.md Queue 1 item that ports each.
NOT_PORTED: Dict[str, str] = {
    "cblsm": "item 4 (cblsm)",
    "sad": "item 5 (sad + ncc)",
    "ncc": "item 5 (sad + ncc)",
}


def get_pipeline(name: str):
    """``(pipeline_fn, config_class)`` for a ported pipeline."""
    if name in PIPELINES:
        return PIPELINES[name]
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"pipeline {name!r} is not ported yet (ROADMAP.md Queue 1 "
            f"{NOT_PORTED[name]})"
        )
    raise KeyError(
        f"unknown pipeline {name!r}; have {sorted([*PIPELINES, *NOT_PORTED])}"
    )
