"""Trace scopes for pipeline stages."""

from __future__ import annotations

import torch


def stage_scope(name: str):
    """Named ``stereo/<stage>`` range in a `torch.profiler` trace, the
    counterpart of the JAX package's ``jax.named_scope`` stage scopes
    (stage names: ``cost_volume``, ``wta``, ``post``)."""
    return torch.profiler.record_function(f"stereo/{name}")
