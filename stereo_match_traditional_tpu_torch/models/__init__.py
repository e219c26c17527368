"""Stereo pipelines of the port."""

from stereo_match_traditional_tpu_torch.models.base import StereoResult  # noqa: F401
from stereo_match_traditional_tpu_torch.models.registry import get_pipeline  # noqa: F401
