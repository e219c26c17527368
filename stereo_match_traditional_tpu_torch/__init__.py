"""stereo_match_traditional_tpu_torch — the PyTorch/CUDA port of
``stereo_match_traditional_tpu``.

The port runs on torch tensors and never imports jax.  It grows slice by
slice beside the JAX package, which stays the reference it is tested
against.  Ported so far: the ``asw`` pipeline's active path, whose cost
volume is a hand-written CUDA kernel (``ops/kernels/csrc/asw_volume.cu``),
and the flagship ``ad_census`` pipeline with ``aggregation='rect_mean'``
in its active and FULL forms, whose cost volume and 4-path scanline are
hand-written CUDA kernels (``csrc/ad_census_cost.cu``, ``csrc/scanline.cu``).

The configuration dataclasses are the JAX package's own
(``stereo_match_traditional_tpu.config`` imports only dataclasses), so both
packages read one set of reference constants.

Device rule: every op takes the device of its input tensors.  A kernel's
plain PyTorch version runs only for tensors on the CPU; for a CUDA tensor
the kernel launches or the call raises.
"""

__version__ = "0.1.0"

from stereo_match_traditional_tpu.config import (  # noqa: F401
    ADCensusConfig,
    ASWConfig,
    ScanlineConfig,
)
