"""stereo_match_traditional_tpu_torch — the PyTorch/CUDA port of
``stereo_match_traditional_tpu``.

The port runs on torch tensors and never imports jax.  It grows slice by
slice beside the JAX package, which stays the reference it is tested
against.  Ported so far, through ``models.get_pipeline``: all five
pipelines.  ``asw`` (active path), whose cost volume is a hand-written CUDA
kernel (``ops/kernels/csrc/asw_volume.cu``); the flagship ``ad_census``
with ``aggregation='rect_mean'`` in its active and FULL forms, whose cost
volume and 4-path scanline are hand-written CUDA kernels
(``csrc/ad_census_cost.cu``, ``csrc/scanline.cu``); ``sad`` and ``ncc``,
whose windowed cost volumes are one hand-written CUDA kernel
(``csrc/window_cost.cu``); and ``cblsm`` (active and post), whose AD
volumes are the AD part of the AD-Census kernel.  Dormant variants,
canonical aggregation, surfaces and executors are not ported
(``ROADMAP.md`` Queue 1 items 6-9).

The port imports nothing of the JAX package.  ``config`` and
``utils.synthetic`` are its own copies of the JAX package's modules of the
same names (same classes, fields, defaults and bytes), and
``utils.convert.config_from_dict`` carries a JAX-package config across as
plain data.

Device rule: every op takes the device of its input tensors.  A kernel's
plain PyTorch version runs only for tensors on the CPU; for a CUDA tensor
the kernel launches or the call raises.
"""

__version__ = "0.1.0"

from stereo_match_traditional_tpu_torch.config import (  # noqa: F401
    ADCensusConfig,
    ASWConfig,
    CBLSMConfig,
    NCCConfig,
    SADConfig,
    ScanlineConfig,
)
