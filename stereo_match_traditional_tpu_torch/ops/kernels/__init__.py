"""Hand-written CUDA kernels (sources in ``csrc/``, built by ``build``)."""

from stereo_match_traditional_tpu_torch.ops.kernels.asw_cuda import asw_volume_cuda  # noqa: F401
