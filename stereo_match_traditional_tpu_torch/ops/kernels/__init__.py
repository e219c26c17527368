"""Hand-written CUDA kernels (sources in ``csrc/``, built by ``build``)."""

from stereo_match_traditional_tpu_torch.ops.kernels.ad_census_cuda import (  # noqa: F401
    ad_census_volume_cuda,
    ad_census_volumes_cuda,
)
from stereo_match_traditional_tpu_torch.ops.kernels.asw_cuda import asw_volume_cuda  # noqa: F401
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_banded_cuda import (  # noqa: F401
    canonical_pass_banded_cuda,
    directional_pass_banded_cuda,
)
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_canonical_cuda import (  # noqa: F401
    scanline_optimize_canonical_cuda,
)
from stereo_match_traditional_tpu_torch.ops.kernels.scanline_cuda import (  # noqa: F401
    scanline_optimize_cuda,
)
from stereo_match_traditional_tpu_torch.ops.kernels.window_cost_cuda import (  # noqa: F401
    ncc_volume_cuda,
    sad_volume_cuda,
)
