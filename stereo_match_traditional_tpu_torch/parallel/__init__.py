"""Executors over row bands and devices (torch counterpart of
``stereo_match_traditional_tpu.parallel``): the single-card streamed
executor, and the multi-device ones over ``torch.distributed``, one process
a device: the tiled executor (row tiles with halo exchange, the sharded
scanline, WTA and post), the ``(tile, disp)`` runners and the mesh helpers.
The JAX package's ``gspmd_pipeline`` (a sharded-input XLA program) has no
torch counterpart."""

from stereo_match_traditional_tpu_torch.parallel.halo import (  # noqa: F401
    add_row_halo,
    crop_row_halo,
)
from stereo_match_traditional_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from stereo_match_traditional_tpu_torch.parallel.scan_carry import (  # noqa: F401
    scanline_optimize_sharded,
)
from stereo_match_traditional_tpu_torch.parallel.tiled import (  # noqa: F401
    ad_census_tile_disp,
    receptive_field_rows,
    run_tiled,
    tiled_pipeline,
)
from stereo_match_traditional_tpu_torch.parallel.streamed import (  # noqa: F401
    auto_row_tile,
    run_streamed,
    streamed_canonical_staged,
    streamed_pipeline,
)
from stereo_match_traditional_tpu_torch.parallel.wta_shard import (  # noqa: F401
    optimal_disparity_sharded,
    wta_sharded,
)
from stereo_match_traditional_tpu_torch.parallel.distributed import (  # noqa: F401
    host_chip_mesh,
    initialize,
)
