"""Executors over row bands (torch counterpart of
``stereo_match_traditional_tpu.parallel``): the single-card streamed
executor and the row-band cores it shares with the tiled one.  The
multi-device executors (tiled, the sharded scanline, WTA and post, the
distributed mesh) come in a later slice (ROADMAP.md Queue 1 item 9)."""

from stereo_match_traditional_tpu_torch.parallel.halo import crop_row_halo  # noqa: F401
from stereo_match_traditional_tpu_torch.parallel.streamed import (  # noqa: F401
    auto_row_tile,
    run_streamed,
    streamed_canonical_staged,
    streamed_pipeline,
)
from stereo_match_traditional_tpu_torch.parallel.tiled import receptive_field_rows  # noqa: F401
