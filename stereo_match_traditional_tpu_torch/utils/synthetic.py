"""Synthetic rectified stereo pairs with ground truth.

The JAX package's generator is NumPy-only, so the port reuses it as it is:
both packages see the same pairs from the same seed.
"""

from stereo_match_traditional_tpu.utils.synthetic import (  # noqa: F401
    bad_pixel_rate,
    make_pair,
)
