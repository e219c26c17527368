"""Port parity: the 4-path scanline optimizer of
``stereo_match_traditional_tpu_torch`` against the JAX package's
``lax.scan`` on the same volume (JAX on the CPU backend)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu.config import ScanlineConfig
from stereo_match_traditional_tpu.ops import scanline as jscan
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.utils.synthetic import make_pair
from stereo_match_traditional_tpu_torch.ops import scanline as tscan
from stereo_match_traditional_tpu_torch.ops.kernels import scanline_cuda
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict

CONFIGS = [
    ScanlineConfig(),
    ScanlineConfig(faithful_vertical_l2=True),
    ScanlineConfig(faithful_vertical_p2=True),
    ScanlineConfig(faithful_vertical_l2=True, faithful_vertical_p2=True),
    ScanlineConfig(penalty_scale="auto"),
]
CFG_IDS = ["canonical", "vert_l2", "vert_p2", "vert_l2_p2", "auto_scale"]


@functools.lru_cache(maxsize=None)
def _inputs(h, w, d, seed):
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    return np.asarray(jvol.ad_census_volume(L, R, d)), L


@pytest.mark.parametrize("cfg", CONFIGS, ids=CFG_IDS)
@pytest.mark.parametrize("h,w,d,seed", [(24, 32, 10, 1), (11, 7, 9, 4)],
                         ids=["24x32_D10", "11x7_D9"])
def test_scanline_optimize_bit_exact(cfg, h, w, d, seed):
    """Same float operations in the same order as the lax.scan step:
    exact equality, for every flag combination."""
    vol, gray = _inputs(h, w, d, seed)
    want = np.asarray(jscan.scanline_optimize(jnp.asarray(vol), jnp.asarray(gray), cfg))
    port_cfg = config_from_dict("ScanlineConfig", dataclasses.asdict(cfg))
    got = tscan.scanline_optimize(torch.tensor(vol), torch.tensor(gray), port_cfg).numpy()
    assert got.shape == (d, h, w) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_single_disparity_and_single_line():
    """D = 1 (both d pads at once) and a one-pixel-wide image."""
    rng = np.random.default_rng(5)
    for shape in [(1, 6, 5), (4, 7, 1)]:
        vol = rng.random(shape, dtype=np.float32)
        gray = rng.integers(0, 256, size=shape[1:]).astype(np.uint8)
        want = np.asarray(jscan.scanline_optimize(jnp.asarray(vol), jnp.asarray(gray)))
        got = tscan.scanline_optimize(torch.tensor(vol), torch.tensor(gray)).numpy()
        np.testing.assert_array_equal(got, want)


def test_kernel_wrapper_takes_plain_version_on_cpu():
    """``scanline_optimize`` on CPU tensors runs its plain body and launches
    nothing."""
    vol, gray = _inputs(24, 32, 10, 1)
    before = scanline_cuda.LAUNCHES
    got = tscan.scanline_optimize(torch.tensor(vol), torch.tensor(gray))
    assert scanline_cuda.LAUNCHES == before
    assert torch.equal(got, tscan._scanline_optimize_plain(torch.tensor(vol), torch.tensor(gray)))
