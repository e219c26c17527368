"""The port's CUDA kernel on the card, against its plain PyTorch version.

This file imports neither jax nor the JAX package's jax modules, so on a
machine with a card and no jax it runs without the suite's conftest:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Without a CUDA device every ``cuda`` test skips itself; the wrapper's
input checks are tested everywhere.
"""

import pytest
import torch

from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import volume
from stereo_match_traditional_tpu_torch.ops.kernels import asw_cuda
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

# (h, w, D, win_size, seed, view): tests/test_kernels.py's geometries, a
# ragged serving-range tile and the reference driver's size.
GEOMETRIES = [
    (14, 18, 5, 2, 2, "left"),
    (12, 20, 4, 1, 5, "right"),
    (20, 30, 6, 11, 1, "left"),
    (37, 70, 130, 11, 4, "left"),
    (375, 450, 60, 11, 0, "left"),
]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,win,seed,view", GEOMETRIES)
def test_kernel_matches_plain_on_card(h, w, d, win, seed, view):
    """rtol 1e-4, atol 1e-3 (tests/test_kernels.py's tolerance): the kernel
    fuses the two colour weights and the space weight into one exp, the
    plain version multiplies three, so the last bits differ."""
    _need_card()
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    lt, rt = pair_to_torch(L, R, "cuda")
    before = asw_cuda.LAUNCHES
    got = asw_cuda.asw_volume_cuda(lt, rt, d, win, view=view)
    torch.cuda.synchronize()
    assert asw_cuda.LAUNCHES == before + 1
    want = volume.asw_volume(lt, rt, d, win, view=view)
    assert got.shape == (d, h, w)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
def test_pipeline_launches_kernel_once_per_call():
    _need_card()
    L, R, _ = make_pair(40, 64, 8, seed=1)
    lt, rt = pair_to_torch(L, R, "cuda")
    fn, cfg_cls = get_pipeline("asw")
    cfg = cfg_cls(disp_range=8, win_size=3)
    before = asw_cuda.LAUNCHES
    res = fn(lt, rt, cfg)
    torch.cuda.synchronize()
    assert asw_cuda.LAUNCHES == before + 1
    plain = fn(lt, rt, cfg_cls(disp_range=8, win_size=3, use_pallas=False))
    assert asw_cuda.LAUNCHES == before + 1
    agree = (res.disp_final == plain.disp_final).float().mean().item()
    assert agree >= 0.99, agree


@pytest.mark.parametrize("bad", ["dtype", "ndim", "device", "shape"])
def test_launch_checks_inputs(bad):
    """The raw launch raises before it reaches the library."""
    x = torch.zeros((8, 9), dtype=torch.float32)
    left, right = x, x
    if bad == "dtype":
        left = x.to(torch.uint8)
    elif bad == "ndim":
        left = x[None]
    elif bad == "shape":
        right = torch.zeros((8, 10), dtype=torch.float32)
    if bad != "device" and torch.cuda.is_available():
        left, right = left.cuda(), right.cuda()
    with pytest.raises(ValueError):
        asw_cuda._launch_left(left, right, 4, 2, 50.0, 30.0, 40.0)


@pytest.mark.cuda
def test_mixed_devices_rejected():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        asw_cuda.asw_volume_cuda(x.cuda(), x, 4, 2)
