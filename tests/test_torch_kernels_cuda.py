"""The port's CUDA kernels on the card, against their plain PyTorch versions.

This file imports neither jax nor the JAX package's jax modules, so on a
machine with a card and no jax it runs without the suite's conftest:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Without a CUDA device every ``cuda`` test skips itself; the wrapper's
input checks are tested everywhere.
"""

import pytest
import torch

from stereo_match_traditional_tpu.config import ScanlineConfig
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import scanline, volume
from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, asw_cuda, scanline_cuda
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


# (h, w, D, seed) for the AD-Census kernels: odd shapes, D > W, Teddy
AD_CENSUS_GEOMETRIES = [(13, 17, 5, 3), (9, 6, 10, 5), (375, 450, 60, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,seed", AD_CENSUS_GEOMETRIES)
@pytest.mark.parametrize("view", ["left", "right"])
def test_ad_census_kernel_matches_plain_on_card(h, w, d, seed, view):
    """AD and Hamming parts exact; the cost within rtol/atol 1e-6 (expf's
    last ulp; torch divides by a scalar through its reciprocal)."""
    _need_card()
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    lt, rt = pair_to_torch(L, R, "cuda")
    before = ad_census_cuda.LAUNCHES
    got = ad_census_cuda.ad_census_volume_cuda(lt, rt, d, view=view)
    ad = ad_census_cuda.ad_volume_cuda(lt, rt, d, view)
    cen = ad_census_cuda.census_volume_cuda(lt, rt, d, view=view)
    torch.cuda.synchronize()
    assert ad_census_cuda.LAUNCHES == before + 3
    assert torch.equal(ad, volume.ad_volume(lt, rt, d, view))
    assert torch.equal(cen, volume.census_volume(lt, rt, d, view=view))
    torch.testing.assert_close(got, volume.ad_census_volume(lt, rt, d, view=view),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [
    ScanlineConfig(),
    ScanlineConfig(faithful_vertical_l2=True),
    ScanlineConfig(faithful_vertical_p2=True),
    ScanlineConfig(faithful_vertical_l2=True, faithful_vertical_p2=True),
    ScanlineConfig(penalty_scale="auto"),
], ids=["canonical", "vert_l2", "vert_p2", "vert_l2_p2", "auto_scale"])
@pytest.mark.parametrize("h,w,d,seed", [(13, 17, 5, 3), (9, 6, 10, 5), (40, 70, 40, 1)])
def test_scanline_kernel_bit_exact_on_card(cfg, h, w, d, seed):
    """Same float operations in the same order as the plain loop."""
    _need_card()
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    lt, rt = pair_to_torch(L, R, "cuda")
    vol = volume.ad_census_volume(lt, rt, d)
    before = scanline_cuda.LAUNCHES
    got = scanline_cuda.scanline_optimize_cuda(vol, lt, cfg)
    torch.cuda.synchronize()
    assert scanline_cuda.LAUNCHES == before + 1
    assert torch.equal(got, scanline.scanline_optimize(vol, lt, cfg))


@pytest.mark.cuda
def test_ad_census_pipeline_launches_kernels():
    """FULL: two cost launches (left, right) and one scanline launch per
    call; the disparities agree with the same pipeline on CPU tensors."""
    _need_card()
    L, R, _ = make_pair(40, 64, 8, seed=1)
    fn, cfg_cls = get_pipeline("ad_census")
    cfg = cfg_cls(disp_range=8, scanline=ScanlineConfig(), run_post=True)
    before = (ad_census_cuda.LAUNCHES, scanline_cuda.LAUNCHES)
    res = fn(*pair_to_torch(L, R, "cuda"), cfg)
    torch.cuda.synchronize()
    assert (ad_census_cuda.LAUNCHES, scanline_cuda.LAUNCHES) == (before[0] + 2, before[1] + 1)
    plain = fn(*pair_to_torch(L, R, "cpu"), cfg)
    for f in ("disp_left", "disp_final"):
        agree = (getattr(res, f).cpu() == getattr(plain, f)).float().mean().item()
        assert agree >= 0.99, (f, agree)


@pytest.mark.parametrize("bad", ["view", "shape", "window"])
def test_ad_census_launch_checks_inputs(bad):
    """The raw launch raises before it reaches the library."""
    x = torch.zeros((8, 9), dtype=torch.uint8)
    left, right, view, rows = x, x, "left", 9
    if bad == "view":
        view = "up"
    elif bad == "shape":
        right = torch.zeros((8, 10), dtype=torch.uint8)
    else:
        rows = 10
    if torch.cuda.is_available():
        left, right = left.cuda(), right.cuda()
    with pytest.raises(ValueError):
        ad_census_cuda._launch(left, right, 4, rows, 7, 10.0, 30.0, view, "cost")


@pytest.mark.cuda
def test_scanline_kernel_checks_inputs():
    _need_card()
    x = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        scanline_cuda.scanline_optimize_cuda(torch.zeros((4, 8, 9)).cuda(), x)
    with pytest.raises(ValueError):
        scanline_cuda.scanline_optimize_cuda(torch.zeros((1025, 8, 9)).cuda(), x.cuda())
    with pytest.raises(ValueError):
        scanline_cuda.scanline_optimize_cuda(torch.zeros((4, 8, 9)).cuda(), x[:4].cuda())
