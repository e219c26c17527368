"""The port's CUDA kernels on the card, against their plain PyTorch versions.

This file imports neither jax nor the JAX package's jax modules, so on a
machine with a card and no jax it runs without the suite's conftest:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

Without a CUDA device every ``cuda`` test skips itself; the wrapper's
input checks are tested everywhere.
"""

import pytest
import torch

from stereo_match_traditional_tpu_torch.config import (
    ADCensusConfig,
    CBLSMConfig,
    ScanlineConfig,
)
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import scanline, volume
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_cuda,
    asw_cuda,
    build,
    launch,
    scanline_canonical_cuda,
    scanline_cuda,
    window_cost_cuda,
)
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

# (h, w, D, win_size, seed, view): tests/test_kernels.py's geometries, a
# ragged serving-range tile, the reference driver's size and a 35x35 window
# (99 KB of shared memory, twice the reference window's tables).
GEOMETRIES = [
    (40, 70, 20, 16, 3, "left"),
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
    takes the weight as the product of a left and a right factor (two
    ex2.approx, each carrying half the space term), the plain version as
    one exp of the summed exponent, so the last bits differ."""
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
    """The single-view drop-ins, one launch each: AD and Hamming parts
    exact; the cost within rtol/atol 1e-6 (expf's last ulp; torch divides
    by a scalar through its reciprocal)."""
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
@pytest.mark.parametrize("h,w,d,seed", [(13, 17, 5, 3), (9, 6, 10, 5), (40, 70, 40, 1),
                                         (1, 40, 7, 1), (33, 1, 9, 2), (1, 1, 3, 4),
                                         (21, 45, 100, 6), (5, 37, 200, 10),
                                         (3, 1100, 20, 7), (2, 1062, 40, 8),
                                         (2, 1061, 130, 9)])
def test_scanline_kernel_bit_exact_on_card(cfg, h, w, d, seed):
    """Same float operations in the same order as the plain loop; the edge
    geometries (one row, one column, one pixel, a D above 32 that is no
    multiple of it, a D above 128, and rows wide enough for the kernel's
    16-column blocks with W a multiple of 4, even and odd) run on random
    costs."""
    _need_card()
    if min(h, w) > 1 and w < 1000:
        L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
        lt, rt = pair_to_torch(L, R, "cuda")
        vol = volume.ad_census_volume(lt, rt, d)
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lt = torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
        vol = torch.rand((d, h, w), device="cuda", generator=gen) * 3.0
    before = scanline_cuda.LAUNCHES
    got = scanline_cuda.scanline_optimize_cuda(vol, lt, cfg)
    torch.cuda.synchronize()
    assert scanline_cuda.LAUNCHES == before + 1
    assert torch.equal(got, scanline.scanline_optimize(vol, lt, cfg))


# (h, w, D, seed) beyond AD_CENSUS_GEOMETRIES for the both-view entry: one
# row, one column, W < 32, W % 4 != 0 over two strips with a D that is no
# multiple of the 32-disparity chunk, D > W over chunks, D=256, and 720p
AD_CENSUS_EDGES = [(1, 40, 7, 1), (33, 1, 9, 2), (9, 20, 12, 4), (20, 131, 33, 7),
                   (6, 9, 70, 8), (16, 300, 256, 9), (720, 1280, 128, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,seed", AD_CENSUS_GEOMETRIES + AD_CENSUS_EDGES)
def test_ad_census_both_views_on_card(h, w, d, seed):
    """One launch writes both views: the cost within rtol/atol 1e-6 of the
    plain version, the AD and Hamming parts exact; u8 images (tables for
    the exponentials) give the bits of the same integers as float32 (the
    direct formula)."""
    _need_card()
    lt, rt = _pair_on_card(h, w, d, seed)
    before = ad_census_cuda.LAUNCHES
    vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
    torch.cuda.synchronize()
    assert ad_census_cuda.LAUNCHES == before + 1
    for got, want in zip((vol_l, vol_r), volume.ad_census_volumes(lt, rt, d), strict=True):
        assert got.shape == (d, h, w) and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for got, want in zip(ad_census_cuda.ad_volumes_cuda(lt, rt, d), volume.ad_volumes(lt, rt, d),
                         strict=True):
        assert torch.equal(got, want)
    census = ad_census_cuda._launch(lt, rt, d, 9, 7, 1.0, 1.0, "both", "census")
    for got, view in zip(census, ("left", "right"), strict=True):
        assert torch.equal(got, volume.census_volume(lt, rt, d, view=view))
    as_float = ad_census_cuda.ad_census_volumes_cuda(lt.float(), rt.float(), d)
    assert torch.equal(as_float[0], vol_l) and torch.equal(as_float[1], vol_r)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(5, 5), (3, 7), (1, 63), (63, 1)])
def test_ad_census_other_windows_on_card(rows, cols):
    """A census window other than the pipelines' 9 x 7 takes the kernel's
    general census: the Hamming part exact and the cost within 1e-6 for
    both views, from one launch each."""
    _need_card()
    lt, rt = _pair_on_card(37, 150, 20, 6)
    before = ad_census_cuda.LAUNCHES
    cen = ad_census_cuda._launch(lt, rt, 20, rows, cols, 1.0, 1.0, "both", "census")
    cost = ad_census_cuda.ad_census_volumes_cuda(lt, rt, 20, 10.0, 30.0, rows, cols)
    torch.cuda.synchronize()
    assert ad_census_cuda.LAUNCHES == before + 2
    for i, view in enumerate(("left", "right")):
        assert torch.equal(cen[i], volume.census_volume(lt, rt, 20, rows, cols, view))
        torch.testing.assert_close(
            cost[i], volume.ad_census_volume(lt, rt, 20, 10.0, 30.0, rows, cols, view),
            rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_ad_census_pipeline_launches_kernels():
    """FULL: one cost launch (both views) and one scanline launch per
    call; the disparities agree with the same pipeline on CPU tensors."""
    _need_card()
    L, R, _ = make_pair(40, 64, 8, seed=1)
    fn, cfg_cls = get_pipeline("ad_census")
    cfg = cfg_cls(disp_range=8, scanline=ScanlineConfig(), run_post=True)
    before = (ad_census_cuda.LAUNCHES, scanline_cuda.LAUNCHES)
    res = fn(*pair_to_torch(L, R, "cuda"), cfg)
    torch.cuda.synchronize()
    assert (ad_census_cuda.LAUNCHES, scanline_cuda.LAUNCHES) == (before[0] + 1, before[1] + 1)
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
        scanline_cuda.scanline_optimize_cuda(
            torch.zeros((scanline_cuda.MAX_DISP + 1, 8, 9)).cuda(), x.cuda())
    with pytest.raises(ValueError):
        scanline_cuda.scanline_optimize_cuda(torch.zeros((4, 8, 9)).cuda(), x[:4].cuda())


# (h, w, D, winsize, seed) for the SAD kernel: odd shapes, D > W, a 61x61
# window (above 48 KB of shared memory), Teddy; then the edges of the sliding
# design: fewer rows than one run and than the window with several strips and
# a D that is no multiple of the 32-disparity chunk, one row, one column, a W
# that is no multiple of 4 with a ragged last strip, an even W that is no
# multiple of 4 (8-byte stores), the largest radius taken (65x65), and a W
# that is a multiple of 4 (16-byte stores) over several strips
SAD_GEOMETRIES = [(13, 17, 5, 1, 3), (9, 6, 10, 3, 5), (40, 70, 8, 29, 4), (375, 450, 60, 3, 0),
                  (5, 150, 70, 3, 6), (1, 40, 7, 2, 1), (33, 1, 9, 2, 2), (20, 131, 40, 4, 7),
                  (19, 134, 33, 3, 9), (70, 90, 12, 31, 8), (60, 256, 100, 3, 1)]


def _pair_on_card(h, w, d, seed):
    """A synthetic scene, or random u8 images where it is too small for one."""
    if min(h, w) == 1:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return tuple(torch.randint(0, 256, (h, w), device="cuda", generator=gen,
                                   dtype=torch.uint8) for _ in range(2))
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
    return pair_to_torch(L, R, "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("h,w,d,winsize,seed", SAD_GEOMETRIES)
def test_sad_kernel_bit_exact_on_card(h, w, d, winsize, seed, view, mean):
    """u8 inputs: every term is an integer and every sliding sum a sum over
    part of one window, so exact: bit-exact."""
    _need_card()
    lt, rt = _pair_on_card(h, w, d, seed)
    before = window_cost_cuda.LAUNCHES["sad_volume_f32"]
    got = window_cost_cuda.sad_volume_cuda(lt, rt, d, winsize, view, mean)
    torch.cuda.synchronize()
    assert window_cost_cuda.LAUNCHES["sad_volume_f32"] == before + 1
    assert torch.equal(got, volume.sad_volume(lt, rt, d, winsize, view, mean))
    # float32 images holding the same integers take the kernel's other load path
    assert torch.equal(window_cost_cuda.sad_volume_cuda(lt.float(), rt.float(), d, winsize,
                                                        view, mean), got)


# (h, w, D, win_size, seed) for the NCC kernel: odd shapes, Teddy at D=60
# and at the committed D=200; then the same edges as SAD's, D > W, and the
# largest window whose sums are exact (31x31)
NCC_GEOMETRIES = [(13, 17, 5, 2, 3), (40, 70, 40, 3, 1), (375, 450, 60, 10, 0),
                  (375, 450, 200, 10, 0), (5, 150, 70, 3, 6), (1, 40, 7, 2, 1), (33, 1, 9, 2, 2),
                  (20, 131, 40, 4, 7), (19, 134, 33, 3, 9), (9, 6, 10, 3, 5), (70, 90, 12, 15, 8),
                  (60, 256, 100, 10, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ignore", "sentinel"])
@pytest.mark.parametrize("h,w,d,win,seed", NCC_GEOMETRIES)
def test_ncc_kernel_bit_exact_on_card(h, w, d, win, seed, mode):
    """u8 inputs, win_size <= 15: exact sums, IEEE epilogue: bit-exact."""
    _need_card()
    lt, rt = _pair_on_card(h, w, d, seed)
    before = window_cost_cuda.LAUNCHES["ncc_volume_f32"]
    got, interior = window_cost_cuda.ncc_volume_cuda(lt, rt, d, win, mode)
    torch.cuda.synchronize()
    assert window_cost_cuda.LAUNCHES["ncc_volume_f32"] == before + 1
    want, want_in = volume.ncc_volume(lt, rt, d, win, mode)
    assert torch.equal(got, want) and torch.equal(interior, want_in)
    assert torch.equal(window_cost_cuda.ncc_volume_cuda(lt.float(), rt.float(), d, win, mode)[0],
                       got)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,win,seed", NCC_GEOMETRIES)
def test_ncc_sums_kernel_bit_exact_on_card(h, w, d, win, seed):
    """The sums kernel alone against ``volume.ncc_sums``: bit-exact for u8
    inputs; it is no launch of ``ncc_volume_f32``."""
    _need_card()
    lt, rt = _pair_on_card(h, w, d, seed)
    before = dict(window_cost_cuda.LAUNCHES)
    got = window_cost_cuda.ncc_sums_cuda(lt, rt, win)
    torch.cuda.synchronize()
    assert window_cost_cuda.LAUNCHES == before
    for g, want in zip(got, volume.ncc_sums(lt, rt, win)[2], strict=True):
        assert torch.equal(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,win", [(96, 128, 30, 17), (70, 90, 12, 32)],
                         ids=["win17", "largest_radius"])
def test_ncc_kernel_wide_window_on_card(h, w, d, win):
    """win_size above 15: the column sums are still exact, the last,
    horizontal sums of the products may round, in another order than the
    plain version's float64 sums: within a tolerance."""
    _need_card()
    L, R, _ = make_pair(h, w, d, seed=2)
    lt, rt = pair_to_torch(L, R, "cuda")
    got, _ = window_cost_cuda.ncc_volume_cuda(lt, rt, d, win)
    torch.testing.assert_close(got, volume.ncc_volume(lt, rt, d, win)[0], rtol=1e-5, atol=1e-5)
    for g, want in zip(window_cost_cuda.ncc_sums_cuda(lt, rt, win),
                       volume.ncc_sums(lt, rt, win)[2], strict=True):
        torch.testing.assert_close(g, want, rtol=1e-5, atol=0.0)


@pytest.mark.cuda
def test_window_kernels_float_inputs_on_card():
    """Non-integer inputs: the sliding float32 sums round along their walks
    (restarted every run of rows and of columns).  SAD's terms are of one
    sign: ``FLOAT_RTOL`` of the sum.  The NCC cross sum is signed: its error
    is ``FLOAT_RTOL`` of the sum of its terms' magnitudes, which for a
    texture uniform over [0, 255) is about ``sqrt(var_l * var_r)``, so the
    correlation is held to twice ``FLOAT_RTOL`` absolute."""
    _need_card()
    h, w, d, win = 150, 200, 40, 4
    rtol = window_cost_cuda.FLOAT_RTOL
    gen = torch.Generator(device="cuda").manual_seed(5)
    lt, rt = (t.float() + torch.rand((h, w), device="cuda", generator=gen)
              for t in _pair_on_card(h, w, d, 5))
    for view in ("left", "right"):
        torch.testing.assert_close(window_cost_cuda.sad_volume_cuda(lt, rt, d, win, view),
                                   volume.sad_volume(lt, rt, d, win, view), rtol=rtol, atol=0.0)
    lt = torch.rand((h, w), device="cuda", generator=gen) * 255.0
    rt = torch.roll(lt, -3, 1) + torch.rand((h, w), device="cuda", generator=gen) * 8.0
    n = float((2 * win + 1) ** 2)
    for g, want, one_sign in zip(window_cost_cuda.ncc_sums_cuda(lt, rt, win),
                                 volume.ncc_sums(lt, rt, win)[2], (False, True, False, True),
                                 strict=True):
        torch.testing.assert_close(g, want, rtol=rtol, atol=0.0 if one_sign else rtol * n * 128.0)
    torch.testing.assert_close(window_cost_cuda.ncc_volume_cuda(lt, rt, d, win)[0],
                               volume.ncc_volume(lt, rt, d, win)[0], rtol=0.0, atol=2 * rtol)


@pytest.mark.cuda
def test_sad_ncc_cblsm_pipelines_launch_kernels():
    """sad with post: two SAD launches; ncc: one NCC launch; cblsm: one AD
    launch of the AD-Census kernel (both views).  Each agrees with the CPU
    run."""
    _need_card()
    L, R, _ = make_pair(40, 64, 8, seed=1)
    runs = [("sad", dict(max_disparity=8, run_post=True), "sad_volume_f32", 2),
            ("ncc", dict(disp_range=8, win_size=3), "ncc_volume_f32", 1),
            ("cblsm", dict(disp_range=8, run_post=True), "ad_census_volume_f32", 1)]
    for name, kw, kernel, n in runs:
        fn, cfg_cls = get_pipeline(name)
        counts = dict(window_cost_cuda.LAUNCHES, ad_census_volume_f32=ad_census_cuda.LAUNCHES)
        res = fn(*pair_to_torch(L, R, "cuda"), cfg_cls(**kw))
        torch.cuda.synchronize()
        after = dict(window_cost_cuda.LAUNCHES, ad_census_volume_f32=ad_census_cuda.LAUNCHES)
        assert after == {**counts, kernel: counts[kernel] + n}, (name, counts, after)
        plain = fn(*pair_to_torch(L, R, "cpu"), cfg_cls(**kw))
        field = "disp_final" if kw.get("run_post") else "disp_left"
        agree = (getattr(res, field).cpu() == getattr(plain, field)).float().mean().item()
        assert agree >= 0.99, (name, agree)


@pytest.mark.parametrize("bad", ["shape", "ndim", "empty", "radius", "radius_zero", "no_rows",
                                 "no_columns", "negative_range", "device"])
def test_window_launch_checks_inputs(bad):
    """The window kernels' input checks raise before the library is reached."""
    x = torch.zeros((8, 9), dtype=torch.uint8)
    left, right, d, radius = x, x, 4, 3
    if bad == "shape":
        right = torch.zeros((8, 10), dtype=torch.uint8)
    elif bad == "ndim":
        left = right = x[None]
    elif bad == "empty":
        d = 0
    elif bad == "negative_range":
        d = -3
    elif bad == "radius":
        radius = window_cost_cuda.MAX_RADIUS + 1
    elif bad == "radius_zero":
        radius = 0
    elif bad == "no_rows":
        left = right = x[:0]
    elif bad == "no_columns":
        left = right = x[:, :0]
    else:   # two devices (no card needed for a tensor on the meta device)
        right = torch.zeros((8, 9), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        window_cost_cuda._check(left, right, d, radius)


def test_window_launch_check_takes_the_limits():
    """One pixel, one disparity, the smallest and the largest radius pass."""
    x = torch.zeros((1, 1), dtype=torch.uint8)
    window_cost_cuda._check(x, x, 1, 1)
    window_cost_cuda._check(x, x, 1, window_cost_cuda.MAX_RADIUS)


@pytest.mark.parametrize("dtypes,u8", [((torch.uint8, torch.uint8), 1),
                                       ((torch.float32, torch.float32), 0),
                                       ((torch.uint8, torch.float32), 0),
                                       ((torch.float64, torch.int32), 0)],
                         ids=["u8", "f32", "mixed", "other"])
def test_window_kernel_inputs(dtypes, u8):
    """The kernels read two uint8 images as they are; anything else goes to
    them as float32, contiguous either way."""
    left = (torch.arange(72).reshape(8, 9) % 251).to(dtypes[0]).t()   # not contiguous
    right = torch.ones((9, 8), dtype=dtypes[1])
    lk, rk, flag = launch.kernel_inputs(left, right)
    want = torch.uint8 if u8 else torch.float32
    assert flag == u8 and lk.dtype == rk.dtype == want
    assert lk.is_contiguous() and rk.is_contiguous()
    assert torch.equal(lk.to(torch.float64), left.to(torch.float64))


@pytest.mark.cuda
def test_window_kernels_reject_mixed_devices():
    _need_card()
    x = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        window_cost_cuda.sad_volume_cuda(x.cuda(), x, 4, 1)
    with pytest.raises(ValueError):
        window_cost_cuda.ncc_volume_cuda(x, x.cuda(), 4, 2)
    with pytest.raises(ValueError):
        window_cost_cuda.ncc_sums_cuda(x.cuda(), x, 2)


@pytest.mark.cuda
def test_window_kernels_reject_radius_without_launch():
    """A radius above the kernel's raises in the wrapper; nothing is launched."""
    _need_card()
    x = torch.zeros((8, 9), dtype=torch.uint8, device="cuda")
    before = dict(window_cost_cuda.LAUNCHES)
    big = window_cost_cuda.MAX_RADIUS + 1
    with pytest.raises(ValueError, match="radius"):
        window_cost_cuda.sad_volume_cuda(x, x, 4, big - 1)     # radius = winsize + 1
    with pytest.raises(ValueError, match="radius"):
        window_cost_cuda.ncc_volume_cuda(x, x, 4, big)
    with pytest.raises(ValueError, match="radius"):
        window_cost_cuda.ncc_sums_cuda(x, x, big)
    assert window_cost_cuda.LAUNCHES == before


# (h, w, D, winsize, seed) for the colour mode: one row, W % 4 != 0 and
# == 0, D > W, a 11x11 window, CBLSM's win_size 1 at Teddy
COLOUR_GEOMETRIES = [(1, 40, 7, 0, 1), (9, 21, 12, 1, 2), (40, 70, 100, 4, 3),
                     (12, 9, 20, 2, 4), (375, 450, 60, 1, 0)]


def _colour_pair_on_card(h, w, d, seed):
    if min(h, w) < 8:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return tuple(torch.randint(0, 256, (h, w, 3), device="cuda", generator=gen,
                                   dtype=torch.uint8) for _ in range(2))
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed, color=True)
    return torch.from_numpy(L).cuda(), torch.from_numpy(R).cuda()


@pytest.mark.cuda
def test_sad_kernel_channel_min_raises_without_launch():
    """The colour mode (``channel_min``): u8 ``[H, W, 3]`` pairs give the
    plain version bit for bit (every term an integer), both views, mean on
    and off, one launch a call; float32 pairs holding the same integers take
    the three-plane path and give the same bits; non-integer float32 pairs
    agree within ``FLOAT_RTOL`` of the largest window sum; a float32 radius
    above ``MAX_RADIUS_RGBF``
    raises before anything runs."""
    _need_card()
    for h, w, d, winsize, seed in COLOUR_GEOMETRIES:
        lt, rt = _colour_pair_on_card(h, w, d, seed)
        for view in ("left", "right"):
            for mean in (False, True):
                before = window_cost_cuda.LAUNCHES["sad_volume_f32"]
                got = window_cost_cuda.sad_volume_cuda(lt, rt, d, winsize, view, mean, True)
                torch.cuda.synchronize()
                assert window_cost_cuda.LAUNCHES["sad_volume_f32"] == before + 1
                want = volume.sad_volume(lt, rt, d, winsize, view, mean, True)
                assert torch.equal(got, want), (h, w, d, winsize, view, mean)
                assert torch.equal(window_cost_cuda.sad_volume_cuda(
                    lt.float(), rt.float(), d, winsize, view, mean, True), got)
    gen = torch.Generator(device="cuda").manual_seed(5)
    lt, rt = (t.float() + torch.rand(t.shape, device="cuda", generator=gen)
              for t in _colour_pair_on_card(40, 70, 20, 5))
    for view in ("left", "right"):
        # a sliding sum's partial sums are sums over parts of windows the walk
        # passed, so its roundings are bounded by the largest window sum, not
        # by the sum at hand (colour terms, the least of three differences,
        # vary more from window to window than grey ones)
        want = volume.sad_volume(lt, rt, 20, 3, view, False, True)
        torch.testing.assert_close(
            window_cost_cuda.sad_volume_cuda(lt, rt, 20, 3, view, False, True), want,
            rtol=0.0, atol=window_cost_cuda.FLOAT_RTOL * want.max().item())
    before = dict(window_cost_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="radius"):
        window_cost_cuda.sad_volume_cuda(lt, rt, 4, window_cost_cuda.MAX_RADIUS_RGBF, "left",
                                         False, True)
    assert window_cost_cuda.LAUNCHES == before


@pytest.mark.parametrize("layout", ["colour_without_channel_min", "grey_with_channel_min",
                                    "four_channels", "colour_mismatch", "float_colour_radius"])
def test_window_launch_check_colour(layout):
    """``[H, W, 3]`` pairs pass the kernels' check with ``channel_min`` and
    only then, u8 ones up to ``MAX_RADIUS`` and float32 ones up to
    ``MAX_RADIUS_RGBF``; a grey pair, another channel count, unequal shapes
    or a float32 colour radius above its limit raise."""
    grey = torch.zeros((8, 9), dtype=torch.uint8)
    colour = torch.zeros((8, 9, 3), dtype=torch.uint8)
    rgbf = colour.float()
    window_cost_cuda._check(colour, colour, 4, window_cost_cuda.MAX_RADIUS, True)
    window_cost_cuda._check(rgbf, rgbf, 4, window_cost_cuda.MAX_RADIUS_RGBF, True)
    left, right, cm, radius = {
        "colour_without_channel_min": (colour, colour, False, 2),
        "grey_with_channel_min": (grey, grey, True, 2),
        "four_channels": (torch.zeros((8, 9, 4), dtype=torch.uint8),) * 2 + (True, 2),
        "colour_mismatch": (colour, colour[:, :8], True, 2),
        "float_colour_radius": (rgbf, rgbf, True, window_cost_cuda.MAX_RADIUS_RGBF + 1),
    }[layout]
    with pytest.raises(ValueError):
        window_cost_cuda._check(left, right, 4, radius, cm)


def test_every_c_entry_has_its_signature_bound():
    """``build.library`` sets ``argtypes`` for every ``extern "C"`` entry of
    the sources and for nothing else (ctypes would pass a pointer of an
    unbound entry as a 32-bit int), with as many arguments as the entry
    takes."""
    import inspect
    import re

    declared = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C"\s+[\w *]+?(\w+)\(([^)]*)\)', src.read_text()):
            declared[name] = len([p for p in params.split(",") if p.strip()])
    bound = {name: len([a for a in args.split(",") if a.strip()])
             for name, args in re.findall(r"lib\.(\w+)\.argtypes = \[([^\]]*)\]",
                                          inspect.getsource(build.library))}
    assert len(declared) >= 7 and bound == declared


def test_library_name_covers_sources_and_headers(tmp_path):
    """The built library's name changes with a byte of any source or of a
    header the sources share, so an edited header is never served by a
    stale library (no card needed)."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    headers = sorted(csrc.glob("*.cuh"))
    assert headers and build.library_name(csrc) == build.library_name()
    names = {build.library_name(csrc)}
    for path in (headers[0], csrc / "scanline.cu"):
        path.write_bytes(path.read_bytes() + b"\n")
        names.add(build.library_name(csrc))
    assert len(names) == 3
    for src in ("scanline.cu", "scanline_canonical.cu"):
        assert '#include "scanline_tiles.cuh"' in (build.CSRC / src).read_text()


# (h, w, D) for the canonical scanline kernel: one row, one column, W < 32,
# W % 4 != 0, D > W, D = 256 (8 values a lane) with W % 4 == 0 and != 0, 4
# values a lane over many tiles of both directions, the reference size and
# the serving size
CANONICAL_GEOMETRIES = [(1, 40, 7), (33, 1, 9), (9, 20, 12), (9, 21, 12), (6, 9, 70),
                        (16, 300, 256), (16, 301, 256), (40, 70, 100), (375, 450, 60),
                        (720, 1280, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("h,w,d", CANONICAL_GEOMETRIES)
def test_canonical_scanline_kernel_bit_exact_on_card(h, w, d, view):
    """The plain version's float operations in its order, no contraction:
    bit for bit, on random costs and images (all three penalty scales)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(h + w + d)
    vol = torch.rand((d, h, w), device="cuda", generator=gen) * 2.0
    lt, rt = (torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
              for _ in range(2))
    before = scanline_canonical_cuda.LAUNCHES
    got = scanline_canonical_cuda.scanline_optimize_canonical_cuda(vol, lt, rt, 1.0, 3.0, 15.0,
                                                                   view)
    torch.cuda.synchronize()
    assert scanline_canonical_cuda.LAUNCHES == before + 1
    # a view of rows padded to a multiple of 4 columns
    assert got.shape == (d, h, w) and got.is_contiguous() == (w % 4 == 0)
    want = scanline.scanline_optimize_canonical(vol, lt, rt, 1.0, 3.0, 15.0, view)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("p1,p2,tso", [(1.0, 3.0, 0.0), (1.0, 3.0, 300.0), (0.5, 2.0, 15.0)],
                         ids=["tso0", "tso300", "p1_0.5_p2_2"])
@pytest.mark.parametrize("h,w,d", [(9, 21, 12), (40, 70, 100)])
def test_canonical_scanline_kernel_other_parameters_on_card(h, w, d, p1, p2, tso, view):
    """Bit for bit with the plain version where every edge bit is set
    (tso 0, the clamp triangle's too), where none is (tso 300) and at
    non-default penalties."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(h + w + d + int(tso))
    vol = torch.rand((d, h, w), device="cuda", generator=gen) * 2.0
    lt, rt = (torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
              for _ in range(2))
    got = scanline_canonical_cuda.scanline_optimize_canonical_cuda(vol, lt, rt, p1, p2, tso,
                                                                   view)
    want = scanline.scanline_optimize_canonical(vol, lt, rt, p1, p2, tso, view)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("h,w,d", [(9, 21, 12), (40, 70, 100)])
def test_canonical_scanline_kernel_float_images_on_card(h, w, d, view):
    """Non-integer float32 images take the kernel's float32 image path: bit
    for bit with the plain version, and a u8 pair gives the same bits as the
    same pair in float32."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(h * w + d)
    vol = torch.rand((d, h, w), device="cuda", generator=gen) * 2.0
    lt, rt = (torch.rand((h, w), device="cuda", generator=gen) * 255.0 for _ in range(2))
    fn = scanline_canonical_cuda.scanline_optimize_canonical_cuda
    got = fn(vol, lt, rt, 1.0, 3.0, 15.0, view)
    want = scanline.scanline_optimize_canonical(vol, lt, rt, 1.0, 3.0, 15.0, view)
    assert torch.equal(got, want)
    lu, ru = lt.to(torch.uint8), rt.to(torch.uint8)
    assert torch.equal(fn(vol, lu, ru, 1.0, 3.0, 15.0, view),
                       fn(vol, lu.float(), ru.float(), 1.0, 3.0, 15.0, view))


@pytest.mark.cuda
def test_canonical_scanline_kernel_checks_inputs():
    """D above 256, images on another device, an unknown view and a volume
    of 2^32 values raise and launch nothing."""
    _need_card()
    fn = scanline_canonical_cuda.scanline_optimize_canonical_cuda
    img = torch.zeros((8, 9), dtype=torch.uint8, device="cuda")
    before = scanline_canonical_cuda.LAUNCHES
    with pytest.raises(ValueError, match="D <= 256"):
        fn(torch.zeros((scanline_canonical_cuda.MAX_DISP + 1, 8, 9), device="cuda"), img, img)
    with pytest.raises(ValueError, match="one device"):
        fn(torch.zeros((4, 8, 9), device="cuda"), img.cpu(), img)
    with pytest.raises(ValueError, match="view"):
        fn(torch.zeros((4, 8, 9), device="cuda"), img, img, view="up")
    with pytest.raises(ValueError):
        fn(torch.zeros((4, 8, 9), device="cuda"), img[:4], img)
    # D H wp of 2^32 values (the movers' 32-bit offsets), a volume that is
    # never materialised
    big = torch.zeros((1, 1, 1), device="cuda").expand(256, 4096, 4096)
    img = torch.zeros((4096, 4096), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="2\\^32"):
        fn(big, img, img)
    assert scanline_canonical_cuda.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline,cfg,per_call", [
    ("ad_census", ADCensusConfig(disp_range=8, aggregation="cross_two_pass"), (1, 0, 0)),
    ("ad_census", ADCensusConfig(disp_range=8, aggregation="cross_two_pass",
                                 scanline=ScanlineConfig(), run_post=True), (1, 2, 0)),
    ("cblsm", CBLSMConfig(disp_range=8, aggregation="cross_two_pass"), (1, 0, 0)),
], ids=["ad_census_active", "ad_census_FULL", "cblsm"])
def test_canonical_pipelines_launch_kernels(pipeline, cfg, per_call):
    """Launches per call (cost, canonical scanline, scanline.cu), and the
    maps of the same pipeline on CPU tensors."""
    _need_card()
    L, R, _ = make_pair(40, 64, 8, seed=1)
    fn = get_pipeline(pipeline)[0]
    kernels = (ad_census_cuda, scanline_canonical_cuda, scanline_cuda)
    before = [k.LAUNCHES for k in kernels]
    res = fn(*pair_to_torch(L, R, "cuda"), cfg)
    torch.cuda.synchronize()
    assert tuple(k.LAUNCHES - b for k, b in zip(kernels, before)) == per_call
    plain = fn(*pair_to_torch(L, R, "cpu"), cfg)
    for f in ("disp_left", "disp_right", "disp_final"):
        if getattr(res, f) is not None:
            agree = (getattr(res, f).cpu() == getattr(plain, f)).float().mean().item()
            assert agree >= 0.99, (f, agree)


# -- the banded scanline passes (csrc/scanline_banded.cu) --------------------

# (T, D, M): one step, disparity and lane; a D that is no multiple of a
# thread's 2 values and lanes over two blocks; D = 256 (16 values a thread,
# 16 warps) over 5 blocks; a Teddy band (60 disparities, 128 rows of 450
# columns, both directions)
BANDED_SHAPES = [(1, 1, 1), (7, 9, 33), (40, 256, 129), (128, 60, 450)]


def _band_inputs(t, d, m, seed, carry):
    """A [D, t, m] band of costs (``cost.permute(1, 0, 2)`` is the vertical
    pass's [t, D, m] and ``cost.permute(2, 0, 1)`` the horizontal pass's
    [m, D, t]), penalties of both families in both layouts, and a zero or
    random carry for each layout's lanes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    cost = torch.rand((d, t, m), device="cuda", generator=g) * 4
    p2 = torch.rand((t, m), device="cuda", generator=g) * 3 + 0.5
    levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
    scale = levels[torch.randint(0, 3, (d, t, m), device="cuda", generator=g)]

    def carry_of(lanes):
        if not carry:
            return torch.zeros((d, lanes), device="cuda"), torch.zeros((lanes,), device="cuda")
        prev = torch.rand((d, lanes), device="cuda", generator=g) * 5
        return prev, prev.amin(0)

    return cost, p2, scale, carry_of


def _banded_pair(family):
    """(kernel wrapper, plain version) of one family, with its penalties."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    if family == "legacy":
        def kernel(c, p, cr, rs, **k):
            return banded.directional_pass_banded_cuda(c, p, cr, rs, 0.5, True, **k)

        def plain(c, p, cr, rs):
            return scanline.directional_pass_banded(c, p, cr, rs, 0.5, True)
    else:
        def kernel(c, p, cr, rs, **k):
            return banded.canonical_pass_banded_cuda(c, p, cr, rs, 1.0, 3.0, **k)

        def plain(c, p, cr, rs):
            return scanline.canonical_pass_banded(c, p, cr, rs, 1.0, 3.0)
    return banded, kernel, plain


@pytest.mark.cuda
@pytest.mark.parametrize("reset", [False, True])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("layout", ["vertical", "horizontal"])
@pytest.mark.parametrize("family", ["legacy", "canonical"])
@pytest.mark.parametrize("t,d,m", BANDED_SHAPES)
def test_banded_kernel_bit_exact_on_card(t, d, m, family, layout, carry, reset):
    """Both families, the vertical layout (lanes along a band's columns) and
    the strided horizontal one (lanes along its rows), zero and random
    carries, with a reset mid-path and without, both directions: the band
    and the outgoing carry bit for bit with the plain version run on the
    same card tensors, one launch a call."""
    _need_card()
    banded, kernel, plain = _banded_pair(family)
    cost, p2, scale, carry_of = _band_inputs(t, d, m, seed=t + d + m, carry=carry)
    if layout == "vertical":
        c = cost.permute(1, 0, 2)                                    # [t, D, m]
        pen = p2 if family == "legacy" else scale.permute(1, 0, 2)
    else:
        c = cost.permute(2, 0, 1)                                    # [m, D, t]
        pen = p2.T if family == "legacy" else scale.permute(2, 0, 1)
    n, lanes = c.shape[0], c.shape[2]
    cr = carry_of(lanes)
    r = n // 2 if reset else None
    for reverse in (False, True):
        before = dict(banded.LAUNCHES)
        out, (prev, pm) = kernel(c, pen, cr, r, reverse=reverse)
        torch.cuda.synchronize()
        assert sum(banded.LAUNCHES.values()) == sum(before.values()) + 1
        mask = None
        if r is not None:
            mask = torch.zeros(n, dtype=torch.bool, device="cuda")
            mask[r] = True
        if reverse:
            want, (wp, wm) = plain(c.flip(0), pen.flip(0), cr, None if mask is None
                                   else mask.flip(0))
            want = want.flip(0)
        else:
            want, (wp, wm) = plain(c, pen, cr, mask)
        assert torch.equal(out, want), (reverse, (out != want).sum().item())
        assert torch.equal(prev, wp) and torch.equal(pm, wm)
        back = out.permute(1, 0, 2) if layout == "vertical" else out.permute(1, 2, 0)
        assert back.is_contiguous()   # the band's [D, t, m] layout
        none, (prev2, pm2) = kernel(c, pen, cr, r, reverse=reverse, store=False)
        assert none is None and torch.equal(prev2, wp) and torch.equal(pm2, wm)


@pytest.mark.cuda
def test_banded_kernel_checks_inputs():
    """D above 256, penalties or a carry of the wrong shape and a second
    reset raise and launch nothing."""
    _need_card()
    banded, kernel, _ = _banded_pair("legacy")
    before = dict(banded.LAUNCHES)
    cost = torch.zeros((4, 257, 8), device="cuda")
    zero = (torch.zeros((257, 8), device="cuda"), torch.zeros((8,), device="cuda"))
    with pytest.raises(ValueError, match="D <= 256"):
        kernel(cost, torch.zeros((4, 8), device="cuda"), zero, None)
    cost = torch.zeros((4, 3, 8), device="cuda")
    zero = (torch.zeros((3, 8), device="cuda"), torch.zeros((8,), device="cuda"))
    with pytest.raises(ValueError, match="penalties"):
        kernel(cost, torch.zeros((4, 7), device="cuda"), zero, None)
    with pytest.raises(ValueError, match="penalties"):
        kernel(cost, torch.zeros((4, 8), device="cuda"), (zero[0][:2], zero[1]), None)
    with pytest.raises(ValueError, match="once"):
        kernel(cost, torch.zeros((4, 8), device="cuda"), zero,
               torch.tensor([True, False, True, False], device="cuda"))
    assert banded.LAUNCHES == before


# -- the band entries: both horizontal passes of a band in one launch --------

# (t, D, W, halo): chip_smoke.py phase 21's bands (a Teddy band with
# W % 4 != 0, a 4K-wide band at D=256, a halo-cropped view with W % 4 != 0,
# one row) and one column of a cropped band
HORIZONTAL_BANDS = [(128, 60, 450, 0), (64, 256, 3840, 0), (48, 200, 301, 4),
                    (1, 128, 257, 0), (9, 33, 1, 2)]


def _entry_case(case, t, d, w, halo, seed):
    """(C entry, kernel call, plain call) of one band entry on a random
    [D, t, W] band (the cropped view of t + 2 halo rows) and two u8 image
    rows: ``legacy``, or ``<view> <u8|float32>`` for the canonical entry."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    g = torch.Generator(device="cuda").manual_seed(seed)
    agg = (torch.rand((d, t + 2 * halo, w), device="cuda", generator=g) * 4).narrow(1, halo, t)
    imgs = [torch.randint(0, 256, (t, w), device="cuda", generator=g, dtype=torch.uint8)
            for _ in range(2)]
    if case == "legacy":
        grey = imgs[0].float()
        return ("scanline_horizontal_band_f32",
                lambda: banded.horizontal_passes_banded_cuda(agg, grey, 0.5, 4.0),
                lambda: scanline.horizontal_passes_banded(agg, grey, 0.5, 4.0))
    view, kind = case.split()
    b, m = imgs if kind == "u8" else [x.float() for x in imgs]
    rv = view == "right"
    return ("scanline_canonical_horizontal_band_f32",
            lambda: banded.canonical_horizontal_passes_banded_cuda(agg, b, m, 1.0, 3.0, 15.0, rv),
            lambda: scanline.canonical_horizontal_passes_banded(agg, b, m, 1.0, 3.0, 15.0, rv))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["legacy", "left u8", "right u8", "left float32",
                                  "right float32"])
@pytest.mark.parametrize("t,d,w,halo", HORIZONTAL_BANDS)
def test_horizontal_band_entry_bit_exact_on_card(t, d, w, halo, case):
    """Each band entry, one launch a call: lr and rl bit for bit with its
    plain version run on the same card tensors, as [D, t, W] views of rows
    padded to 4 columns (contiguous when W % 4 == 0)."""
    _need_card()
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    name, kernel, plain = _entry_case(case, t, d, w, halo, seed=t + d + w)
    before = dict(banded.LAUNCHES)
    got = kernel()
    torch.cuda.synchronize()
    assert banded.LAUNCHES[name] == before[name] + 1
    assert sum(banded.LAUNCHES.values()) == sum(before.values()) + 1
    want = plain()
    for g, v in zip(got, want):
        assert g.shape == (d, t, w) and g.is_contiguous() == (w % 4 == 0)
        assert torch.equal(g, v), (g != v).sum().item()


@pytest.mark.cuda
def test_horizontal_band_entries_check_inputs():
    """D above 256, image rows that do not match the band, tensors on two
    devices and a float64 band raise ValueError and launch nothing."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    _need_card()
    legacy = banded.horizontal_passes_banded_cuda
    canonical = banded.canonical_horizontal_passes_banded_cuda
    before = dict(banded.LAUNCHES)
    grey = torch.zeros((4, 8), device="cuda")
    img = grey.to(torch.uint8)
    big = torch.zeros((257, 4, 8), device="cuda")
    with pytest.raises(ValueError, match="D <= 256"):
        legacy(big, grey, 0.5, 4.0)
    with pytest.raises(ValueError, match="D <= 256"):
        canonical(big, img, img, 1.0, 3.0, 15.0, False)
    cost = torch.zeros((3, 4, 8), device="cuda")
    with pytest.raises(ValueError, match="image rows"):
        legacy(cost, grey[:3], 0.5, 4.0)
    with pytest.raises(ValueError, match="image rows"):
        canonical(cost, img, img[:, :7], 1.0, 3.0, 15.0, False)
    with pytest.raises(ValueError, match="cost on"):
        legacy(cost, grey.cpu(), 0.5, 4.0)
    with pytest.raises(ValueError, match="cost on"):
        canonical(cost, img, img.cpu(), 1.0, 3.0, 15.0, True)
    with pytest.raises(ValueError, match="float32"):
        legacy(cost.double(), grey, 0.5, 4.0)
    assert banded.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("row_offset", [-140, 0, 37])
@pytest.mark.parametrize("rows,cols", [(9, 7), (5, 5)])
def test_ad_census_row_window_on_card(row_offset, rows, cols):
    """The census kernel's row window: a band of 48 rows placed at global
    row ``row_offset`` of an image of 120 rows gives the plain version's
    Hamming volume bit for bit (both views, the 9 x 7 kernel and the general
    one) and its cost within 1e-6; (0, h) is the whole-image census."""
    _need_card()
    L, R, _ = make_pair(48, 70, 20, seed=7)
    lt, rt = pair_to_torch(L, R, "cuda")
    rows_total = 48 if row_offset == 0 else 120
    cen = ad_census_cuda._launch(lt, rt, 20, rows, cols, 1.0, 1.0, "both", "census",
                                 row_offset, rows_total)
    cost = ad_census_cuda.ad_census_volumes_cuda(lt, rt, 20, 10.0, 30.0, rows, cols,
                                                 row_offset, rows_total)
    torch.cuda.synchronize()
    for v, view in enumerate(("left", "right")):
        want = volume.census_volume(lt, rt, 20, rows, cols, view, row_offset, rows_total)
        assert torch.equal(cen[v], want), view
        want = volume.ad_census_volume(lt, rt, 20, 10.0, 30.0, rows, cols, view, row_offset,
                                       rows_total)
        torch.testing.assert_close(cost[v], want, rtol=0, atol=1e-6)
    if row_offset == 0:
        whole = ad_census_cuda._launch(lt, rt, 20, rows, cols, 1.0, 1.0, "both", "census")
        assert torch.equal(whole[0], cen[0]) and torch.equal(whole[1], cen[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline,cfg", [
    ("ad_census", ADCensusConfig(disp_range=8, scanline=ScanlineConfig(), run_post=True)),
    ("ad_census", ADCensusConfig(disp_range=8, aggregation="cross_two_pass",
                                 scanline=ScanlineConfig(), run_post=True)),
    ("ad_census", ADCensusConfig(disp_range=8)),
], ids=["FULL", "canonical_FULL", "active"])
def test_streamed_launches_kernels_on_card(pipeline, cfg):
    """The streamed executor on the card: the cost kernel once a band (twice
    with the scanline's two sweeps), the banded kernels per vertical pass
    (three a band and view), the band entry once a band and view for both
    horizontal passes, no whole-image scanline kernel; its maps equal the
    direct path's on the card outside the clamp triangle."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
    from stereo_match_traditional_tpu_torch.parallel import run_streamed

    _need_card()
    L, R, _ = make_pair(40, 64, 8, seed=1)
    lt, rt = pair_to_torch(L, R, "cuda")
    before = (ad_census_cuda.LAUNCHES, dict(banded.LAUNCHES), scanline_cuda.LAUNCHES,
              scanline_canonical_cuda.LAUNCHES)
    got = run_streamed(pipeline, lt, rt, cfg, row_tile=16)
    torch.cuda.synchronize()
    bands = 3
    canonical = cfg.aggregation == "cross_two_pass"
    views = 2 if canonical else 1
    sweeps = 2 if cfg.scanline is not None else 1
    per = views * bands if cfg.scanline is not None else 0   # band and view
    vertical, entry = (("scanline_banded_canonical_f32", "scanline_canonical_horizontal_band_f32")
                       if canonical else ("scanline_banded_f32", "scanline_horizontal_band_f32"))
    want_banded = dict.fromkeys(banded.LAUNCHES, 0)
    want_banded.update({vertical: 3 * per, entry: per})
    assert {k: v - before[1][k] for k, v in banded.LAUNCHES.items()} == want_banded
    assert (ad_census_cuda.LAUNCHES - before[0], scanline_cuda.LAUNCHES - before[2],
            scanline_canonical_cuda.LAUNCHES - before[3]) == (sweeps * bands, 0, 0)
    want = get_pipeline(pipeline)[0](lt, rt, cfg)
    for f in ("disp_left", "disp_final"):
        if getattr(want, f) is not None:
            agree = (getattr(got, f)[:, 8:] == getattr(want, f)[:, 8:]).float().mean().item()
            assert agree >= 0.995, (f, agree)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,offsets", [(7, 33, 40, (0, 13, 29)), (9, 300, 70, (0, 31, 64)),
                                           (3, 5, 12, (0, 4, 9)), (40, 67, 90, (0, 33, 64))])
def test_d_offset_slices_on_card(h, w, d, offsets):
    """The disparity slices of ``ad_census_volume_f32`` (both views, the cost
    and the AD and Hamming parts) and ``ncc_volume_f32`` (``d_offset``, the
    ``(tile, disp)`` runners' slices; D > W in the first and third shapes)
    joined along d equal the whole-volume kernel bit for bit, and each slice
    equals its plain version (the integer parts and NCC bit for bit, the
    cost within expf's last ulp)."""
    _need_card()
    L, R, _ = make_pair(h, w, min(d, w - 1), seed=2)
    lc, rc = pair_to_torch(L, R, "cpu")
    lt, rt = lc.cuda(), rc.cuda()
    bounds = list(offsets) + [d]
    spans = list(zip(bounds, bounds[1:]))
    for part in ("cost", "ad", "census"):
        whole = ad_census_cuda._launch(lt, rt, d, 9, 7, 10.0, 30.0, "both", part)
        parts = [ad_census_cuda._launch(lt, rt, e - o, 9, 7, 10.0, 30.0, "both", part,
                                        d_offset=o) for o, e in spans]
        for v, view in enumerate(("left", "right")):
            assert torch.equal(torch.cat([p[v] for p in parts]), whole[v]), (part, view)
            for (o, e), p in zip(spans, parts):
                if part == "cost":
                    want = volume.ad_census_volume(lc, rc, e - o, view=view, d_offset=o)
                    torch.testing.assert_close(p[v].cpu(), want, rtol=1e-6, atol=1e-6)
                else:
                    fn = volume.ad_volume if part == "ad" else volume.census_volume
                    assert torch.equal(p[v].cpu(), fn(lc, rc, e - o, view=view, d_offset=o))
    whole = window_cost_cuda.ncc_volume_cuda(lt, rt, d, 3)[0]
    parts = [window_cost_cuda.ncc_volume_cuda(lt, rt, e - o, 3, d_offset=o)[0] for o, e in spans]
    assert torch.equal(torch.cat(parts), whole)
    for (o, e), p in zip(spans, parts):
        assert torch.equal(p.cpu(), volume.ncc_volume(lc, rc, e - o, 3, d_offset=o)[0])


@pytest.mark.cuda
def test_d_offset_rejects_negative_offsets():
    _need_card()
    lt = torch.zeros((4, 5), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="d_offset"):
        ad_census_cuda.ad_census_volumes_cuda(lt, lt, 3, d_offset=-1)
    with pytest.raises(ValueError, match="d_offset"):
        window_cost_cuda.ncc_volume_cuda(lt, lt, 3, 1, d_offset=-1)
