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
    got = volume.asw_volume(lt, rt, d, win, view=view)
    torch.cuda.synchronize()
    assert asw_cuda.LAUNCHES == before + 1
    want = volume._asw_volume_plain(lt, rt, d, win, view=view)
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
        asw_cuda.asw_volume_left_cuda(left, right, 4, 2, 50.0, 30.0, 40.0)


@pytest.mark.cuda
def test_mixed_devices_rejected():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError):
        volume.asw_volume(x.cuda(), x, 4, 2)


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
    assert torch.equal(ad, volume._ad_volume_plain(lt, rt, d, view))
    assert torch.equal(cen, volume._census_volume_plain(lt, rt, d, view=view))
    torch.testing.assert_close(got, volume._ad_census_volume_plain(lt, rt, d, view=view),
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
        vol = volume._ad_census_volume_plain(lt, rt, d)
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lt = torch.randint(0, 256, (h, w), device="cuda", generator=gen, dtype=torch.uint8)
        vol = torch.rand((d, h, w), device="cuda", generator=gen) * 3.0
    before = scanline_cuda.LAUNCHES
    got = scanline_cuda.scanline_optimize_cuda(vol, lt, cfg)
    torch.cuda.synchronize()
    assert scanline_cuda.LAUNCHES == before + 1
    assert torch.equal(got, scanline._scanline_optimize_plain(vol, lt, cfg))


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
    for got, want in zip((vol_l, vol_r), volume._ad_census_volumes_plain(lt, rt, d), strict=True):
        assert got.shape == (d, h, w) and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for got, want in zip(ad_census_cuda.ad_volumes_cuda(lt, rt, d),
                         volume._ad_volumes_plain(lt, rt, d),
                         strict=True):
        assert torch.equal(got, want)
    census = ad_census_cuda._launch(lt, rt, d, 9, 7, 1.0, 1.0, "both", "census")
    for got, view in zip(census, ("left", "right"), strict=True):
        assert torch.equal(got, volume._census_volume_plain(lt, rt, d, view=view))
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
        assert torch.equal(cen[i], volume._census_volume_plain(lt, rt, 20, rows, cols, view))
        torch.testing.assert_close(
            cost[i], volume._ad_census_volume_plain(lt, rt, 20, 10.0, 30.0, rows, cols, view),
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


# Disparity ranges of the wide banded kernel: its walker / mover route (any
# D from 1: one value a walker lane, the tuned kernels' 256, the K edges
# 512 / 513 and 1024, the top of Middlebury's 300-800) and, above 1024, its
# shared-memory route (1025); the ones above 256 are the wrappers' wide
# route (above scanline_optimize_f32's 256)
WIDE_DS = (1, 33, 256, 257, 300, 512, 513, 800, 1024, 1025)
ROUTE_DS = tuple(d for d in WIDE_DS if d > 256)


@pytest.mark.cuda
def test_scanline_kernel_checks_inputs():
    """A gray image on another device or of another shape raises and
    launches nothing; D above 256 (the wide route: four launches of the
    wide banded kernel, none of scanline_optimize_f32) is bit for bit the
    plain version, both vertical quirks."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    _need_card()
    x = torch.zeros((8, 9), dtype=torch.uint8)
    before = scanline_cuda.LAUNCHES
    with pytest.raises(ValueError):
        scanline_cuda.scanline_optimize_cuda(torch.zeros((4, 8, 9)).cuda(), x)
    with pytest.raises(ValueError):
        scanline_cuda.scanline_optimize_cuda(torch.zeros((4, 8, 9)).cuda(), x[:4].cuda())
    g = torch.Generator(device="cuda").manual_seed(7)
    for d in ROUTE_DS:
        cost = torch.rand((d, 8, 9), device="cuda", generator=g) * 20
        gray = torch.randint(0, 256, (8, 9), device="cuda", generator=g, dtype=torch.uint8)
        for cfg in (ScanlineConfig(), ScanlineConfig(faithful_vertical_l2=True,
                                                     faithful_vertical_p2=True)):
            wide = banded.LAUNCHES["scanline_banded_wide_f32"]
            got = scanline_cuda.scanline_optimize_cuda(cost, gray, cfg)
            torch.cuda.synchronize()
            assert banded.LAUNCHES["scanline_banded_wide_f32"] == wide + 4
            want = scanline._scanline_optimize_plain(cost, gray, cfg)
            assert got.shape == (d, 8, 9) and got.is_contiguous() and torch.equal(got, want), d
    assert scanline_cuda.LAUNCHES == before


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
    assert torch.equal(got, volume._sad_volume_plain(lt, rt, d, winsize, view, mean))
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
    got, interior = volume.ncc_volume(lt, rt, d, win, mode)
    torch.cuda.synchronize()
    assert window_cost_cuda.LAUNCHES["ncc_volume_f32"] == before + 1
    want, want_in = volume._ncc_volume_plain(lt, rt, d, win, mode)
    assert torch.equal(got, want) and torch.equal(interior, want_in)
    assert torch.equal(volume.ncc_volume(lt.float(), rt.float(), d, win, mode)[0],
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
    for g, want in zip(got, volume._ncc_sums_plain(lt, rt, win)[2], strict=True):
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
    got, _ = volume.ncc_volume(lt, rt, d, win)
    torch.testing.assert_close(got, volume._ncc_volume_plain(lt, rt, d, win)[0], rtol=1e-5,
                               atol=1e-5)
    for g, want in zip(window_cost_cuda.ncc_sums_cuda(lt, rt, win),
                       volume._ncc_sums_plain(lt, rt, win)[2], strict=True):
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
                                   volume._sad_volume_plain(lt, rt, d, win, view), rtol=rtol,
                                   atol=0.0)
    lt = torch.rand((h, w), device="cuda", generator=gen) * 255.0
    rt = torch.roll(lt, -3, 1) + torch.rand((h, w), device="cuda", generator=gen) * 8.0
    n = float((2 * win + 1) ** 2)
    for g, want, one_sign in zip(window_cost_cuda.ncc_sums_cuda(lt, rt, win),
                                 volume._ncc_sums_plain(lt, rt, win)[2],
                                 (False, True, False, True), strict=True):
        torch.testing.assert_close(g, want, rtol=rtol, atol=0.0 if one_sign else rtol * n * 128.0)
    torch.testing.assert_close(volume.ncc_volume(lt, rt, d, win)[0],
                               volume._ncc_volume_plain(lt, rt, d, win)[0], rtol=0.0,
                               atol=2 * rtol)


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
        volume.ncc_volume(x, x.cuda(), 4, 2)
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
        volume.ncc_volume(x, x, 4, big)
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
                want = volume._sad_volume_plain(lt, rt, d, winsize, view, mean, True)
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
        want = volume._sad_volume_plain(lt, rt, 20, 3, view, False, True)
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
    want = scanline._scanline_optimize_canonical_plain(vol, lt, rt, 1.0, 3.0, 15.0, view)
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
    want = scanline._scanline_optimize_canonical_plain(vol, lt, rt, p1, p2, tso, view)
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
    want = scanline._scanline_optimize_canonical_plain(vol, lt, rt, 1.0, 3.0, 15.0, view)
    assert torch.equal(got, want)
    lu, ru = lt.to(torch.uint8), rt.to(torch.uint8)
    assert torch.equal(fn(vol, lu, ru, 1.0, 3.0, 15.0, view),
                       fn(vol, lu.float(), ru.float(), 1.0, 3.0, 15.0, view))


@pytest.mark.cuda
def test_canonical_scanline_kernel_checks_inputs():
    """Images on another device, an unknown view and a volume of 2^32 values
    raise and launch nothing; D above 256 (the wide route: four launches of
    the wide banded kernel) is bit for bit the plain version, both views."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    _need_card()
    fn = scanline_canonical_cuda.scanline_optimize_canonical_cuda
    g = torch.Generator(device="cuda").manual_seed(8)
    for d in ROUTE_DS:
        cost = torch.rand((d, 8, 9), device="cuda", generator=g) * 20
        lu, ru = (torch.randint(0, 256, (8, 9), device="cuda", generator=g, dtype=torch.uint8)
                  for _ in range(2))
        for view in ("left", "right"):
            wide = banded.LAUNCHES["scanline_banded_wide_canonical_f32"]
            got = fn(cost, lu, ru, 1.0, 3.0, 15.0, view)
            torch.cuda.synchronize()
            assert banded.LAUNCHES["scanline_banded_wide_canonical_f32"] == wide + 4
            want = scanline._scanline_optimize_canonical_plain(cost, lu, ru, 1.0, 3.0, 15.0, view)
            assert got.shape == (d, 8, 9) and got.is_contiguous(), (d, view)
            assert torch.equal(got, want), (d, view)
    img = torch.zeros((8, 9), dtype=torch.uint8, device="cuda")
    before = scanline_canonical_cuda.LAUNCHES
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
            return scanline._directional_pass_banded_plain(c, p, cr, rs, 0.5, True)
    else:
        def kernel(c, p, cr, rs, **k):
            return banded.canonical_pass_banded_cuda(c, p, cr, rs, 1.0, 3.0, **k)

        def plain(c, p, cr, rs):
            return scanline._canonical_pass_banded_plain(c, p, cr, rs, 1.0, 3.0)
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
    """D above 256 runs the wide kernel, bit for bit the plain version, both
    families, one launch a call; D above the wide kernel's shared memory,
    penalties or a carry of the wrong shape and a second reset raise and
    launch nothing."""
    _need_card()
    for family in ("legacy", "canonical"):
        banded, kernel, plain = _banded_pair(family)
        for d in ROUTE_DS:
            cost, p2, scale, carry_of = _band_inputs(9, d, 33, seed=d, carry=True)
            c = cost.permute(1, 0, 2)
            pen = p2 if family == "legacy" else scale.permute(1, 0, 2)
            cr = carry_of(33)
            before = dict(banded.LAUNCHES)
            got, (gp, gm) = kernel(c, pen, cr, 4)
            torch.cuda.synchronize()
            entry = banded.WIDE[family == "canonical"]
            assert banded.LAUNCHES[entry] == before[entry] + 1
            assert sum(banded.LAUNCHES.values()) == sum(before.values()) + 1
            want, (wp, wm) = plain(c, pen, cr, 4)
            assert torch.equal(got, want) and torch.equal(gp, wp) and torch.equal(gm, wm), d
    banded, kernel, _ = _banded_pair("legacy")
    before = dict(banded.LAUNCHES)
    big = banded.WIDE_MAX_DISP + 1
    cost = torch.zeros((4, big, 8), device="cuda")
    zero = (torch.zeros((big, 8), device="cuda"), torch.zeros((8,), device="cuda"))
    with pytest.raises(ValueError, match=f"D={big}"):
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


# (D, T, M, layout) of the walker / mover kernel at the executors' shapes:
# the tiled executor's whole-column passes at 720p over a world of one and
# a rank's slab of four, and at Teddy ([T, D, M] contiguous), and the
# streamed executor's 4K-wide band (a halo-cropped [D, t, W] band's
# permute(1, 0, 2))
EXECUTOR_PASSES = [(128, 720, 1280, "columns"), (128, 720, 320, "columns"),
                   (60, 375, 450, "columns"), (256, 64, 3840, "band")]
# ... and its edges: one step, one lane, M % 4 != 0 (8-byte and 4-byte
# copies), a view whose base and strides are not 16-byte multiples, a D that
# is no multiple of a lane's values, every K, both block widths (16 lanes
# where blocks of 8 would not all fit the card: M > 2112 for K <= 4)
WALKER_EDGES = [(60, 1, 450, "columns"), (37, 12, 1, "columns"), (100, 30, 98, "columns"),
                (200, 17, 131, "band"), (9, 40, 77, "unaligned"), (256, 9, 1030, "unaligned"),
                (1, 5, 3, "columns"), (33, 70, 2100, "band"), (100, 9, 2200, "columns"),
                (20, 9, 2300, "band")]


def _walker_case(d, n, m, layout, family, seed):
    """(cost, penalties, carry) of one pass in ``layout``: ``columns`` a
    contiguous [T, D, M], ``band`` the permute(1, 0, 2) of a [D, T, M] band
    cropped from 2 more rows, ``unaligned`` a [T, D, M] view one float off
    every 16-byte boundary (strides of odd multiples of a float)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def volume():
        if layout == "columns":
            return torch.rand((n, d, m), device="cuda", generator=g) * 4
        if layout == "band":
            band = torch.rand((d, n + 2, m), device="cuda", generator=g) * 4
            return band.narrow(1, 1, n).permute(1, 0, 2)
        return (torch.rand((n, d, m + 3), device="cuda", generator=g) * 4)[:, :, 1:m + 1]

    cost = volume()
    if family == "legacy":
        pen = torch.rand((n, m), device="cuda", generator=g) * 3 + 0.5
    else:
        levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
        pen = levels[torch.randint(0, 3, (n, d, m), device="cuda", generator=g)]
        if layout != "columns":
            pen = volume().copy_(pen)
    prev = torch.rand((d, m), device="cuda", generator=g) * 5
    return cost, pen, (prev, prev.amin(0))


def _hold_walker(d, n, m, layout, family):
    """The pass forwards and backwards, with the output and carry-only, with
    a reset mid-path and without: one launch of the walker / mover kernel a
    call, bit for bit the plain version and the wide kernel (the strided
    banded design generalised), output in the band's memory order."""
    banded, kernel, plain = _banded_pair(family)
    canonical = family == "canonical"
    cost, pen, carry = _walker_case(d, n, m, layout, family, seed=d + n + m)
    for reset in (None, n // 2):
        mask = None
        if reset is not None:
            mask = torch.zeros(n, dtype=torch.bool, device="cuda")
            mask[reset] = True
        for reverse in (False, True):
            before = banded.LAUNCHES[banded.WALKER[canonical]]
            out, (cp, cm) = kernel(cost, pen, carry, reset, reverse=reverse)
            torch.cuda.synchronize()
            assert banded.LAUNCHES[banded.WALKER[canonical]] == before + 1
            if reverse:
                want, (wp, wm) = plain(cost.flip(0), pen.flip(0), carry,
                                       None if mask is None else mask.flip(0))
                want = want.flip(0)
            else:
                want, (wp, wm) = plain(cost, pen, carry, mask)
            assert torch.equal(out, want), (reset, reverse, (out != want).sum().item())
            assert torch.equal(cp, wp) and torch.equal(cm, wm), (reset, reverse)
            wide, (xp, xm) = banded._launch(canonical, cost, pen, carry, reset, *(
                (1.0, 3.0, True) if canonical else (0.5, 0.0, True)), reverse, True,
                banded.WIDE[canonical])
            assert torch.equal(out, wide) and torch.equal(cp, xp) and torch.equal(cm, xm)
            none, (np_, nm) = kernel(cost, pen, carry, reset, reverse=reverse, store=False)
            assert none is None and torch.equal(np_, wp) and torch.equal(nm, wm)
    assert out.stride(2) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["legacy", "canonical"])
@pytest.mark.parametrize("d,n,m,layout", EXECUTOR_PASSES)
def test_banded_walker_at_executor_shapes_on_card(d, n, m, layout, family):
    """The redesigned vertical kernels at the executors' shapes."""
    _need_card()
    _hold_walker(d, n, m, layout, family)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["legacy", "canonical"])
@pytest.mark.parametrize("d,n,m,layout", WALKER_EDGES)
def test_banded_walker_edges_on_card(d, n, m, layout, family):
    """The redesigned vertical kernels at their edges."""
    _need_card()
    _hold_walker(d, n, m, layout, family)


def _wide_case(d, layout, family, seed):
    """(cost, penalties, random carry) of one pass on the wide kernel:
    ``vertical`` the permute(1, 0, 2) of a [D, 70, 37] band (lanes
    contiguous); ``horizontal`` the permute(2, 0, 1) of a [D, 5, 37] band
    (steps contiguous), canonical scales [37, D, 5] contiguous (lanes
    contiguous, unlike the cost: copied value by value); ``cropped`` the
    same of a halo-cropped [D, 5, 37] view of 9 rows, the scales in the
    band's layout (as ``ops.scanline.horizontal_scales`` gives them)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    levels = torch.tensor([1.0, 0.25, 0.1], device="cuda")
    t = 70 if layout == "vertical" else 5
    band = torch.rand((d, t + 4, 37), device="cuda", generator=g) * 4
    band = band.narrow(1, 2, t) if layout == "cropped" else band[:, :t].contiguous()
    if layout == "vertical":
        cost = band.permute(1, 0, 2)
    else:
        cost = band.permute(2, 0, 1)
    n, m = cost.shape[0], cost.shape[2]
    if family == "legacy":
        pen = torch.rand((m, n), device="cuda", generator=g).T * 3 + 0.5
    else:
        pen = levels[torch.randint(0, 3, (n, d, m), device="cuda", generator=g)]
        if layout == "cropped":
            pen = torch.empty_like(band).permute(2, 0, 1).copy_(pen)
    prev = torch.rand((d, m), device="cuda", generator=g) * 5
    return cost, pen, (prev, prev.amin(0))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["vertical", "horizontal", "cropped"])
@pytest.mark.parametrize("family", ["legacy", "canonical"])
@pytest.mark.parametrize("d", WIDE_DS)
def test_banded_wide_kernel_bit_exact_on_card(d, family, layout):
    """The wide kernel, forced at every D of WIDE_DS (the walker / mover
    route up to 1024, the shared-memory one at 1025): lanes contiguous
    (vertical), steps contiguous (horizontal, with the canonical scales'
    lanes contiguous) and a halo-cropped band, 37 lanes or steps; a random
    carry with a reset mid-path and a zero one without, both directions,
    with the output and carry-only: one launch a call, bit for bit the plain
    version run on the same card tensors, the output in the band's memory
    order."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    _need_card()
    canonical = family == "canonical"
    _, _, plain = _banded_pair(family)
    entry = banded.WIDE[canonical]
    cost, pen, carry = _wide_case(d, layout, family, seed=d + len(layout))
    n = cost.shape[0]
    zero = (torch.zeros_like(carry[0]), torch.zeros_like(carry[1]))
    args = (1.0, 3.0, True) if canonical else (0.5, 0.0, True)
    for cr, reset in ((carry, n // 2), (zero, None)):
        for reverse in (False, True):
            before = dict(banded.LAUNCHES)
            out, (cp, cm) = banded._launch(canonical, cost, pen, cr, reset, *args, reverse, True,
                                           entry)
            none, (sp, sm) = banded._launch(canonical, cost, pen, cr, reset, *args, reverse,
                                            False, entry)
            torch.cuda.synchronize()
            assert banded.LAUNCHES[entry] == before[entry] + 2
            assert sum(banded.LAUNCHES.values()) == sum(before.values()) + 2
            r = None if reset is None else (n - 1 - reset if reverse else reset)
            if reverse:
                want, (wp, wm) = plain(cost.flip(0), pen.flip(0), cr, r)
                want = want.flip(0)
            else:
                want, (wp, wm) = plain(cost, pen, cr, r)
            assert torch.equal(out, want), (reset, reverse, (out != want).sum().item())
            assert torch.equal(cp, wp) and torch.equal(cm, wm), (reset, reverse)
            assert none is None and torch.equal(sp, wp) and torch.equal(sm, wm)
            back = out.permute(1, 0, 2) if layout == "vertical" else out.permute(1, 2, 0)
            assert back.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["legacy", "canonical"])
def test_banded_wide_kernel_4096_on_card(family):
    """The wide kernel at D = 4096 (128 KB of shared memory), both layouts,
    against the plain version."""
    _need_card()
    banded, kernel, plain = _banded_pair(family)
    cost, p2, scale, carry_of = _band_inputs(5, 4096, 11, seed=4096, carry=True)
    for layout in ("vertical", "horizontal"):
        if layout == "vertical":
            c = cost.permute(1, 0, 2)
            pen = p2 if family == "legacy" else scale.permute(1, 0, 2)
        else:
            c = cost.permute(2, 0, 1)
            pen = p2.T if family == "legacy" else scale.permute(2, 0, 1)
        cr = carry_of(c.shape[2])
        got, (gp, gm) = kernel(c, pen, cr, 1, reverse=True)
        want, (wp, wm) = plain(c.flip(0), pen.flip(0), cr, c.shape[0] - 2)
        assert torch.equal(got, want.flip(0)) and torch.equal(gp, wp) and torch.equal(gm, wm)


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline,cfg", [
    ("ad_census", ADCensusConfig(disp_range=300, scanline=ScanlineConfig(), run_post=True)),
    ("ad_census", ADCensusConfig(disp_range=300, aggregation="cross_two_pass",
                                 scanline=ScanlineConfig(), run_post=True)),
], ids=["FULL", "canonical_FULL"])
def test_pipelines_above_256_disparities_on_card(pipeline, cfg):
    """ad_census FULL and canonical FULL at D = 300 on a 24 x 320 pair: the
    scanline on the wide route (four wide launches a scanline call; the
    canonical family calls it for both views), every map of FULL equal to
    the same pipeline on CPU tensors; canonical FULL's within the 99.5 %
    envelope outside the clamp triangle, where the cost kernel's last ulp
    (against the plain exponential) does not meet the triangle's exact
    ties."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    _need_card()
    L, R, _ = make_pair(24, 320, 300, seed=2)
    fn = get_pipeline(pipeline)[0]
    before = dict(banded.LAUNCHES)
    res = fn(*pair_to_torch(L, R, "cuda"), cfg)
    torch.cuda.synchronize()
    entry = banded.WIDE[cfg.aggregation == "cross_two_pass"]
    assert banded.LAUNCHES[entry] - before[entry] == (4 if entry == banded.WIDE[False] else 8)
    plain = fn(*pair_to_torch(L, R, "cpu"), cfg)
    for f in ("disp_left", "disp_right", "disp_final"):
        got, want = getattr(res, f).cpu(), getattr(plain, f)
        if cfg.aggregation != "cross_two_pass":
            assert torch.equal(got, want), f
            continue
        cols = slice(None, -300) if f == "disp_right" else slice(300, None)
        assert (got[:, cols] == want[:, cols]).double().mean().item() >= 0.995, f


# -- the band entries: both horizontal passes of a band in one launch --------

# (t, D, W, halo): chip_smoke.py phase 21's bands (a Teddy band with
# W % 4 != 0, a 4K-wide band at D=256, a halo-cropped view with W % 4 != 0,
# one row) and one column of a cropped band
HORIZONTAL_BANDS = [(128, 60, 450, 0), (64, 256, 3840, 0), (48, 200, 301, 4),
                    (1, 128, 257, 0), (9, 33, 1, 2)]


def _entry_case(case, t, d, w, halo, seed):
    """(C entry, kernel call, plain call, band) of one band entry on a
    random [D, t, W] band (the cropped view of t + 2 halo rows) and two u8
    image rows: ``legacy``, or ``<view> <u8|float32>`` for the canonical
    entry."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    g = torch.Generator(device="cuda").manual_seed(seed)
    agg = (torch.rand((d, t + 2 * halo, w), device="cuda", generator=g) * 4).narrow(1, halo, t)
    imgs = [torch.randint(0, 256, (t, w), device="cuda", generator=g, dtype=torch.uint8)
            for _ in range(2)]
    if case == "legacy":
        grey = imgs[0].float()
        return ("scanline_horizontal_band_f32",
                lambda: banded.horizontal_passes_banded_cuda(agg, grey, 0.5, 4.0),
                lambda: scanline._horizontal_passes_banded_plain(agg, grey, 0.5, 4.0), agg)
    view, kind = case.split()
    b, m = imgs if kind == "u8" else [x.float() for x in imgs]
    rv = view == "right"
    return ("scanline_canonical_horizontal_band_f32",
            lambda: banded.canonical_horizontal_passes_banded_cuda(agg, b, m, 1.0, 3.0, 15.0, rv),
            lambda: scanline._canonical_horizontal_passes_banded_plain(agg, b, m, 1.0, 3.0, 15.0,
                                                                       rv),
            agg)


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

    name, kernel, plain, _ = _entry_case(case, t, d, w, halo, seed=t + d + w)
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
def test_horizontal_band_entries_check_inputs(monkeypatch):
    """D above 256 is bit for bit the plain version, on a halo-cropped band
    with W % 4 != 0: two launches of the wide kernel and none of the band
    entries, each reading the band itself (a view of its memory, no copy;
    legacy: no volume allocated but lr and rl), the results contiguous.
    Image rows that do not match the band, tensors on two devices and a
    float64 band raise ValueError and launch nothing."""
    from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded

    _need_card()
    legacy = banded.horizontal_passes_banded_cuda
    canonical = banded.canonical_horizontal_passes_banded_cuda
    launch, read = banded._launch, []

    def recorded(canonical, cost, *args, **kwargs):
        read.append(cost)
        return launch(canonical, cost, *args, **kwargs)

    monkeypatch.setattr(banded, "_launch", recorded)
    for d in ROUTE_DS:
        for case in ("legacy", "left u8", "right float32"):
            name, kernel, plain, band = _entry_case(case, 6, d, 37, 2, seed=d)
            before = dict(banded.LAUNCHES)
            read.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            got = kernel()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            assert banded.LAUNCHES[name] == before[name]
            entry = banded.WIDE[case != "legacy"]
            assert banded.LAUNCHES[entry] == before[entry] + 2
            assert sum(banded.LAUNCHES.values()) == sum(before.values()) + 2
            assert len(read) == 2 and all(
                c.data_ptr() == band.data_ptr() and c.stride() == band.permute(2, 0, 1).stride()
                for c in read), (d, case)
            volume = 4 * d * 6 * 37
            if case == "legacy":
                assert peak < 2.5 * volume, (d, peak / volume)
            for g, v in zip(got, plain()):
                assert g.shape == (d, 6, 37) and g.is_contiguous(), (d, case)
                assert torch.equal(g, v), (d, case)
    before = dict(banded.LAUNCHES)
    grey = torch.zeros((4, 8), device="cuda")
    img = grey.to(torch.uint8)
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
        want = volume._census_volume_plain(lt, rt, 20, rows, cols, view, row_offset, rows_total)
        assert torch.equal(cen[v], want), view
        want = volume._ad_census_volume_plain(lt, rt, 20, 10.0, 30.0, rows, cols, view, row_offset,
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
                    want = volume._ad_census_volume_plain(lc, rc, e - o, view=view, d_offset=o)
                    torch.testing.assert_close(p[v].cpu(), want, rtol=1e-6, atol=1e-6)
                else:
                    fn = (volume._ad_volume_plain if part == "ad"
                          else volume._census_volume_plain)
                    assert torch.equal(p[v].cpu(), fn(lc, rc, e - o, view=view, d_offset=o))
    whole = volume.ncc_volume(lt, rt, d, 3)[0]
    parts = [volume.ncc_volume(lt, rt, e - o, 3, d_offset=o)[0] for o, e in spans]
    assert torch.equal(torch.cat(parts), whole)
    for (o, e), p in zip(spans, parts):
        assert torch.equal(p.cpu(), volume._ncc_volume_plain(lc, rc, e - o, 3, d_offset=o)[0])


@pytest.mark.cuda
def test_d_offset_rejects_negative_offsets():
    _need_card()
    lt = torch.zeros((4, 5), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="d_offset"):
        ad_census_cuda.ad_census_volumes_cuda(lt, lt, 3, d_offset=-1)
    with pytest.raises(ValueError, match="d_offset"):
        volume.ncc_volume(lt, lt, 3, 1, d_offset=-1)


# ---------------------------------------------------------------------------
# The aggregation and post kernels (csrc/aggregate.cu, csrc/post.cu): cross
# arms, the rect mean, the 8-direction fill and the speckle filter, each
# against its plain version on the same CUDA tensors
# ---------------------------------------------------------------------------

# (h, w, D, seed): one row, one column, W % 4 != 0, Teddy, 720p
AGG_POST_GEOMETRIES = [(1, 67, 9, 1), (53, 1, 7, 2), (37, 61, 13, 3), (375, 450, 60, 0),
                       (720, 1280, 128, 1)]


def _agg_post_modules():
    from stereo_match_traditional_tpu_torch.ops import aggregate, post
    from stereo_match_traditional_tpu_torch.ops.kernels import aggregate_cuda, post_cuda

    return aggregate, post, aggregate_cuda, post_cuda


def _images(h, w, d, seed, colour=False):
    """A synthetic pair on the card (random u8 images where it is too small
    for one); ``colour`` stacks three channels of shifted greys."""
    if min(h, w) == 1:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        lt, rt = (torch.randint(0, 256, (h, w), device="cuda", generator=gen,
                                dtype=torch.uint8) for _ in range(2))
    else:
        L, R, _ = make_pair(h, w, min(d, w - 1), seed=seed)
        lt, rt = pair_to_torch(L, R, "cuda")
    if colour:
        lt, rt = (torch.stack([x, x.roll(1, 1), (x // 2 + 40)], dim=-1) for x in (lt, rt))
    return lt, rt


def _disp_map(h, w, seed, holes=0.25, invalid=float("inf"), levels=12):
    """Integer disparities in 5x5 patches with noise and a share of invalid
    pixels: components and holes of many sizes (numpy, then the card)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, levels, size=(h // 5 + 1, w // 5 + 1))
    d = np.kron(coarse, np.ones((5, 5)))[:h, :w]
    d = np.where(rng.random((h, w)) < 0.1, rng.integers(0, levels, size=(h, w)), d)
    d = np.where(rng.random((h, w)) < holes, invalid, d).astype(np.float32)
    bad = ~np.isfinite(d) | (d == np.float32(invalid))
    occl = bad & (rng.random((h, w)) < 0.5)
    mism = bad & ~occl & (rng.random((h, w)) < 0.7)
    return tuple(torch.from_numpy(a).cuda() for a in (d, occl, mism))


def _arm_cfg():
    return ADCensusConfig().arms


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "float32", "colour u8", "colour float32"])
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES)
def test_cross_arms_kernel_bit_exact_on_card(h, w, d, seed, kind):
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    img = _images(h, w, d, seed, colour=kind.startswith("colour"))[0]
    if kind.endswith("float32"):
        img = img.float() * 0.75
    before = aggregate_cuda.LAUNCHES["cross_arms_i32"]
    got = aggregate.cross_arms(img, _arm_cfg())
    torch.cuda.synchronize()
    assert aggregate_cuda.LAUNCHES["cross_arms_i32"] == before + 1
    want = aggregate._cross_arms_plain(img, _arm_cfg())
    for name, g, x in zip(("left", "right", "up", "down"), got, want):
        assert g.dtype == torch.int32 and torch.equal(g, x), name


@pytest.mark.cuda
@pytest.mark.parametrize("row_offset,global_rows", [(0, 40), (-34, 40), (21, 40), (-5, 7)])
def test_cross_arms_band_on_card(row_offset, global_rows):
    """A band of rows placed in a taller image (the executors' halo'd
    bands): the vertical arms stop at the image's borders."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    img = _images(19, 45, 8, 4)[0]
    got = aggregate.cross_arms(img, _arm_cfg(), row_offset, global_rows)
    want = aggregate._cross_arms_plain(img, _arm_cfg(), row_offset, global_rows)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES)
def test_rect_mean_kernel_bit_exact_on_card(h, w, d, seed, inclusive):
    """AD-Census volumes (both views, and both concatenated as cblsm's
    second pass does) bit for bit; a non-contiguous view too."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(h, w, d, seed)
    vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
    arms = aggregate.cross_arms(lt, _arm_cfg())
    before = aggregate_cuda.LAUNCHES["rect_mean_f32"]
    for vol in (vol_l, vol_r, torch.cat([vol_l, vol_r]), vol_l[:, :, : max(w - 3, 1)]):
        a = arms if vol.shape[-1] == w else aggregate.Arms(
            *(x[:, : vol.shape[-1]].contiguous() for x in arms))
        got = aggregate.rect_mean_aggregate(vol, a, inclusive)
        torch.cuda.synchronize()
        assert torch.equal(got, aggregate._rect_mean_aggregate_plain(vol, a, inclusive))
    assert aggregate_cuda.LAUNCHES["rect_mean_f32"] == before + 4


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES[:4])
def test_rect_mean_kernel_within_an_ulp_on_card(h, w, d, seed):
    """Other float32 volumes (a second pass's means, random values): the
    float64 sums round in another order than the card's cumsum, so the
    mean is held within one float32 ulp."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, _ = _images(h, w, d, seed)
    arms = aggregate.cross_arms(lt, _arm_cfg())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vol = torch.rand((d, h, w), device="cuda", generator=gen) * 3.0
    for x in (vol, aggregate.rect_mean_aggregate(vol, arms)):
        got = aggregate.rect_mean_aggregate(x, arms)
        want = aggregate._rect_mean_aggregate_plain(x, arms, True)
        ulps = (got.view(torch.int32) - want.view(torch.int32)).abs().max().item()
        assert ulps <= 1, ulps


@pytest.mark.cuda
def test_rect_mean_kernel_peak_below_plain_on_card():
    """The kernel's float64 table is chunked: its peak is below the plain
    version's whole-volume float64 copies."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(375, 450, 60, 0)
    vol = ad_census_cuda.ad_census_volumes_cuda(lt, rt, 60)[0]
    arms = aggregate.cross_arms(lt, _arm_cfg())
    peaks = []
    for fn in (aggregate.rect_mean_aggregate,
               lambda v, a: aggregate._rect_mean_aggregate_plain(v, a, True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn(vol, arms)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    assert peaks[0] < peaks[1], peaks


# The strip walker (``rect_mean_walker_f32``): the main path's cap, the
# arms' own bound
SPAN = ADCensusConfig().arms.max_length


def _walker_launches(aggregate_cuda, fn):
    """``fn()``'s launches of both rect-mean entries, and the arms outside
    the cap it met (the device word, read and reset)."""
    before = dict(aggregate_cuda.LAUNCHES)
    aggregate_cuda.arms_over_cap("cuda", reset=True)
    out = fn()
    torch.cuda.synchronize()
    launched = {k: aggregate_cuda.LAUNCHES[k] - before[k]
                for k in ("rect_mean_f32", "rect_mean_walker_f32")}
    return out, launched, aggregate_cuda.arms_over_cap("cuda", reset=True)


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES)
def test_rect_mean_walker_bit_exact_on_card(h, w, d, seed, inclusive):
    """With the cap, AD-Census volumes (both views, both concatenated, a
    non-contiguous view) bit for bit through the walker, no arm over it."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(h, w, d, seed)
    vol_l, vol_r = ad_census_cuda.ad_census_volumes_cuda(lt, rt, d)
    arms = aggregate.cross_arms(lt, _arm_cfg())
    for vol in (vol_l, vol_r, torch.cat([vol_l, vol_r]), vol_l[:, :, : max(w - 3, 1)]):
        a = arms if vol.shape[-1] == w else aggregate.Arms(
            *(x[:, : vol.shape[-1]].contiguous() for x in arms))
        got, launched, over = _walker_launches(
            aggregate_cuda, lambda: aggregate.rect_mean_aggregate(vol, a, inclusive, max_span=SPAN))
        assert launched == {"rect_mean_f32": 0, "rect_mean_walker_f32": 1} and over == 0
        assert torch.equal(got, aggregate._rect_mean_aggregate_plain(vol, a, inclusive))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES)
def test_rect_mean_walker_within_an_ulp_on_card(h, w, d, seed):
    """Random volumes and a second pass's means through the walker: within
    one float32 ulp of the plain version (its carries and scans add in
    another order than the card's cumsum)."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, _ = _images(h, w, d, seed)
    arms = aggregate.cross_arms(lt, _arm_cfg())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    vol = torch.rand((d, h, w), device="cuda", generator=gen) * 3.0
    for x in (vol, aggregate.rect_mean_aggregate(vol, arms, max_span=SPAN)):
        got = aggregate.rect_mean_aggregate(x, arms, max_span=SPAN)
        want = aggregate._rect_mean_aggregate_plain(x, arms, True)
        ulps = (got.view(torch.int32) - want.view(torch.int32)).abs().max().item()
        assert ulps <= 1, ulps


def _capped_arms(h, w, cap, seed, at_cap=0.5):
    """Random arms in [0, cap], half exactly at it, clipped to the image as
    real arms are (int32 on the card)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ii = torch.arange(h, device="cuda")[:, None].expand(h, w)
    jj = torch.arange(w, device="cuda")[None, :].expand(h, w)
    out = []
    for room in (jj, w - 1 - jj, ii, h - 1 - ii):
        a = torch.randint(0, cap + 1, (h, w), device="cuda", generator=gen)
        a = torch.where(torch.rand((h, w), device="cuda", generator=gen) < at_cap, cap, a)
        out.append(torch.minimum(a, room).to(torch.int32))
    from stereo_match_traditional_tpu_torch.ops.aggregate import Arms

    return Arms(*out)


# (n, h, w, cap): widths 128 does not divide, h < 2L + 2, one row, one
# column, one pixel, the cap 0 and the largest the walker takes (48)
RECT_WALKER_EDGES = [(5, 40, 65, 34), (4, 33, 255, 34), (3, 50, 129, 34), (6, 30, 200, 34),
                     (7, 1, 300, 34), (7, 300, 1, 34), (3, 1, 1, 34), (4, 26, 95, 0), (3, 140, 301, 48)]


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [True, False])
@pytest.mark.parametrize("n,h,w,cap", RECT_WALKER_EDGES)
def test_rect_mean_walker_edges_on_card(n, h, w, cap, inclusive):
    """Integer volumes (exact sums) with arms at the cap: the walker bit for
    bit, its word 0."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + h + w)
    vol = torch.randint(0, 9, (n, h, w), device="cuda", generator=gen).float()
    arms = _capped_arms(h, w, cap, h * w)
    got, launched, over = _walker_launches(
        aggregate_cuda, lambda: aggregate.rect_mean_aggregate(vol, arms, inclusive, max_span=cap))
    assert launched == {"rect_mean_f32": 0, "rect_mean_walker_f32": 1} and over == 0
    assert torch.equal(got, aggregate._rect_mean_aggregate_plain(vol, arms, inclusive))


@pytest.mark.cuda
def test_rect_mean_routes_by_the_cap_on_card():
    """No cap, or one above 48: the chunked-table kernels, equal to the
    walker's result where both run; arms above a cap are clamped into it
    and counted in the device word."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    vol = torch.randint(0, 9, (9, 90, 170), device="cuda", generator=gen).float()
    arms = _capped_arms(90, 170, 20, 3)
    walked, launched, _ = _walker_launches(
        aggregate_cuda, lambda: aggregate.rect_mean_aggregate(vol, arms, max_span=20))
    assert launched == {"rect_mean_f32": 0, "rect_mean_walker_f32": 1}
    for cap in (None, 49):
        got, launched, _ = _walker_launches(
            aggregate_cuda, lambda: aggregate.rect_mean_aggregate(vol, arms, max_span=cap))
        assert launched == {"rect_mean_f32": 1, "rect_mean_walker_f32": 0}
        assert torch.equal(got, walked)
    got, _, over = _walker_launches(
        aggregate_cuda, lambda: aggregate.rect_mean_aggregate(vol, arms, max_span=7))
    want = sum(int((a > 7).sum()) for a in arms)
    assert over == want > 0
    clamped = aggregate.Arms(*(a.clamp(max=7) for a in arms))
    assert torch.equal(got, aggregate._rect_mean_aggregate_plain(vol, clamped, True))


@pytest.mark.cuda
def test_rect_mean_walker_peak_below_chunked_on_card():
    """The walker holds no float64 table: its peak is the output, the
    carries and the packed arms, below the chunked route's."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(375, 450, 60, 0)
    vol = ad_census_cuda.ad_census_volumes_cuda(lt, rt, 60)[0]
    arms = aggregate.cross_arms(lt, _arm_cfg())
    peaks = []
    for cap in (SPAN, None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        aggregate.rect_mean_aggregate(vol, arms, max_span=cap)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
    assert peaks[0] < 1.2 * vol.numel() * 4 < peaks[1], peaks


@pytest.mark.cuda
@pytest.mark.parametrize("max_search", [None, 60])
@pytest.mark.parametrize("invalid", [float("inf"), -1.0], ids=["inf", "minus_one"])
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES)
def test_fill_kernel_bit_exact_on_card(h, w, d, seed, invalid, max_search):
    _, post, _, post_cuda = _agg_post_modules()
    _need_card()
    disp, occl, mism = _disp_map(h, w, seed, invalid=invalid)
    before = post_cuda.LAUNCHES["fill_holes_8dir_f32"]
    got = post.fill_holes_8dir(disp, occl, mism, invalid, max_search)
    torch.cuda.synchronize()
    assert post_cuda.LAUNCHES["fill_holes_8dir_f32"] == before + 1
    want = post._fill_holes_8dir_plain(disp, occl, mism, invalid, max_search)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("second", [True, False])
def test_fill_pass_any_target_on_card(second):
    """One pass with a target mask that also holds finite pixels (the
    sharded post's call): those are refilled from their rays as in the
    plain version."""
    _, post, _, _ = _agg_post_modules()
    _need_card()
    disp, occl, mism = _disp_map(64, 77, 5)
    target = occl | mism | (torch.rand(disp.shape, device="cuda") < 0.2)
    got = post._fill_from_candidates(disp, target, second, 9, 6)
    want = post._fill_from_candidates_plain(disp, target, second, 9, 6)
    assert torch.equal(got, want)


# The redesigned fill (bitsets of the pass's input, searched a word at a
# time) and arms (windows of the image in shared memory, 64-bit masks of
# accepted offsets) at their edges: (h, w) one row and one column of a 4K
# frame's width and height, sides that 32 and the arms' 16-row tiles do not
# divide, a 4K-wide strip
FILL_ARMS_EDGES = [(1, 3840), (2160, 1), (1, 1), (33, 65), (17, 31), (47, 129), (8, 3840)]
# max_search of the fill: caps 0 (max_search 1), 1, a word and more, at and
# beyond max(H, W), and none
FILL_CAPS = [1, 2, 34, 90, 4000, None]


@pytest.mark.cuda
@pytest.mark.parametrize("max_search", FILL_CAPS)
@pytest.mark.parametrize("h,w", FILL_ARMS_EDGES)
def test_fill_bitsets_bit_exact_at_edges_on_card(h, w, max_search):
    _, post, _, post_cuda = _agg_post_modules()
    _need_card()
    for invalid in (float("inf"), -1.0):
        disp, occl, mism = _disp_map(h, w, h + w, holes=0.4, invalid=invalid)
        got = post.fill_holes_8dir(disp, occl, mism, invalid, max_search)
        want = post._fill_holes_8dir_plain(disp, occl, mism, invalid, max_search)
        assert torch.equal(got, want), invalid


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(0, 0), (1, 1), (1, 0), (31, 22), (32, 23), (33, 23),
                                  (5000, 5000), (None, None)])
@pytest.mark.parametrize("second", [True, False])
def test_fill_pass_caps_and_targets_on_card(caps, second):
    """The one-pass entry (the sharded post's) at every cap, with a target
    mask holding finite pixels, on a non-contiguous map and mask."""
    _, post, _, post_cuda = _agg_post_modules()
    _need_card()
    disp, occl, mism = _disp_map(150, 301, 7, holes=0.5)
    gen = torch.Generator(device="cuda").manual_seed(3)
    target = occl | mism | (torch.rand(disp.shape, device="cuda", generator=gen) < 0.2)
    for d, t in ((disp, target), (disp.t(), target.t()), (disp[::2, 1::3], target[::2, 1::3])):
        before = post_cuda.LAUNCHES["fill_pass_f32"]
        got = post._fill_from_candidates(d, t, second, *caps)
        assert post_cuda.LAUNCHES["fill_pass_f32"] == before + 1
        assert torch.equal(got, post._fill_from_candidates_plain(d, t, second, *caps))


@pytest.mark.cuda
def test_fill_all_invalid_and_one_valid_on_card():
    _, post, _, _ = _agg_post_modules()
    _need_card()
    for invalid in (float("inf"), -1.0):
        d = torch.full((90, 130), invalid, device="cuda")
        occl = torch.ones_like(d, dtype=torch.bool)
        mism = torch.zeros_like(occl)
        for max_search in (None, 5):
            assert torch.equal(post.fill_holes_8dir(d, occl, mism, invalid, max_search),
                               post._fill_holes_8dir_plain(d, occl, mism, invalid, max_search))
            one = d.clone()
            one[45, 64] = 4.0
            got = post.fill_holes_8dir(one, occl, mism, invalid, max_search)
            assert torch.equal(got, post._fill_holes_8dir_plain(one, occl, mism, invalid,
                                                                max_search))
            assert int((got == 4.0).sum()) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("max_length", [1, 34, 64, 65, 130, 252, 253])
@pytest.mark.parametrize("kind", ["u8", "float32", "colour u8", "colour float32"])
@pytest.mark.parametrize("h,w", FILL_ARMS_EDGES)
def test_cross_arms_windows_bit_exact_at_edges_on_card(h, w, kind, max_length):
    """Blocks at the image's borders, max_length 1, 64, 65 and 130, the
    grey u8 kernel's largest cap (252) and the generic kernel above it."""
    from stereo_match_traditional_tpu_torch.config import CrossArmConfig

    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(h * w + max_length)
    # flat runs (long arms) broken by steps and noise (short ones)
    steps = torch.randint(0, 200, (h // 37 + 1, w // 23 + 1), device="cuda", generator=gen)
    img = steps.repeat_interleave(37, 0).repeat_interleave(23, 1)[:h, :w]
    noise = torch.randint(-9, 10, (h, w), device="cuda", generator=gen)
    img = (img + noise * (torch.rand((h, w), device="cuda", generator=gen) < 0.3)).clamp(0, 255)
    img = img.to(torch.uint8)
    if kind.startswith("colour"):
        img = torch.stack([img, img.roll(1, 1), img // 2 + 40], dim=-1)
    if kind.endswith("float32"):
        img = img.float() * 0.75
    cfg = CrossArmConfig(tao1=30, tao2=6, max_length=max_length, sec_length=max_length // 2)
    got = aggregate.cross_arms(img, cfg)
    want = aggregate._cross_arms_plain(img, cfg)
    for name, g, x in zip(("left", "right", "up", "down"), got, want):
        assert torch.equal(g, x), name


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 1, 2, 3, 5, 37])
def test_cross_arms_u8_band_views_on_card(start):
    """Grey u8 bands as views of a taller image (rows of 450 bytes, so the
    band's first byte sits anywhere in its 32-bit word): the u8 kernel's
    unaligned loads, bit for bit with the plain version."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    img = _images(120, 450, 60, 6)[0]
    band = img[start: start + 75]
    assert band.is_contiguous() and band.data_ptr() % 4 == (start * 450) % 4
    for ro in (start - 34, start):
        got = aggregate.cross_arms(band, _arm_cfg(), ro, 120)
        want = aggregate._cross_arms_plain(band, _arm_cfg(), ro, 120)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("tao1,tao2", [(0, 0), (6.5, 0.5), (-1, 6), (30, -0.5), (255, 300),
                                       (float("inf"), 6), (float("nan"), 6)])
def test_cross_arms_thresholds_on_card(tao1, tao2):
    """Float thresholds that the u8 kernel takes as integers (0, fractions,
    below 0, 255 and above), and a NaN one, which the generic kernel takes."""
    from stereo_match_traditional_tpu_torch.config import CrossArmConfig

    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    img = _images(60, 140, 20, 9)[0]
    cfg = CrossArmConfig(tao1=tao1, tao2=tao2, max_length=34, sec_length=17)
    for g, w_ in zip(aggregate.cross_arms(img, cfg), aggregate._cross_arms_plain(img, cfg)):
        assert torch.equal(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("max_length", [1, 34, 70])
@pytest.mark.parametrize("row_offset,global_rows", [(-3, 30), (0, 19), (5, 24), (5, 60),
                                                    (-40, 19)])
def test_cross_arms_band_windows_on_card(row_offset, global_rows, max_length):
    """Band rows clamped into the band in the vertical windows, the rules
    on global rows, rows beyond the image's border (row_offset < 0), with
    NaN pixels in a float32 colour band."""
    from stereo_match_traditional_tpu_torch.config import CrossArmConfig

    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    img = _images(19, 45, 8, 4, colour=True)[0].float()
    img[3, 7, 1] = img[10, 20, 0] = float("nan")
    cfg = CrossArmConfig(tao1=30, tao2=6, max_length=max_length, sec_length=17)
    for x in (img, img[..., 0]):
        got = aggregate.cross_arms(x, cfg, row_offset, global_rows)
        want = aggregate._cross_arms_plain(x, cfg, row_offset, global_rows)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["8", "4", "8 background", "4 background", "zero invalid"])
@pytest.mark.parametrize("h,w,d,seed", AGG_POST_GEOMETRIES)
def test_speckle_kernel_bit_exact_on_card(h, w, d, seed, mode):
    _, post, _, post_cuda = _agg_post_modules()
    _need_card()
    invalid = 0.0 if mode == "zero invalid" else float("inf")
    background = 0.0 if "background" in mode else None
    connectivity = 4 if mode.startswith("4") else 8
    disp = _disp_map(h, w, seed, holes=0.15, invalid=invalid)[0]
    before = post_cuda.LAUNCHES["remove_speckles_f32"]
    got = post.remove_speckles(disp, 1.0, 30, invalid, background, None, connectivity)
    torch.cuda.synchronize()
    assert post_cuda.LAUNCHES["remove_speckles_f32"] == before + 1
    want = post._remove_speckles_plain(disp, 1.0, 30, invalid, background, None, connectivity)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [4, 8])
def test_speckle_kernel_serpentine_on_card(connectivity):
    _, post, _, _ = _agg_post_modules()
    _need_card()
    snake = torch.zeros((151, 120), device="cuda")
    snake[0::2, :] = 5.0
    snake[1::4, -1] = 5.0
    snake[3::4, 0] = 5.0
    got = post.remove_speckles(snake, 0.0, 9000, 0.0, connectivity=connectivity)
    assert torch.equal(got, snake)


@pytest.mark.cuda
@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("h,w", [(375, 450), (720, 1280), (33, 65), (1, 300), (300, 1)])
def test_speckle_kernel_one_component_and_checkerboard_on_card(h, w, connectivity):
    """One component over the whole map (every tile; kept at its area,
    removed one above), a checkerboard of single pixels (joined along the
    diagonals with 8-connectivity, alone with 4), and diagonal stripes that
    cross many tiles: bit for bit."""
    _, post, _, _ = _agg_post_modules()
    _need_card()
    one = torch.full((h, w), 5.0, device="cuda")
    one[::2, 1::3] = 5.5
    for area in (h * w, h * w + 1):
        got = post.remove_speckles(one, 1.0, area, connectivity=connectivity)
        assert torch.equal(got, post._remove_speckles_plain(one, 1.0, area, float("inf"), None,
                                                            None, connectivity))
    ii = torch.arange(h, device="cuda")[:, None]
    jj = torch.arange(w, device="cuda")[None, :]
    board = torch.where((ii + jj) % 2 == 0, 3.0, float("inf")).float()
    stripes = ((ii + jj) // 7 % 5).float()
    for disp, area in ((board, 2), (stripes, 40), (stripes, 4000)):
        got = post.remove_speckles(disp, 0.0, area, connectivity=connectivity)
        want = post._remove_speckles_plain(disp, 0.0, area, float("inf"), None, None,
                                           connectivity)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_speckle_kernel_rejects_short_max_iters():
    """The kernel labels to the fixpoint: an explicit cap below the plain
    version's raises on the card; the cap itself and above are taken."""
    _, post, _, post_cuda = _agg_post_modules()
    _need_card()
    disp = _disp_map(20, 30, 1)[0]
    cap = post_cuda.speckle_iteration_cap(20, 30)
    with pytest.raises(ValueError, match="max_iters"):
        post.remove_speckles(disp, 1.0, 10, max_iters=cap - 1)
    want = post._remove_speckles_plain(disp, 1.0, 10, float("inf"), None, None, 8)
    for cap_ok in (cap, cap + 5):
        assert torch.equal(post.remove_speckles(disp, 1.0, 10, max_iters=cap_ok), want)


@pytest.mark.cuda
def test_agg_post_wrappers_check_inputs():
    aggregate, post, aggregate_cuda, post_cuda = _agg_post_modules()
    _need_card()
    img = torch.zeros((6, 7), dtype=torch.uint8, device="cuda")
    with pytest.raises(ValueError, match="uint8 or float32"):
        aggregate.cross_arms(img.to(torch.int32), _arm_cfg())
    with pytest.raises(ValueError):
        aggregate.cross_arms(img[None], _arm_cfg())
    arms = aggregate.cross_arms(img, _arm_cfg())
    vol = torch.zeros((3, 6, 7), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        aggregate.rect_mean_aggregate(vol.double(), arms)
    with pytest.raises(ValueError, match="arms"):
        aggregate.rect_mean_aggregate(vol[:, :, :5], arms)
    d = torch.zeros((6, 7), device="cuda")
    mask = torch.zeros((6, 7), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="bool"):
        post.fill_holes_8dir(d, mask.float(), mask)
    with pytest.raises(ValueError, match="mask"):
        post.fill_holes_8dir(d, mask[:, :5], mask)
    with pytest.raises(ValueError):
        post.fill_holes_8dir(d, mask.cpu(), mask)
    with pytest.raises(ValueError):
        post.remove_speckles(d[None])


@pytest.mark.cuda
def test_ad_census_full_launches_agg_post_kernels_on_card(monkeypatch):
    """One FULL call launches each of the four: the arms and the rect mean
    (the strip walker: the call passes ``max_span``) once a view, the
    speckle filter once, the fill once a pass; its maps equal those of the
    same call with the plain bodies, bit for bit."""
    aggregate, post, aggregate_cuda, post_cuda = _agg_post_modules()
    _need_card()
    L, R, _ = make_pair(60, 96, 16, seed=3)
    lt, rt = pair_to_torch(L, R, "cuda")
    fn = get_pipeline("ad_census")[0]
    cfg = ADCensusConfig(disp_range=16, scanline=ScanlineConfig(), run_post=True)
    before = {**aggregate_cuda.LAUNCHES, **post_cuda.LAUNCHES}
    got = fn(lt, rt, cfg)
    torch.cuda.synchronize()
    after = {**aggregate_cuda.LAUNCHES, **post_cuda.LAUNCHES}
    assert {k: after[k] - before[k] for k in after} == {
        "cross_arms_i32": 2, "rect_mean_f32": 0, "rect_mean_walker_f32": 2, "fill_pass_f32": 0,
        "fill_holes_8dir_f32": 1, "remove_speckles_f32": 1, "cross_support_f32": 0,
        "cross_aggregate_f32": 0, "region_voting_f32": 0}
    def rect_plain(vol, arms, inclusive=True, max_span=None, layout="auto"):
        return aggregate._rect_mean_aggregate_plain(vol, arms, inclusive)

    def speckles_plain(disp, diff_insame=1.0, min_speckle_area=80, invalid_value=post.INVALID,
                       background=None, max_iters=None, connectivity=8, block=None):
        return post._remove_speckles_plain(disp, diff_insame, min_speckle_area, invalid_value,
                                           background, max_iters, connectivity)

    monkeypatch.setattr(aggregate, "cross_arms", aggregate._cross_arms_plain)
    monkeypatch.setattr(aggregate, "rect_mean_aggregate", rect_plain)
    monkeypatch.setattr(post, "fill_holes_8dir", post._fill_holes_8dir_plain)
    monkeypatch.setattr(post, "remove_speckles", speckles_plain)
    want = fn(lt, rt, cfg)
    assert {**aggregate_cuda.LAUNCHES, **post_cuda.LAUNCHES} == after
    for f in ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# -- the cross aggregation's span walker (cross_support_f32, cross_aggregate_f32)

CROSS_SPAN = ADCensusConfig().cross_params.cross_l1

# (h, w, D, seed): one row, one column, W % 4 != 0, Teddy/D=60, KITTI
# 375x1242/D=128 (the benchmark's size) and 720p/D=128
CROSS_GEOMETRIES = [(1, 67, 9, 1), (53, 1, 7, 2), (37, 61, 13, 3), (375, 450, 60, 0),
                    (375, 1242, 128, 4), (720, 1280, 128, 1)]


def _cross_launches(aggregate_cuda, fn):
    """``fn()``, the aggregation and post entries it launched (those it
    launched at all) and the arms over the cap it met (the device word)."""
    before = dict(aggregate_cuda.LAUNCHES)
    aggregate_cuda.arms_over_cap("cuda", reset=True)
    out = fn()
    torch.cuda.synchronize()
    launched = {k: aggregate_cuda.LAUNCHES[k] - before[k] for k in aggregate_cuda.LAUNCHES}
    return (out, {k: v for k, v in launched.items() if v},
            aggregate_cuda.arms_over_cap("cuda", reset=True))


# Later iterations sum float32 means in float64 prefixes that the kernel
# starts at its strip's halo and PyTorch's cumsum at lane 0, adding in
# another order: a sum rounds alike but where it lies within the prefixes'
# error of a float32 rounding boundary (one ulp of the sum, up to two of the
# mean it is divided into), and a sum of means below ~1e-6, whose float32
# ulp is finer than that error, may differ by more ulps but by no more than
# 2^-40 (the largest seen on the card: 1.7e-13 at KITTI and 720p).
CROSS_ULPS, CROSS_ATOL = 2, 2.0**-40


def _ulps_off(got, want):
    """The values outside (CROSS_ULPS, CROSS_ATOL), the values off at all,
    and the largest distance in float32 ulps."""
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    far = (ulps > CROSS_ULPS) & ((got - want).abs() > CROSS_ATOL)
    return int(far.sum()), int((ulps > 0).sum()), int(ulps.max())


def _hold_cross(vol, arms, cap, horizontal_first):
    """Each of four iterations on the plain version's input of that
    iteration (the first bit for bit, later ones within CROSS_ULPS or
    CROSS_ATOL), and the four-iteration call within them; one support and
    one iteration launch a one-iteration call, 1 + 4 a four-iteration one,
    no arm over the cap.  Returns the values off (and their largest ulps) in
    each iteration and in the call."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    x, hf, off = vol, horizontal_first, []
    for it in range(4):
        got, launched, over = _cross_launches(
            aggregate_cuda, lambda: aggregate.cross_aggregate(x, arms, 1, hf, span_cap=cap))
        assert launched == {"cross_support_f32": 1, "cross_aggregate_f32": 1} and over == 0
        want = aggregate._cross_aggregate_plain(x, arms, 1, hf)
        far, n, ulps = _ulps_off(got, want)
        assert (n if it == 0 else far) == 0, (it, far, n, ulps)
        off.append((n, ulps))
        x, hf = want, not hf
    got, launched, _ = _cross_launches(
        aggregate_cuda, lambda: aggregate.cross_aggregate(vol, arms, 4, horizontal_first,
                                                          span_cap=cap))
    assert launched == {"cross_support_f32": 1, "cross_aggregate_f32": 4}
    far, n, ulps = _ulps_off(got, aggregate._cross_aggregate_plain(vol, arms, 4,
                                                                   horizontal_first))
    assert far == 0, (far, n, ulps)
    return off + [(n, ulps)]


@pytest.mark.cuda
@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("cap", [CROSS_SPAN, None], ids=["cap34", "no_cap"])
@pytest.mark.parametrize("h,w,d,seed", CROSS_GEOMETRIES)
def test_cross_aggregate_kernel_on_card(h, w, d, seed, cap, horizontal_first):
    """The main path's inputs (AD-Census volumes of both views, canonical
    arms) through the kernel at the pipelines' cap and without one (255:
    the narrowest strip at the larger sizes)."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(h, w, d, seed)
    cp = ADCensusConfig().cross_params
    for vol, img in zip(ad_census_cuda.ad_census_volumes_cuda(lt, rt, d), (lt, rt)):
        off = _hold_cross(vol, aggregate.canonical_cross_arms(img, cp), cap, horizontal_first)
        print("values off (count, largest ulps)", (h, w, d), cap, horizontal_first, off)


# (n, h, w, cap): widths 128 does not divide, a walk shorter than the ring,
# one row, one column, one pixel, the cap 0, the largest caps of the
# 32-row and the 16-row steps of 128 lanes and the first past each (37, 38,
# 67, 68), the widest cap (255) both ways round, and short walks across
# wide images at caps past a 128-lane strip's (a ring that would fit, a
# halo that its scan lanes' registers would not)
CROSS_EDGES = [(5, 40, 65, 34), (4, 33, 255, 34), (3, 1, 300, 34), (3, 300, 1, 34),
               (2, 1, 1, 34), (4, 26, 95, 0), (2, 300, 301, 37), (2, 300, 301, 38),
               (2, 300, 301, 67), (2, 300, 301, 68), (2, 200, 700, 255), (2, 700, 200, 255),
               (3, 50, 129, 255), (2, 40, 640, 255), (2, 57, 300, 100), (2, 300, 40, 255),
               (2, 400, 60, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("horizontal_first", [True, False])
@pytest.mark.parametrize("n,h,w,cap", CROSS_EDGES)
def test_cross_aggregate_edges_on_card(n, h, w, cap, horizontal_first):
    """Integer volumes with arms at 0 and at the cap (half of them) through
    every strip width; all-zero arms give the volume back."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + h + w + cap)
    vol = torch.randint(0, 9, (n, h, w), device="cuda", generator=gen).float()
    _hold_cross(vol, _capped_arms(h, w, cap, h * w + cap), cap, horizontal_first)
    zero = aggregate.Arms(*(torch.zeros((h, w), dtype=torch.int32, device="cuda"),) * 4)
    assert torch.equal(aggregate.cross_aggregate(vol, zero, 4, horizontal_first, span_cap=cap),
                       vol)


@pytest.mark.cuda
@pytest.mark.parametrize("row_offset,global_rows", [(0, 96), (30, 96), (61, 96)])
def test_cross_aggregate_band_on_card(row_offset, global_rows):
    """A tiled band's volumes and its arms placed in a taller image (the
    executors' ``row_offset`` arms, which stop at the image's borders and
    reach past the band's)."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(global_rows, 128, 24, 6)
    rows = slice(row_offset, min(row_offset + 35, global_rows))
    bl, br = lt[rows].contiguous(), rt[rows].contiguous()
    cp = ADCensusConfig().cross_params
    vols = ad_census_cuda.ad_census_volumes_cuda(bl, br, 24, row_offset=row_offset,
                                                 global_rows=global_rows)
    for vol, img in zip(vols, (bl, br)):
        arms = aggregate.canonical_cross_arms(img, cp, row_offset, global_rows)
        _hold_cross(vol, arms, cp.cross_l1, True)


@pytest.mark.cuda
def test_cross_aggregate_cblsm_volumes_on_card():
    """cblsm's AD volumes (``cost='ad'``) with its canonical arms."""
    aggregate, _, _, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(60, 90, 16, 2)
    cfg = CBLSMConfig(disp_range=16, aggregation="cross_two_pass")
    _, stages = get_pipeline("cblsm")[0](lt, rt, cfg, return_stages=True)
    cp = cfg.cross_params
    for view, img in (("cost_left", lt), ("cost_right", rt)):
        _hold_cross(stages[view].contiguous(), aggregate.canonical_cross_arms(img, cp),
                    cp.cross_l1, True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,d,seed", [(48, 80, 16, 1), (375, 450, 60, 0)])
def test_canonical_full_launches_cross_kernel_on_card(h, w, d, seed, monkeypatch):
    """Canonical FULL launches one support and four iterations a view and
    nothing else of the aggregation kernels (region voting keeps its plain
    span sums); its maps equal the same call's with the plain version."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    lt, rt = _images(h, w, d, seed)
    fn = get_pipeline("ad_census")[0]
    cfg = ADCensusConfig(disp_range=d, aggregation="cross_two_pass", scanline=ScanlineConfig(),
                         run_post=True)
    got, launched, over = _cross_launches(aggregate_cuda, lambda: fn(lt, rt, cfg))
    assert launched == {"cross_support_f32": 2, "cross_aggregate_f32": 8} and over == 0

    def plain(vol, arms, num_iters=4, horizontal_first=True, max_arm=None, method="auto",
              span_cap=None):
        return aggregate._cross_aggregate_plain(vol, arms, num_iters, horizontal_first)

    monkeypatch.setattr(aggregate, "cross_aggregate", plain)
    want = fn(lt, rt, cfg)
    for f in ("disp_left", "disp_right", "disp_final"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
def test_cross_aggregate_counts_arms_over_the_cap_on_card():
    """Arms above the cap are clamped into it and counted in the device
    word; the result is the plain version's on the clamped arms."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)
    vol = torch.randint(0, 9, (9, 90, 170), device="cuda", generator=gen).float()
    arms = _capped_arms(90, 170, 20, 3)
    got, launched, over = _cross_launches(
        aggregate_cuda, lambda: aggregate.cross_aggregate(vol, arms, 1, True, span_cap=7))
    assert launched == {"cross_support_f32": 1, "cross_aggregate_f32": 1}
    assert over == sum(int((a > 7).sum()) for a in arms) > 0
    clamped = aggregate.Arms(*(a.clamp(max=7) for a in arms))
    assert torch.equal(got, aggregate._cross_aggregate_plain(vol, clamped, 1, True))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "contiguous", "arms_shape", "arms_dtype",
                                 "arms_device", "cap"])
def test_cross_aggregate_checks_inputs_on_card(bad):
    """What the kernel does not take raises before any launch."""
    aggregate, _, aggregate_cuda, _ = _agg_post_modules()
    _need_card()
    vol = torch.zeros((3, 12, 20), device="cuda")
    arms = _capped_arms(12, 20, 4, 1)
    cap = 4
    if bad == "dtype":
        vol = vol.double()
    elif bad == "contiguous":
        vol = torch.zeros((3, 20, 12), device="cuda").transpose(1, 2)
    elif bad == "arms_shape":
        arms = aggregate.Arms(*(a[:, 1:] for a in arms))
    elif bad == "arms_dtype":
        arms = aggregate.Arms(*(a.long() for a in arms))
    elif bad == "arms_device":
        arms = aggregate.Arms(*(a.cpu() for a in arms))
    else:
        cap = -3
    before = dict(aggregate_cuda.LAUNCHES)
    with pytest.raises(ValueError):
        aggregate.cross_aggregate(vol, arms, 4, span_cap=cap)
    assert aggregate_cuda.LAUNCHES == before
