"""The port's streamed executor (``parallel.streamed``) against its direct
pipelines and the JAX package's streamed executor, and the executor
keywords (``row_offset`` / ``global_rows``) of the ops it runs against
JAX's, on seeded ``make_pair`` inputs on the CPU.

Envelopes are ``tests/test_streamed.py``'s: SAD exact; elsewhere at most
0.5 % of pixels differ outside the clamp triangle (the left ``D`` columns,
the right ``D`` of the right view), where argmin ties break apart."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.parallel import run_streamed as jax_run_streamed
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import volume as tvol
from stereo_match_traditional_tpu_torch.parallel import (
    auto_row_tile,
    receptive_field_rows,
    run_streamed,
    streamed_canonical_staged,
    streamed_pipeline,
)
from stereo_match_traditional_tpu_torch.utils import io
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict, pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

FIELDS = ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch")


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be ~1e-4 off on the first call of a
    process (see tests/test_torch_ad_census_ops.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The banded passes' plain versions run thousands of ops on tensors of a
    few hundred values, which a pool of threads only slows, the more so
    beside other test workers; the module runs torch on one thread and
    restores the setting after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mismatch(a, b, ignore_cols, side="left"):
    sl = slice(ignore_cols, None) if side == "left" else slice(None, -ignore_cols or None)
    a, b = np.asarray(a)[:, sl], np.asarray(b)[:, sl]
    return float(np.mean(a != b))


def _agree(got, want, d, exact):
    """Every map of ``want`` in ``got``, within the envelope."""
    for field in FIELDS:
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is None:
            continue
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        frac = _mismatch(g, w.numpy() if isinstance(w, torch.Tensor) else w, d,
                         "right" if field == "disp_right" else "left")
        assert frac == 0.0 if exact else frac <= 5e-3, (field, frac)


SCANLINE = cfgs.ScanlineConfig()
QUIRKS = cfgs.ScanlineConfig(faithful_vertical_l2=True, faithful_vertical_p2=True)
CASES = {
    "sad": cfgs.SADConfig(max_disparity=10, winsize=1),
    "ad_census": cfgs.ADCensusConfig(disp_range=10),
    "cblsm": cfgs.CBLSMConfig(disp_range=10),
    "asw": cfgs.ASWConfig(disp_range=10, win_size=2),
    "ncc": cfgs.NCCConfig(disp_range=10, win_size=2),
    "ad_census FULL": cfgs.ADCensusConfig(disp_range=10, scanline=SCANLINE, run_post=True),
    "ad_census FULL quirks": cfgs.ADCensusConfig(disp_range=10, scanline=QUIRKS, run_post=True),
    "sad post": cfgs.SADConfig(max_disparity=10, winsize=1, run_post=True),
}


@pytest.fixture(scope="module")
def pair():
    """make_pair(53, 64, 10, seed=1): 53 rows, a partial last band of 5."""
    L, R, _ = make_pair(53, 64, 10, seed=1)
    return L, R, pair_to_torch(L, R, "cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_streamed_matches_direct(case, pair):
    """All five pipelines (ad_census with and without the scanline, both
    quirk flags; sad with its post) over bands of 16 rows against the port's
    direct path."""
    name = case.split()[0]
    cfg = port_cfg(CASES[case])
    _, _, (lt, rt) = pair
    fn, _ = get_pipeline(name)
    want = fn(lt, rt, cfg)
    got = run_streamed(name, lt, rt, cfg, row_tile=16)
    _agree(got, want, 10, exact=name == "sad")


@pytest.mark.parametrize("case", ["sad", "cblsm", "ncc", "ad_census FULL"])
def test_streamed_matches_jax_streamed(case, pair):
    """The port's streamed executor against the JAX package's on the same
    bands."""
    name = case.split()[0]
    L, R, (lt, rt) = pair
    want = jax_run_streamed(name, L, R, CASES[case], row_tile=16)
    got = run_streamed(name, lt, rt, port_cfg(CASES[case]), row_tile=16)
    _agree(got, want, 10, exact=name == "sad")


def test_streamed_single_band_resets_at_the_last_row():
    """h < row_tile: one band of 16 rows holds 12 image rows and 4 padded
    ones; the bottom-up pass restarts at the true last row, so FULL equals
    direct."""
    cfg = port_cfg(cfgs.ADCensusConfig(disp_range=8, scanline=SCANLINE, run_post=True))
    lt, rt = pair_to_torch(*make_pair(12, 40, 8, seed=4)[:2], "cpu")
    want = get_pipeline("ad_census")[0](lt, rt, cfg)
    _agree(run_streamed("ad_census", lt, rt, cfg, row_tile=16), want, 8, exact=True)


def _canonical(da: bool):
    return cfgs.ADCensusConfig(
        disp_range=8, aggregation="cross_two_pass", scanline=SCANLINE, run_post=True,
        cross_params=cfgs.CrossAggregatorParams(cross_l1=5, cross_l2=3, num_iters=2,
                                                do_discontinuity_adjustment=da),
    )


@pytest.mark.parametrize("da", [False, True])
def test_streamed_canonical_fused_and_staged_match_direct(da):
    """Canonical FULL (cross_two_pass, the tso scanline on both views, the
    canonical post; with the discontinuity adjustment as a band sweep in one
    case) against the direct path; the staged form equals the fused one bit
    for bit."""
    cfg = port_cfg(_canonical(da))
    lt, rt = pair_to_torch(*make_pair(37, 48, 8, seed=3)[:2], "cpu")
    want = get_pipeline("ad_census")[0](lt, rt, cfg)
    fused = streamed_pipeline("ad_census", cfg, row_tile=16)(lt, rt)
    staged = streamed_canonical_staged(cfg, row_tile=16)(lt, rt)
    _agree(fused, want, 8, exact=False)
    for field in FIELDS:
        assert torch.equal(getattr(fused, field), getattr(staged, field)), field
    with pytest.raises(ValueError, match="canonical"):
        streamed_canonical_staged(port_cfg(cfgs.ADCensusConfig(disp_range=8)))


def test_streamed_canonical_without_scanline_runs_the_canonical_post():
    cfg = port_cfg(dataclasses.replace(_canonical(False), scanline=None))
    lt, rt = pair_to_torch(*make_pair(37, 48, 8, seed=3)[:2], "cpu")
    want = get_pipeline("ad_census")[0](lt, rt, cfg)
    _agree(run_streamed("ad_census", lt, rt, cfg, row_tile=16), want, 8, exact=False)


def test_streamed_canonical_takes_grey_images_only():
    cfg = port_cfg(_canonical(False))
    lc, rc = (torch.from_numpy(x) for x in make_pair(16, 24, 8, seed=3, color=True)[:2])
    with pytest.raises(ValueError, match="grayscale"):
        run_streamed("ad_census", lc, rc, cfg, row_tile=8)


def test_streamed_variants_match_direct():
    """A dormant cblsm cost, the asw Lab variant (the Lab pair banded like
    the grey pair as aux inputs) and the asw grid approximation."""
    L, R, _ = make_pair(37, 48, 10, seed=6)
    lt, rt = pair_to_torch(L, R, "cpu")
    cfg = port_cfg(cfgs.CBLSMConfig(disp_range=10, cost="sad_mean", win_size=1))
    want = get_pipeline("cblsm")[0](lt, rt, cfg)
    _agree(run_streamed("cblsm", lt, rt, cfg, row_tile=16), want, 10, exact=False)

    Lc, Rc, _ = make_pair(37, 48, 10, seed=6, color=True)
    lab = tuple(torch.from_numpy(io.rgb_to_lab_u8(x)) for x in (Lc, Rc))
    asw = get_pipeline("asw")[0]
    cfg = port_cfg(cfgs.ASWConfig(disp_range=10, win_size=2, variant="lab", run_post=False))
    want = asw(lt, rt, cfg, left_lab=lab[0], right_lab=lab[1])
    _agree(run_streamed("asw", lt, rt, cfg, row_tile=16, aux=lab), want, 10, exact=False)

    cfg = port_cfg(cfgs.ASWConfig(disp_range=10, win_size=2, approx="grid", approx_bins=6,
                                  run_post=False))
    _agree(run_streamed("asw", lt, rt, cfg, row_tile=16), asw(lt, rt, cfg), 10, exact=False)


def test_auto_row_tile():
    """A multiple of 8, monotone in ``memory_bytes``, at most ``h``, and a
    ValueError where no band of 16 rows fits; with ``row_tile=None`` the
    executor sizes its band and runs."""
    full = port_cfg(cfgs.ADCensusConfig(disp_range=256, scanline=SCANLINE, run_post=True))
    canon = port_cfg(dataclasses.replace(_canonical(False), disp_range=256,
                                         cross_params=cfgs.CrossAggregatorParams()))
    for cfg in (full, canon, port_cfg(cfgs.ADCensusConfig(disp_range=256))):
        picks = [auto_row_tile("ad_census", cfg, 2160, 3840, memory_bytes=gib * 2**30)
                 for gib in (32, 48, 80, 160, 640)]
        assert all(t % 8 == 0 and 16 <= t for t in picks[:-1]), picks
        assert picks == sorted(picks) and picks[-1] <= 2160, picks
        with pytest.raises(ValueError, match="no band"):
            auto_row_tile("ad_census", cfg, 2160, 3840, memory_bytes=2**30)
    assert auto_row_tile("ad_census", full, 720, 1280, memory_bytes=80 * 2**30) == 720

    L, R, _ = make_pair(24, 32, 6, seed=0)
    lt, rt = pair_to_torch(L, R, "cpu")
    cfg = port_cfg(cfgs.SADConfig(max_disparity=6, winsize=1))
    want = get_pipeline("sad")[0](lt, rt, cfg)
    assert torch.equal(run_streamed("sad", lt, rt, cfg).disp_left, want.disp_left)


# -- the executor keywords, on a band of a 48 x 64 image --------------------


HALO = receptive_field_rows("ad_census", cfgs.ADCensusConfig())


def _band(img, row_offset, rows=24):
    """``rows`` rows of ``img`` from global row ``row_offset``, clamped into
    the image (the executors' edge-replicated band)."""
    return img[np.clip(np.arange(row_offset, row_offset + rows), 0, img.shape[0] - 1)]


@pytest.fixture(scope="module")
def image():
    L, R, _ = make_pair(48, 64, 10, seed=2)
    return L, R


RO = [-HALO, 16, 40]


@pytest.mark.parametrize("ro", RO)
def test_census_with_row_offset_bit_exact(ro, image):
    """census_transform and census_volume of a band with its global row
    position: JAX's signature words and Hamming volume bit for bit."""
    L, R = (_band(x, ro) for x in image)
    hi, lo = jvol.census_transform(jnp.asarray(L), 9, 7, ro, 48)
    want = (np.asarray(hi).astype(np.int64) << 32) | (np.asarray(lo).astype(np.int64) & 0xFFFFFFFF)
    got = tvol.census_transform(torch.from_numpy(L), 9, 7, ro, 48).numpy()
    np.testing.assert_array_equal(got, want)
    for view in ("left", "right"):
        np.testing.assert_array_equal(
            tvol.census_volume(torch.from_numpy(L), torch.from_numpy(R), 10, 9, 7, view, ro,
                               48).numpy(),
            np.asarray(jvol.census_volume(jnp.asarray(L), jnp.asarray(R), 10, 9, 7, view, ro,
                                          48)))


@pytest.mark.parametrize("ro", RO)
def test_arms_and_masks_with_row_offset_bit_exact(ro, image):
    """cross_arms, canonical_cross_arms and ncc_interior_mask (also through
    ncc_volume) of a band: JAX's bit for bit."""
    L, R = (_band(x, ro) for x in image)
    arms_cfg, cp = cfgs.CrossArmConfig(), cfgs.CrossAggregatorParams()
    pairs = [(tagg.cross_arms(torch.from_numpy(L), port_cfg(arms_cfg), ro, 48),
              jagg.cross_arms(jnp.asarray(L), arms_cfg, ro, 48)),
             (tagg.canonical_cross_arms(torch.from_numpy(L), port_cfg(cp), ro, 48),
              jagg.canonical_cross_arms(jnp.asarray(L), cp, ro, 48))]
    for got, want in pairs:
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_mask = np.asarray(jvol.ncc_interior_mask(24, 64, 3, ro, 48))
    np.testing.assert_array_equal(tvol.ncc_interior_mask(24, 64, 3, ro, 48).numpy(), want_mask)
    _, interior = tvol.ncc_volume(torch.from_numpy(L), torch.from_numpy(R), 10, 3,
                                  row_offset=ro, global_rows=48)
    np.testing.assert_array_equal(interior.numpy(), want_mask)


@pytest.mark.parametrize("ro", RO)
def test_shifted_ncc_and_grid_with_row_offset(ro, image):
    """ncc_shifted_depth of a band equals JAX's map; the asw grid volume of
    a band equals JAX's within its float64-against-float32 blur tolerance
    (tests/test_torch_variants.py)."""
    L, R = (_band(x, ro) for x in image)
    lt, rt = torch.from_numpy(L), torch.from_numpy(R)
    want = jvol.ncc_shifted_depth(jnp.asarray(L), jnp.asarray(R), 6, 2, "left", False, 3, ro, 48)
    got = tvol.ncc_shifted_depth(lt, rt, 6, 2, "left", False, 3, ro, 48)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jvol.asw_volume_approx_grid(jnp.asarray(L), jnp.asarray(R), 6, 2, bins=4,
                                       row_offset=ro, global_rows=48)
    got = tvol.asw_volume_approx_grid(lt, rt, 6, 2, bins=4, row_offset=ro, global_rows=48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)


def test_band_rows_equal_the_whole_image(image):
    """The band's own rows (inside its halo) of the census, the arms and the
    AD-Census volume equal the whole image's rows bit for bit."""
    L, R = (torch.from_numpy(x) for x in image)
    ro, rows = 16 - HALO, 16 + 2 * HALO
    band = [torch.from_numpy(_band(x, ro, rows)) for x in image]
    own = slice(HALO, HALO + 16)
    whole = slice(16, 32)
    assert torch.equal(tvol.census_transform(band[0], 9, 7, ro, 48)[own],
                       tvol.census_transform(L, 9, 7)[whole])
    arms_cfg = port_cfg(cfgs.CrossArmConfig())
    for g, w in zip(tagg.cross_arms(band[0], arms_cfg, ro, 48), tagg.cross_arms(L, arms_cfg)):
        assert torch.equal(g[own], w[whole])
    got = tvol.ad_census_volume(band[0], band[1], 10, row_offset=ro, global_rows=48)
    assert torch.equal(got[:, own], tvol.ad_census_volume(L, R, 10)[:, whole])
