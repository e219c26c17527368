"""The port's public signatures against the JAX package's, and the
behaviour of the arguments that make them equal.

A caller moving from the JAX package to the port passes the same
arguments in the same positions, so every public function of the port's
``models/*`` and ``ops/{post,volume,wta,aggregate,scanline}`` that has a JAX
counterpart of the same name takes the same parameter names in the same
order, but for the exceptions listed here."""

import dataclasses
import importlib
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import ad_census as jadc
from stereo_match_traditional_tpu.ops import aggregate as jagg
from stereo_match_traditional_tpu.ops import post as jpost
from stereo_match_traditional_tpu.ops import volume as jvol
from stereo_match_traditional_tpu.ops import wta as jwta
from stereo_match_traditional_tpu_torch.models import ad_census as tadc
from stereo_match_traditional_tpu_torch.models import asw as tasw
from stereo_match_traditional_tpu_torch.ops import aggregate as tagg
from stereo_match_traditional_tpu_torch.ops import post as tpost
from stereo_match_traditional_tpu_torch.ops import wta as twta
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict, pair_to_torch, result_to_numpy,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

MODULES = ["models.ad_census", "models.asw", "models.base", "models.cblsm", "models.ncc",
           "models.registry", "models.sad", "ops.post", "ops.volume", "ops.wta",
           "ops.aggregate", "ops.scanline"]
# Trailing keywords of the JAX package's tiled and streamed executors (row
# bands and disparity blocks), which the port has not yet (ROADMAP.md Queue 1
# item 9): the port may lack them at the end of a signature.
EXECUTOR_ONLY = ("row_offset", "global_rows", "d_offset")
# Parameters the port adds at the end: ncc_interior_mask builds its mask on
# a torch device, where JAX's takes the executors' row offset.
PORT_ONLY = {("ops.volume", "ncc_interior_mask"): ("device",)}


def _public_pairs(module):
    port = importlib.import_module(f"stereo_match_traditional_tpu_torch.{module}")
    ref = importlib.import_module(f"stereo_match_traditional_tpu.{module}")
    for name, fn in vars(port).items():
        if name.startswith("_") or not inspect.isfunction(fn) or fn.__module__ != port.__name__:
            continue
        other = getattr(ref, name, None)
        if inspect.isfunction(other):
            yield name, fn, other


@pytest.mark.parametrize("module", MODULES)
def test_public_signatures_match_jax(module):
    pairs = list(_public_pairs(module))
    assert pairs or module == "models.base", module
    for name, fn, other in pairs:
        port = list(inspect.signature(fn).parameters)
        ref = list(inspect.signature(other).parameters)
        kept = list(ref)
        while kept and kept[-1] in EXECUTOR_ONLY and kept[-1] not in port:
            kept.pop()
        assert port == kept + list(PORT_ONLY.get((module, name), ())), (name, port, ref)


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be ~1e-4 off on the first call of a
    process (see tests/test_torch_ad_census_ops.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


@pytest.mark.parametrize("aggregation", ["rect_mean", "none"])
def test_ad_census_pipeline_takes_colour_positionally(aggregation):
    """A fourth and fifth positional argument are the colour images, as in
    JAX; the ported aggregations ignore them as JAX does: the same result as
    without them, and JAX's on >= 99.5 % of WTA pixels."""
    L, R, _ = make_pair(24, 32, 6, seed=3)
    Lc, Rc = (np.stack([x, x // 2, 255 - x], axis=-1) for x in (L, R))
    cfg = cfgs.ADCensusConfig(disp_range=6, aggregation=aggregation)
    lt, rt = pair_to_torch(L, R, "cpu")
    got = result_to_numpy(tadc.ad_census_pipeline(lt, rt, port_cfg(cfg), _t(Lc), _t(Rc)))
    plain = result_to_numpy(tadc.ad_census_pipeline(lt, rt, port_cfg(cfg)))
    want = jadc.ad_census_pipeline(jnp.asarray(L), jnp.asarray(R), cfg, jnp.asarray(Lc),
                                   jnp.asarray(Rc))
    for f in ("disp_left", "disp_right"):
        np.testing.assert_array_equal(getattr(got, f), getattr(plain, f))
    agree = float((got.disp_left == np.asarray(want.disp_left)).mean())
    assert agree >= 0.995, agree


def test_asw_pipeline_takes_lab_and_return_stages():
    """``left_lab`` / ``right_lab`` sit where JAX has them and change nothing
    on the ported variant; ``return_stages=True`` raises naming item 8, as
    the other four pipelines do."""
    L, R, _ = make_pair(16, 20, 4, seed=2)
    lt, rt = pair_to_torch(L, R, "cpu")
    cfg = port_cfg(cfgs.ASWConfig(disp_range=4, win_size=1, run_post=False))
    with_lab = tasw.asw_pipeline(lt, rt, cfg, None, None)
    assert torch.equal(with_lab.disp_left, tasw.asw_pipeline(lt, rt, cfg).disp_left)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8"):
        tasw.asw_pipeline(lt, rt, cfg, return_stages=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 8"):
        tasw.asw_pipeline(lt, rt, cfg, None, None, True)


_D = 10


def _maps(seed, h=24, w=32):
    """Integer disparities in [0, D) with flat patches and noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, _D, size=(h // 4 + 1, w // 4 + 1))
    dl = np.kron(coarse, np.ones((4, 4)))[:h, :w]
    dl = np.where(rng.random((h, w)) < 0.15, rng.integers(0, _D, size=(h, w)), dl)
    dr = np.where(rng.random((h, w)) < 0.3, rng.integers(0, _D, size=(h, w)), dl)
    return dl.astype(np.float32), dr.astype(np.float32)


@pytest.mark.parametrize("check", ["lr_check_consistency", "lr_check_simple"])
def test_lr_checks_take_disp_range(check):
    """``disp_range`` is accepted, positionally too, and ignored: the same
    result as without it and as JAX's with it."""
    dl, dr = _maps(5)
    port, ref = getattr(tpost, check), getattr(jpost, check)
    without = port(_t(dl), _t(dr), 1.0, np.inf)
    want = ref(dl, dr, 1.0, np.inf, _D)
    for got in (port(_t(dl), _t(dr), 1.0, np.inf, _D), port(_t(dl), _t(dr), 1.0, disp_range=_D)):
        for g, n, w in zip(got, without, want, strict=True):
            assert torch.equal(g, n)
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_remove_speckles_max_iters_position(connectivity):
    """The sixth positional argument is ``max_iters`` and the seventh
    ``connectivity``, as in JAX: ``(d, diff, area, invalid, background,
    None, connectivity)`` gives JAX's result."""
    dl, _ = _maps(6)
    dl[dl == 3] = np.inf
    want = np.asarray(jpost.remove_speckles(dl, 1.0, 9, np.inf, 0.0, None, connectivity))
    got = tpost.remove_speckles(_t(dl), 1.0, 9, np.inf, 0.0, None, connectivity).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != dl).any()


def test_remove_speckles_max_iters_caps_the_sweeps():
    """``max_iters=0`` runs no sweep: every valid pixel is a component of its
    own, so an area limit of 2 removes them all; a cap above what the map
    needs changes nothing."""
    dl, _ = _maps(7)
    none = tpost.remove_speckles(_t(dl), 1.0, 2, max_iters=0)
    assert torch.isinf(none).all()
    assert torch.equal(tpost.remove_speckles(_t(dl), 1.0, 9, max_iters=50),
                       tpost.remove_speckles(_t(dl), 1.0, 9))


def _wta_volume():
    """Costs whose minimum lies at d=0 for some pixels, with ties and a
    second minimum within eps elsewhere."""
    rng = np.random.default_rng(8)
    vol = rng.integers(0, 6, size=(_D, 12, 16)).astype(np.float32)
    vol[0, :4, :] = -1.0                        # the minimum at d=0
    vol[:, 4, :] = 2.0                          # all equal
    vol[3, 5, :] = vol[6, 5, :] = -3.0          # tied minimum: lowest d wins
    vol[4, 6, :], vol[5, 6, :] = -2.0, -1.995   # second minimum within eps
    return vol


@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("exclude_d0", [True, False])
def test_optimal_disparity_exclude_d0(exclude_d0, subpixel):
    """Both values of ``exclude_d0`` bit-exact with JAX.  With ``False`` the
    scan starts at d=0, which then wins where it is the minimum and is
    rejected as a range end; with ``True`` the seed of the second minimum
    rejects those pixels: 0 either way."""
    vol = _wta_volume()
    want = np.asarray(jwta.optimal_disparity(vol, 0.01, subpixel, exclude_d0))
    got = twta.optimal_disparity(_t(vol), 0.01, subpixel, exclude_d0).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:4] == 0).all() and (got != 0).any()


@pytest.mark.parametrize("layout", ["auto", "dmajor", "pixel_major"])
@pytest.mark.parametrize("max_span", [None, 34])
def test_rect_mean_aggregate_takes_max_span_and_layout(layout, max_span):
    """Every JAX layout and ``max_span`` run the port's one layout: the
    same bits as the default call, and JAX's result with the same arguments
    within tests/test_torch_ad_census_ops.py's SAT tolerance."""
    L, R, _ = make_pair(13, 17, 5, seed=3)
    arms_cfg = cfgs.CrossArmConfig(tao1=30)
    vol = np.asarray(jvol.ad_census_volume(L, R, 5))
    arms = tagg.cross_arms(_t(L), port_cfg(arms_cfg))
    got = tagg.rect_mean_aggregate(_t(vol), arms, True, max_span, layout)
    assert torch.equal(got, tagg.rect_mean_aggregate(_t(vol), arms))
    want = jagg.rect_mean_aggregate(jnp.asarray(vol), jagg.cross_arms(L, arms_cfg), True,
                                    max_span, layout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-3)


def test_rect_mean_aggregate_rejects_unknown_layout():
    L, _, _ = make_pair(8, 9, 3, seed=1)
    arms = tagg.cross_arms(_t(L), port_cfg(cfgs.CrossArmConfig()))
    with pytest.raises(ValueError, match="layout"):
        tagg.rect_mean_aggregate(torch.zeros((3, 8, 9)), arms, layout="rows")
