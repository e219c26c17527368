"""The port's public signatures against the JAX package's, and the
behaviour of the arguments that make them equal.

A caller moving from the JAX package to the port passes the same
arguments in the same positions, so every public function of the port's
``models/*``, ``ops/{post,volume,wta,aggregate,scanline,filters}``,
``utils/{checkpoint,io,native,profiling,synthetic}`` and
``parallel/{streamed,tiled,halo,mesh,distributed,scan_carry,wta_shard,
post_shard}`` that has a JAX counterpart of
the same name takes the same parameter names in the same order, but for the
exceptions listed here; every public function, class and constant of those
JAX modules exists in the port or is listed here with its reason; and the
port's ``parallel`` package exports the JAX package's names but the one
listed."""

import ast
import dataclasses
import importlib
import inspect
import types

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

MODULES = ["models.ad_census", "models.asw", "models.base", "models.batch", "models.cblsm",
           "models.ncc", "models.registry", "models.sad", "ops.post", "ops.volume", "ops.wta",
           "ops.aggregate", "ops.scanline", "ops.filters", "utils.checkpoint", "utils.io",
           "utils.native", "utils.profiling", "utils.synthetic", "parallel.streamed",
           "parallel.tiled", "parallel.halo", "parallel.mesh", "parallel.distributed",
           "parallel.scan_carry", "parallel.wta_shard", "parallel.post_shard"]
# Trailing keywords of JAX signatures that the port may lack: none since the
# multi-device executors came (the sharded post's median_filter row window,
# the (tile, disp) runners' d_offset).
EXECUTOR_ONLY = {}
# Public names of the walked JAX modules that the port has not, with the
# reason.  Every other public name of those modules exists in the port.
TPU_ONLY = "TPU-only: an XLA:TPU compiler workaround"
NO_TORCH = ("no torch counterpart: a sharded-input XLA program (ROADMAP.md Queue 1 item 9, "
            "gspmd)")
ABSENT = {("ops.scanline", "rev_materialized"): TPU_ONLY,
          ("parallel", "gspmd_pipeline"): NO_TORCH}
# Parameters the port adds at the end: ncc_interior_mask builds its mask on
# a torch device, where JAX's takes the executors' row offset; serve_pairs
# takes its pairs from the host to the card unless asked for the CPU;
# initialize takes the process group's backend (NCCL on the card, gloo on
# the CPU or for processes that share a card); the banded passes take their
# kernels' direction along the path and whether to keep the band or only the
# outgoing carry (the streamed executor's bottom-up sweep), which JAX's
# callers express by flipping the band and dropping the result.
BANDED_KERNEL_ARGS = ("reverse", "store")
PORT_ONLY = {("ops.volume", "ncc_interior_mask"): ("device",),
             ("models.batch", "serve_pairs"): ("device",),
             ("parallel.distributed", "initialize"): ("backend",),
             ("ops.scanline", "directional_pass_banded"): BANDED_KERNEL_ARGS,
             ("ops.scanline", "canonical_pass_banded"): BANDED_KERNEL_ARGS}


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
        waiting = EXECUTOR_ONLY.get((module, name), ())
        while kept and kept[-1] in waiting and kept[-1] not in port:
            kept.pop()
        assert port == kept + list(PORT_ONLY.get((module, name), ())), (name, port, ref)


def _public_names(ref) -> list:
    """The public functions, classes and constants that the JAX module
    ``ref`` defines at its top level (not the names it imports)."""
    tree = ast.parse(inspect.getsource(ref))
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in names if not n.startswith("_")]


def _missing(module, ref, port) -> list:
    """Public names of ``ref`` that ``port`` lacks and ABSENT does not list."""
    return [n for n in _public_names(ref)
            if not hasattr(port, n) and (module, n) not in ABSENT]


@pytest.mark.parametrize("module", MODULES)
def test_public_names_exist_in_port(module):
    """Every public function, class and constant of the JAX module exists in
    the port, or is listed in ABSENT with its reason; a listed name is one
    the port lacks and the JAX module has."""
    port = importlib.import_module(f"stereo_match_traditional_tpu_torch.{module}")
    ref = importlib.import_module(f"stereo_match_traditional_tpu.{module}")
    assert _missing(module, ref, port) == []
    for (mod, name), reason in ABSENT.items():
        if mod == module:
            assert reason in (TPU_ONLY, NO_TORCH)
            assert name in _public_names(ref) and not hasattr(port, name), name


def test_parallel_package_exports_jax_names():
    """The port's ``parallel`` package exports every name the JAX package's
    does (its ``__init__`` imports them) but ``gspmd_pipeline``, listed in
    ABSENT with its reason."""
    port = importlib.import_module("stereo_match_traditional_tpu_torch.parallel")
    ref = importlib.import_module("stereo_match_traditional_tpu.parallel")
    tree = ast.parse(inspect.getsource(ref))
    names = [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             for a in node.names]
    assert "run_tiled" in names and "gspmd_pipeline" in names
    missing = [n for n in names if not hasattr(port, n)]
    assert missing == [n for (mod, n) in ABSENT if mod == "parallel"] == ["gspmd_pipeline"]
    assert ABSENT[("parallel", "gspmd_pipeline")] == NO_TORCH


def test_names_check_flags_a_missing_name():
    """The check sees a public JAX name the port lacks: a port module that
    lacks ``speckle_connectivity`` is flagged, and one that has every name
    is not."""
    ref = importlib.import_module("stereo_match_traditional_tpu.ops.post")
    port = importlib.import_module("stereo_match_traditional_tpu_torch.ops.post")
    lacking = types.ModuleType("lacking")
    vars(lacking).update({k: v for k, v in vars(port).items() if k != "speckle_connectivity"})
    assert _missing("ops.post", ref, lacking) == ["speckle_connectivity"]
    assert _missing("ops.post", ref, port) == []


def test_invalid_and_speckle_connectivity_match_jax():
    """``volume.INVALID`` is the post chains' marker, and
    ``post.speckle_connectivity``'s four masks equal JAX's on a map with
    invalid pixels, ties at the threshold and image borders."""
    tvol = importlib.import_module("stereo_match_traditional_tpu_torch.ops.volume")
    assert tvol.INVALID == tpost.INVALID == float(jvol.INVALID) == float("inf")
    dl, _ = _maps(9)
    dl[dl == 2] = np.inf
    valid = np.isfinite(dl)
    want = jpost.speckle_connectivity(jnp.asarray(dl), jnp.asarray(valid), 1.0)
    got = tpost.speckle_connectivity(_t(dl), _t(valid), 1.0)
    assert len(got) == 4
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(g.any() and not g.all() for g in got)


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
    on the ported variant; ``return_stages`` is the sixth positional
    argument, as in JAX: by keyword or by position it returns the same
    result and the stages ``cost_left`` / ``cost_right``."""
    L, R, _ = make_pair(16, 20, 4, seed=2)
    lt, rt = pair_to_torch(L, R, "cpu")
    cfg = port_cfg(cfgs.ASWConfig(disp_range=4, win_size=1, run_post=False))
    plain = tasw.asw_pipeline(lt, rt, cfg)
    with_lab = tasw.asw_pipeline(lt, rt, cfg, None, None)
    assert torch.equal(with_lab.disp_left, plain.disp_left)
    for res, stages in (tasw.asw_pipeline(lt, rt, cfg, return_stages=True),
                        tasw.asw_pipeline(lt, rt, cfg, None, None, True)):
        assert list(stages) == ["cost_left", "cost_right"]
        assert stages["cost_left"].shape == (4, 16, 20)
        assert torch.equal(res.disp_left, plain.disp_left)
        assert torch.equal(res.disp_right, plain.disp_right)


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
