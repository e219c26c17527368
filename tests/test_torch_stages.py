"""Stage re-entry of the port against the JAX package's: ``return_stages``
on the five pipelines (plus ad_census FULL and canonical FULL), the port's
``utils.checkpoint`` and ``models.registry.finish_from_volumes``, across
both packages' stage directories."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu.models import registry as jregistry
from stereo_match_traditional_tpu.models.base import StereoResult as JaxResult
from stereo_match_traditional_tpu.utils import checkpoint as jckpt
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models import registry
from stereo_match_traditional_tpu_torch.models.base import StereoResult
from stereo_match_traditional_tpu_torch.ops.aggregate import Arms
from stereo_match_traditional_tpu_torch.utils import checkpoint
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict, pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

H, W, D = 24, 32, 8
CASES = {
    "sad": ("sad", cfgs.SADConfig(max_disparity=D)),
    "sad_post": ("sad", cfgs.SADConfig(max_disparity=D, run_post=True)),
    "ncc": ("ncc", cfgs.NCCConfig(disp_range=D, win_size=3)),
    "asw": ("asw", cfgs.ASWConfig(disp_range=D, win_size=3)),
    "ad_census": ("ad_census", cfgs.ADCensusConfig(disp_range=D)),
    "ad_census_full": ("ad_census", cfgs.ADCensusConfig(
        disp_range=D, scanline=cfgs.ScanlineConfig(), run_post=True)),
    "canonical_full": ("ad_census", cfgs.ADCensusConfig(
        disp_range=D, aggregation="cross_two_pass", scanline=cfgs.ScanlineConfig(),
        run_post=True)),
    "cblsm": ("cblsm", cfgs.CBLSMConfig(disp_range=D, run_post=True)),
}
ARMS = tuple(f"arms_left_{k}" for k in Arms._fields)
# The envelopes of the parity files for each stage against JAX's:
# tests/test_torch_ad_census_ops.py (AD-Census cost rtol/atol 1e-6, the
# float64 rect mean rtol 1e-5 / atol 1e-3), tests/test_torch_volume.py (asw
# cost rtol 1e-5 / atol 1e-4), tests/test_torch_canonical.py (cross sums rtol
# 1e-5 with atol 1e-4, its widest; arms exact), tests/test_torch_sad_ncc.py and
# test_torch_cblsm.py (SAD, NCC and AD volumes exact).  A scanline's output
# carries its input's difference along each path: its input's envelope.
EXACT = dict(rtol=0, atol=0)
STAGE_TOL = {
    ("sad", "cost"): EXACT, ("ncc", "cost"): EXACT, ("cblsm", "cost"): EXACT,
    ("asw", "cost"): dict(rtol=1e-5, atol=1e-4),
    ("ad_census", "cost"): dict(rtol=1e-6, atol=1e-6),
    ("ad_census", "aggregated"): dict(rtol=1e-5, atol=1e-3),
    ("cblsm", "aggregated"): dict(rtol=1e-5, atol=1e-3),
}
# test_torch_ad_census.py's map envelopes: WTA maps >= 99.5 % of pixels,
# post-processed maps and masks >= 99 %; disp_right outside the clamp
# triangle (columns x <= W - D), where exact ties of the port's float64 sums
# are broken by rounding in JAX's float32 ones.
MIN_AGREE = {"disp_left": 0.995, "disp_right": 0.995, "disp_final": 0.99,
             "occlusion": 0.99, "mismatch": 0.99}


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be ~1e-4 off on the first call of a
    process (see tests/test_torch_ad_census.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


@functools.lru_cache(maxsize=None)
def _pair():
    return make_pair(H, W, D, seed=5)[:2]


@functools.lru_cache(maxsize=None)
def _jax_run(case):
    name, cfg = CASES[case]
    L, R = _pair()
    res, stages = jax_get_pipeline(name)[0](jnp.asarray(L), jnp.asarray(R), cfg,
                                            return_stages=True)
    return res, {k: np.asarray(v) for k, v in stages.items()}


@functools.lru_cache(maxsize=None)
def _port_run(case, return_stages):
    name, cfg = CASES[case]
    return get_pipeline(name)[0](*pair_to_torch(*_pair(), "cpu"), port_cfg(cfg),
                                 return_stages=return_stages)


def _volumes(stages):
    """``(vol_l, vol_r, arms_left)`` that finish_from_volumes takes."""
    vol_l = stages.get("aggregated_left", stages["cost_left"])
    vol_r = stages.get("aggregated_right", stages.get("cost_right"))
    arms = {k: stages[f"arms_left_{k}"] for k in Arms._fields} if ARMS[0] in stages else None
    return vol_l, vol_r, arms


def _assert_equal_results(got, want):
    for f in StereoResult._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype and torch.equal(g, w), f


def _agreement(got, want, fields=tuple(MIN_AGREE)):
    """Fraction of equal pixels of each field of two NumPy results, held to
    ``MIN_AGREE``."""
    for f in fields:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape, b.shape, a.dtype, b.dtype)
        if f == "disp_right":
            a, b = a[:, : W - D + 1], b[:, : W - D + 1]
        same = float((a == b).mean())
        assert same >= MIN_AGREE[f], (f, same)


@pytest.mark.parametrize("case", CASES)
def test_stage_names_shapes_and_dtypes_match_jax(case):
    _, want = _jax_run(case)
    _, got = _port_run(case, True)
    assert list(got) == list(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert v.numpy().dtype == want[k].dtype, k
    assert (ARMS[0] in got) == (case == "canonical_full")


@pytest.mark.parametrize("case", CASES)
def test_stage_values_match_jax(case):
    """Each stage within its parity file's envelope (``STAGE_TOL``; the
    canonical family's volumes within the cross sums', its arms exact)."""
    name, _ = CASES[case]
    _, want = _jax_run(case)
    _, got = _port_run(case, True)
    for k, v in got.items():
        g, w = v.numpy(), want[k]
        if k.startswith("arms_left_"):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        kind = k.split("_")[0]
        tol = (dict(rtol=1e-5, atol=1e-4) if case == "canonical_full" and kind == "aggregated"
               else STAGE_TOL[name, kind])
        np.testing.assert_allclose(g, w, **tol, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_result_with_stages_equals_without(case):
    with_stages, _ = _port_run(case, True)
    _assert_equal_results(with_stages, _port_run(case, False))


@pytest.mark.parametrize("case", CASES)
def test_finish_from_own_stages_is_bit_exact(case):
    name, cfg = CASES[case]
    want, stages = _port_run(case, True)
    vol_l, vol_r, arms = _volumes(stages)
    got = registry.finish_from_volumes(name, vol_l, vol_r, port_cfg(cfg), arms)
    if case == "sad":           # the active path computes no right view
        assert vol_r is None and got.disp_right is None
    _assert_equal_results(got, want)


@pytest.mark.parametrize("case", CASES)
def test_finish_from_saved_stages_is_bit_exact(case, tmp_path):
    """Through the port's checkpoint: save every stage and the result,
    load them back (NumPy), re-enter on the CPU."""
    name, cfg = CASES[case]
    want, stages = _port_run(case, True)
    d = str(tmp_path)
    checkpoint.save_result(d, want, meta={"pipeline": name})
    for k, v in stages.items():
        checkpoint.save_array(d, k, v)
    loaded = {k: torch.from_numpy(checkpoint.load_array(d, k)) for k in stages}
    got = registry.finish_from_volumes(name, *_volumes(loaded)[:2], port_cfg(cfg),
                                       _volumes(loaded)[2])
    _assert_equal_results(got, want)
    saved = checkpoint.load_result(d)
    for f in StereoResult._fields:
        v = getattr(want, f)
        assert (getattr(saved, f) is None) == (v is None)
        if v is not None:
            np.testing.assert_array_equal(getattr(saved, f), v.numpy())


@pytest.mark.parametrize("case", CASES)
def test_finish_from_jax_checkpoint_agrees_with_jax(case, tmp_path):
    """JAX's stages, saved by JAX's checkpoint and loaded by the port's:
    the port's finish agrees with JAX's finish from the same volumes."""
    name, cfg = CASES[case]
    _, stages = _jax_run(case)
    d = str(tmp_path)
    for k, v in stages.items():
        jckpt.save_array(d, k, v)
    loaded = {k: checkpoint.load_array(d, k) for k in stages}
    vol_l, vol_r, arms = _volumes(loaded)
    want = jregistry.finish_from_volumes(name, vol_l, vol_r, cfg, arms)
    got = registry.finish_from_volumes(
        name, torch.from_numpy(vol_l), None if vol_r is None else torch.from_numpy(vol_r),
        port_cfg(cfg), None if arms is None else {k: torch.from_numpy(a) for k, a in arms.items()})
    _agreement(StereoResult(*(None if v is None else v.numpy() for v in got)),
               JaxResult(*(None if v is None else np.asarray(v) for v in want)))


@pytest.mark.parametrize("case", ["asw", "ad_census_full", "canonical_full", "cblsm"])
def test_jax_reenters_the_ports_stage_directory(case, tmp_path):
    """The other way round: the port's ``save_result`` / ``save_array``
    directory, loaded by JAX's checkpoint, re-enters JAX's pipeline, and the
    maps agree with the port's run."""
    name, cfg = CASES[case]
    res, stages = _port_run(case, True)
    d = str(tmp_path)
    checkpoint.save_result(d, res, meta={"pipeline": name})
    for k, v in stages.items():
        checkpoint.save_array(d, k, v)
    loaded = {k: jckpt.load_array(d, k) for k in stages}
    vol_l, vol_r, arms = _volumes(loaded)
    want = jregistry.finish_from_volumes(name, vol_l, vol_r, cfg, arms)
    _agreement(jckpt.load_result(d), JaxResult(*(None if v is None else np.asarray(v)
                                                 for v in want)))


@pytest.mark.parametrize("form", ["Arms", "tuple", "dict"])
def test_canonical_arms_in_every_form(form):
    name, cfg = CASES["canonical_full"]
    want, stages = _port_run("canonical_full", True)
    arms = [stages[k] for k in ARMS]
    arms = {"Arms": Arms(*arms), "tuple": tuple(arms),
            "dict": dict(zip(Arms._fields, arms))}[form]
    got = registry.finish_from_volumes(name, stages["aggregated_left"],
                                       stages["aggregated_right"], port_cfg(cfg), arms)
    _assert_equal_results(got, want)


@pytest.mark.parametrize("case", ["asw", "ad_census", "cblsm"])
def test_missing_right_volume_raises(case):
    name, cfg = CASES[case]
    _, stages = _port_run(case, True)
    with pytest.raises(ValueError, match="both views"):
        registry.finish_from_volumes(name, _volumes(stages)[0], None, port_cfg(cfg))


def test_canonical_post_without_arms_raises():
    name, cfg = CASES["canonical_full"]
    _, stages = _port_run("canonical_full", True)
    vol_l, vol_r, _ = _volumes(stages)
    with pytest.raises(ValueError, match="arms_left"):
        registry.finish_from_volumes(name, vol_l, vol_r, port_cfg(cfg))
    # without the post the arms are not needed, as in JAX
    no_post = dataclasses.replace(port_cfg(cfg), run_post=False)
    got = registry.finish_from_volumes(name, vol_l, vol_r, no_post)
    full = _port_run("canonical_full", False)
    assert got.disp_final is None
    assert torch.equal(got.disp_left, full.disp_left) and torch.equal(got.disp_right,
                                                                      full.disp_right)


def test_unknown_pipeline_raises():
    with pytest.raises(KeyError, match="unknown pipeline"):
        registry.finish_from_volumes("bogus", torch.zeros(2, 3, 4), None, None)


def test_numpy_volumes_go_to_the_card():
    """The entry-point rule: NumPy volumes go to the card, so without one
    the call raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    name, cfg = CASES["sad"]
    _, stages = _port_run("sad", True)
    with pytest.raises((RuntimeError, AssertionError)):
        registry.finish_from_volumes(name, stages["cost_left"].numpy(), None, port_cfg(cfg))


def test_checkpoint_files_equal_jax_files(tmp_path):
    """The same values saved by both packages give the same bytes: every
    ``.npy`` and the manifest; tensors of any layout save their logical
    values (a view of rows padded to 4 columns, as the scanline kernels
    return)."""
    rng = np.random.default_rng(0)
    padded = torch.from_numpy(rng.random((3, 5, 8), dtype=np.float32))
    view = padded[:, :, :7]                      # W % 4 != 0: not contiguous
    assert not view.is_contiguous()
    res = StereoResult(torch.arange(12.0).reshape(3, 4), None, torch.ones(3, 4),
                       torch.zeros(3, 4, dtype=torch.bool), None)
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    checkpoint.save_result(str(port_dir), res, meta={"pipeline": "test"})
    checkpoint.save_array(str(port_dir), "aggregated_left", view)
    jckpt.save_result(str(jax_dir), JaxResult(*(None if v is None else v.numpy() for v in res)),
                      meta={"pipeline": "test"})
    jckpt.save_array(str(jax_dir), "aggregated_left", np.ascontiguousarray(view.numpy()))
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir())
    assert names == ["aggregated_left.npy", "disp_final.npy", "disp_left.npy", "manifest.json",
                     "occlusion.npy"]
    for n in names:
        assert (port_dir / n).read_bytes() == (jax_dir / n).read_bytes(), n
    np.testing.assert_array_equal(checkpoint.load_array(str(port_dir), "aggregated_left"),
                                  view.numpy())
    assert checkpoint.has_stage(str(port_dir), "disp_left")
    assert not checkpoint.has_stage(str(port_dir), "disp_right")
    loaded = checkpoint.load_result(str(port_dir))
    assert loaded.disp_right is None and loaded.mismatch is None
    assert loaded.occlusion.dtype == np.bool_
