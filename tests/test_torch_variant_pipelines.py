"""Port parity for the pipelines that reach the dormant variants (ROADMAP.md
Queue 1 item 7): ncc ``variant='shifted'``, asw ``variant='lab'`` (both LUT
modes) and ``approx='grid'``, and cblsm's costs ``sad_mean``,
``sad_mean_v4`` and ``local_mean`` and aggregation ``rect_mean_v4``, with
their post chains, against the JAX package on the same seeded pairs; their
stages' re-entry and the asw variants' errors.  The maps agree on >= 99 % of
pixels (`PARITY.md:108-129`); the functions behind them are held to JAX in
tests/test_torch_variants.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu_torch import config as port_cfgs
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.registry import finish_from_volumes
from stereo_match_traditional_tpu_torch.ops.kernels import window_cost_cuda
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict, result_to_numpy
from stereo_match_traditional_tpu_torch.utils.io import rgb_to_lab_u8
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

MIN_MAP = 0.99


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """One small ``torch.exp`` on a permuted tensor before any parity
    check: torch's CPU exp has been seen to return values ~1e-4 off on the
    first call of a process, which is torch's doing, not the port's."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


def _t(a):
    return torch.tensor(np.asarray(a))


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _colour_pair(h, w, d, seed):
    return make_pair(h, w, d, seed=seed, color=True)


PIPELINE_CASES = {
    "ncc_shifted": ("ncc", cfgs.NCCConfig(disp_range=6, variant="shifted", alt_max_offset=8,
                                          alt_kernel=2)),
    "asw_lab": ("asw", cfgs.ASWConfig(disp_range=6, win_size=1, variant="lab")),
    "asw_lab_faithful": ("asw", cfgs.ASWConfig(disp_range=6, win_size=1, variant="lab",
                                               lab_faithful_lut=True)),
    "asw_grid": ("asw", cfgs.ASWConfig(disp_range=6, win_size=1, approx="grid",
                                       approx_bins=6)),
    "cblsm_sad_mean": ("cblsm", cfgs.CBLSMConfig(disp_range=6, cost="sad_mean", win_size=1,
                                                 run_post=True)),
    "cblsm_sad_mean_v4": ("cblsm", cfgs.CBLSMConfig(disp_range=6, cost="sad_mean_v4",
                                                    win_size=1, run_post=True)),
    "cblsm_local_mean": ("cblsm", cfgs.CBLSMConfig(disp_range=6, cost="local_mean",
                                                   run_post=True)),
    "cblsm_rect_mean_v4": ("cblsm", cfgs.CBLSMConfig(disp_range=6, aggregation="rect_mean_v4",
                                                     run_post=True)),
}


def _pipeline_inputs(name, cfg, h=20, w=30, d=6):
    """(left, right, extra keywords) as NumPy: colour for sad_mean_v4, Lab
    images of the colour pair for the Lab variant."""
    if getattr(cfg, "cost", None) == "sad_mean_v4":
        L, R, _ = _colour_pair(h, w, d, 1)
        return L, R, {}
    L, R, _ = make_pair(h, w, d, seed=1)
    if getattr(cfg, "variant", None) == "lab":
        Lc, Rc, _ = _colour_pair(h, w, d, 1)
        return L, R, {"left_lab": rgb_to_lab_u8(Lc), "right_lab": rgb_to_lab_u8(Rc)}
    return L, R, {}


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_pipelines_agree_with_jax(case):
    """``disp_left`` and ``disp_final`` (where the configuration has one) on
    >= 99 % of pixels; no kernel launch on the CPU."""
    name, cfg = PIPELINE_CASES[case]
    L, R, kw = _pipeline_inputs(name, cfg)
    want = jax_get_pipeline(name)[0](jnp.asarray(L), jnp.asarray(R), cfg,
                                     **{k: jnp.asarray(v) for k, v in kw.items()})
    before = dict(window_cost_cuda.LAUNCHES)
    got = result_to_numpy(get_pipeline(name)[0](_t(L), _t(R), port_cfg(cfg),
                                                **{k: _t(v) for k, v in kw.items()}))
    assert window_cost_cuda.LAUNCHES == before
    for f in ("disp_left", "disp_final"):
        w = getattr(want, f)
        if w is None:
            assert getattr(got, f) is None
            continue
        g, w = getattr(got, f), np.asarray(w)
        assert g.shape == L.shape[:2] and g.dtype == np.float32
        assert (g == w).mean() >= MIN_MAP, (f, (g == w).mean())


@pytest.mark.parametrize("case", ["asw_lab", "asw_grid", "cblsm_local_mean"])
def test_variant_stages_reenter(case):
    """The variants' stages re-enter through ``finish_from_volumes`` to the
    pipeline's own result, bit for bit."""
    name, cfg = PIPELINE_CASES[case]
    L, R, kw = _pipeline_inputs(name, cfg)
    cfg = port_cfg(cfg)
    res, stages = get_pipeline(name)[0](_t(L), _t(R), cfg, return_stages=True,
                                        **{k: _t(v) for k, v in kw.items()})
    back = finish_from_volumes(name, stages.get("aggregated_left", stages["cost_left"]),
                               stages.get("aggregated_right", stages["cost_right"]), cfg)
    for f in ("disp_left", "disp_right", "disp_final"):
        a, b = getattr(res, f), getattr(back, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b), f


@pytest.mark.parametrize("cfg,kw,match", [
    (port_cfgs.ASWConfig(variant="lab", approx="grid"), {"lab": True}, "approx='grid'"),
    (port_cfgs.ASWConfig(variant="lab"), {}, "left_lab/right_lab"),
    (port_cfgs.ASWConfig(approx="bogus"), {}, "unknown ASW approx"),
], ids=["lab_with_grid", "lab_without_images", "unknown_approx"])
def test_asw_variant_errors(cfg, kw, match):
    """JAX's ValueErrors, before any volume is formed."""
    x = torch.zeros((6, 8), dtype=torch.uint8)
    labs = {"left_lab": torch.zeros((6, 8, 3), dtype=torch.uint8)} if kw else {}
    labs = {**labs, "right_lab": labs["left_lab"]} if labs else {}
    with pytest.raises(ValueError, match=match):
        get_pipeline("asw")[0](x, x, cfg, **labs)
