"""The serving surfaces of the port on the card: stage re-entry, the
checkpoint of padded-view volumes and ``serve_pairs``.

This file imports neither jax nor the JAX package, so on a machine with a
card and no jax it runs without the suite's conftest:

    python -m pytest tests/test_torch_surfaces_cuda.py -m cuda --noconftest -q

Without a CUDA device every test skips itself.
"""

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch.config import (
    ADCensusConfig,
    ASWConfig,
    CBLSMConfig,
    NCCConfig,
    SADConfig,
    ScanlineConfig,
)
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.batch import batched_pipeline, serve_pairs
from stereo_match_traditional_tpu_torch.models.registry import finish_from_volumes
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_cuda,
    scanline_canonical_cuda,
    scanline_cuda,
)
from stereo_match_traditional_tpu_torch.utils import checkpoint, loader
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

# W = 45: no multiple of 4, so the scanline kernels' outputs are views of
# padded rows.
H, W, D = 30, 45, 12
CASES = {
    "sad": ("sad", SADConfig(max_disparity=D, run_post=True)),
    "ncc": ("ncc", NCCConfig(disp_range=D, win_size=4)),
    "asw": ("asw", ASWConfig(disp_range=D, win_size=4)),
    "ad_census_full": ("ad_census", ADCensusConfig(disp_range=D, scanline=ScanlineConfig(),
                                                   run_post=True)),
    "canonical_full": ("ad_census", ADCensusConfig(disp_range=D, aggregation="cross_two_pass",
                                                   scanline=ScanlineConfig(), run_post=True)),
    "cblsm": ("cblsm", CBLSMConfig(disp_range=D, run_post=True)),
}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _equal(got, want):
    for f, w in zip(want._fields, want):
        g = getattr(got, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g.is_cuda and torch.equal(g, w), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_reentry_on_card_is_bit_exact(case, tmp_path):
    """The result with stages equals the one without; the stages saved,
    loaded and re-entered on the card give the original maps bit for bit."""
    _need_card()
    name, cfg = CASES[case]
    lt, rt = pair_to_torch(*make_pair(H, W, D, seed=1)[:2], "cuda")
    fn = get_pipeline(name)[0]
    want = fn(lt, rt, cfg)
    res, stages = fn(lt, rt, cfg, return_stages=True)
    _equal(res, want)
    d = str(tmp_path)
    checkpoint.save_result(d, res)
    for k, v in stages.items():
        checkpoint.save_array(d, k, v)
    load = {k: checkpoint.load_array(d, k) for k in stages}   # NumPy: to the card
    arms = ({k: load[f"arms_left_{k}"] for k in ("left", "right", "up", "down")}
            if "arms_left_up" in load else None)
    got = finish_from_volumes(name, load.get("aggregated_left", load["cost_left"]),
                              load.get("aggregated_right", load.get("cost_right")), cfg, arms)
    _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("canonical", [False, True])
def test_checkpoint_of_padded_scanline_views(canonical, tmp_path):
    """The scanline kernels' ``[D, H, W]`` views of rows padded to 4
    columns (not contiguous at W % 4 != 0) save their logical values."""
    _need_card()
    lt, rt = pair_to_torch(*make_pair(H, W, D, seed=2)[:2], "cuda")
    vol = torch.rand((D, H, W), device="cuda") * 50
    if canonical:
        out = scanline_canonical_cuda.scanline_optimize_canonical_cuda(
            vol, lt, rt, 1.0, 3.0, 15.0, "left")
    else:
        out = scanline_cuda.scanline_optimize_cuda(vol, lt, ScanlineConfig())
    assert out.shape == (D, H, W) and not out.is_contiguous()
    checkpoint.save_array(str(tmp_path), "v", out)
    back = checkpoint.load_array(str(tmp_path), "v")
    assert back.shape == (D, H, W) and back.dtype == np.float32
    np.testing.assert_array_equal(back, out.contiguous().cpu().numpy())


@pytest.mark.cuda
def test_serve_pairs_on_card_equals_single_calls(tmp_path):
    """Seven pairs in batches of 3 (the last partial) over the loader: one
    map a pair, each the single call's bit for bit, one cost launch a
    pair."""
    _need_card()
    cfg = ADCensusConfig(disp_range=D)
    pairs = [make_pair(H, W, D, seed=s)[:2] for s in range(7)]
    paths = []
    for k, (l, r) in enumerate(pairs):
        lp, rp = str(tmp_path / f"l{k}.pgm"), str(tmp_path / f"r{k}.pgm")
        loader.write_pnm(lp, l)
        loader.write_pnm(rp, r)
        paths.append((lp, rp))
    fn = get_pipeline("ad_census")[0]
    want = [fn(*pair_to_torch(l, r, "cuda"), cfg).disp_left.cpu().numpy() for l, r in pairs]
    ad_census_cuda.LAUNCHES = 0
    got = list(serve_pairs("ad_census", loader.PairLoader(paths, threads=2, depth=2), cfg,
                           batch_size=3))
    assert ad_census_cuda.LAUNCHES == 7 and len(got) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ls = torch.stack([pair_to_torch(l, r, "cuda")[0] for l, r in pairs[:3]])
    rs = torch.stack([pair_to_torch(l, r, "cuda")[1] for l, r in pairs[:3]])
    batched = batched_pipeline("ad_census", cfg)(ls, rs)
    for k in range(3):
        np.testing.assert_array_equal(batched.disp_left[k].cpu().numpy(), want[k])


@pytest.mark.cuda
def test_serve_pairs_on_card_copies_through_page_locked_memory():
    """Five pairs in batches of 2 (the last partial): each map the single
    call's bit for bit and held in page-locked host memory, which stays
    valid after later batches reuse the allocator's blocks."""
    _need_card()
    cfg = ADCensusConfig(disp_range=D, scanline=ScanlineConfig(), run_post=True)
    pairs = [make_pair(H, W, D, seed=s)[:2] for s in range(5)]
    fn = get_pipeline("ad_census")[0]
    want = [fn(*pair_to_torch(l, r, "cuda"), cfg).disp_final.cpu().numpy() for l, r in pairs]
    got = list(serve_pairs("ad_census", iter(pairs), cfg, batch_size=2))
    assert len(got) == 5
    for g, w in zip(got, want):
        assert torch.from_numpy(g).is_pinned()
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_native_loader_pairs_are_page_locked_and_served_as_they_lie(tmp_path):
    """On a card host the native loader yields each pair in page-locked
    buffers of its own; ``serve_pairs`` copies them up as they lie (batches
    of one) and its maps are the single calls', bit for bit."""
    _need_card()
    from stereo_match_traditional_tpu_torch.utils import native

    cfg = ADCensusConfig(disp_range=D, scanline=ScanlineConfig(), run_post=True)
    pairs = [make_pair(H, W, D, seed=s)[:2] for s in range(4)]
    paths = []
    for k, (l, r) in enumerate(pairs):
        paths.append((str(tmp_path / f"l{k}.pgm"), str(tmp_path / f"r{k}.pgm")))
        native.write_pnm(paths[-1][0], l)
        native.write_pnm(paths[-1][1], r)
    got = list(native.PairLoader(paths, threads=2, depth=2))
    for (gl, gr), (wl, wr) in zip(got, pairs, strict=True):
        assert torch.from_numpy(gl).is_pinned() and torch.from_numpy(gr).is_pinned()
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)
    fn = get_pipeline("ad_census")[0]
    want = [fn(*pair_to_torch(l, r, "cuda"), cfg).disp_final.cpu().numpy() for l, r in pairs]
    served = list(serve_pairs("ad_census", native.PairLoader(paths, threads=2, depth=2), cfg))
    for g, w in zip(served, want, strict=True):
        np.testing.assert_array_equal(g, w)
