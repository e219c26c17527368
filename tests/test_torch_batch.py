"""Batched execution and the serving loop of the port (mirrors
tests/test_batch.py), on CPU tensors, against single calls and against the
JAX package's ``serve_pairs``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import batch as jbatch
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.batch import batched_pipeline, serve_pairs
from stereo_match_traditional_tpu_torch.ops.kernels import ad_census_cuda, window_cost_cuda
from stereo_match_traditional_tpu_torch.utils import loader
from stereo_match_traditional_tpu_torch.utils.convert import config_from_dict
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

SAD = cfgs.SADConfig(max_disparity=8, winsize=1)


def port_cfg(cfg):
    return config_from_dict(type(cfg).__name__, dataclasses.asdict(cfg))


def _pairs(n, h=32, w=44, d=8):
    return [make_pair(h, w, d, seed=s)[:2] for s in range(n)]


def _single(name, cfg, left, right):
    res = get_pipeline(name)[0](torch.from_numpy(left), torch.from_numpy(right), cfg)
    return (res.disp_final if res.disp_final is not None else res.disp_left).numpy()


@pytest.mark.parametrize("method", ["map", "vmap"])
@pytest.mark.parametrize("name,cfg", [
    ("sad", SAD),
    ("ad_census", cfgs.ADCensusConfig(disp_range=8, scanline=cfgs.ScanlineConfig(),
                                      run_post=True)),
], ids=["sad", "ad_census_full"])
def test_batched_matches_single(name, cfg, method):
    """Every populated field stacked along axis 0, each slice the single
    call's bit for bit; both methods give the same maps."""
    cfg = port_cfg(cfg)
    pairs = _pairs(3)
    ls = torch.from_numpy(np.stack([p[0] for p in pairs]))
    rs = torch.from_numpy(np.stack([p[1] for p in pairs]))
    batched = batched_pipeline(name, cfg, method=method)(ls, rs)
    fn, _ = get_pipeline(name)
    for k, (l, r) in enumerate(pairs):
        single = fn(torch.from_numpy(l), torch.from_numpy(r), cfg)
        for f, v in zip(single._fields, single):
            b = getattr(batched, f)
            assert (v is None) == (b is None), f
            if v is not None:
                assert b.shape == (3,) + v.shape and torch.equal(b[k], v), f


def test_batched_pipeline_default_config_and_errors():
    pairs = _pairs(2, 16, 20, 4)
    ls = torch.from_numpy(np.stack([p[0] for p in pairs]))
    rs = torch.from_numpy(np.stack([p[1] for p in pairs]))
    got = batched_pipeline("sad")(ls, rs)        # SADConfig() as the pipeline's default
    assert got.disp_left.shape == (2, 16, 20) and got.disp_right is None
    with pytest.raises(ValueError, match="method"):
        batched_pipeline("sad", method="scan")
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        batched_pipeline("sad")(ls[0], rs[0])
    with pytest.raises(KeyError, match="unknown pipeline"):
        batched_pipeline("bogus")


@pytest.mark.parametrize("batch_size", [1, 2, 3, 5])
def test_serve_pairs_partial_batch(batch_size):
    """One map a pair in order, the last batch partial where the pairs run
    out, each the single call's bit for bit."""
    cfg = port_cfg(SAD)
    pairs = _pairs(5)
    out = list(serve_pairs("sad", pairs, cfg, batch_size=batch_size, device="cpu"))
    assert len(out) == 5
    for got, (l, r) in zip(out, pairs):
        assert got.dtype == np.float32 and got.shape == (32, 44)
        np.testing.assert_array_equal(got, _single("sad", cfg, l, r))


def test_serve_pairs_yields_disp_final_where_the_post_runs():
    cfg = port_cfg(cfgs.SADConfig(max_disparity=8, winsize=1, run_post=True))
    pairs = _pairs(3)
    out = list(serve_pairs("sad", iter(pairs), cfg, batch_size=2, device="cpu"))
    for got, (l, r) in zip(out, pairs, strict=True):
        np.testing.assert_array_equal(got, _single("sad", cfg, l, r))


def test_serve_with_pair_loader(tmp_path):
    """Over the port's prefetching loader: the maps of the in-memory pairs,
    and no kernel launched for CPU tensors."""
    cfg = port_cfg(cfgs.ADCensusConfig(disp_range=8))
    paths, pairs = [], _pairs(4)
    for k, (l, r) in enumerate(pairs):
        lp, rp = str(tmp_path / f"l{k}.pgm"), str(tmp_path / f"r{k}.pgm")
        loader.write_pnm(lp, l)
        loader.write_pnm(rp, r)
        paths.append((lp, rp))
    before = ad_census_cuda.LAUNCHES
    out = list(serve_pairs("ad_census", loader.PairLoader(paths, threads=2, depth=2), cfg,
                           batch_size=3, device="cpu"))
    assert ad_census_cuda.LAUNCHES == before
    assert len(out) == 4 and out[0].shape == (32, 44)
    for got, want in zip(out, serve_pairs("ad_census", pairs, cfg, batch_size=3, device="cpu")):
        np.testing.assert_array_equal(got, want)


def test_served_maps_equal_jax_serve_pairs():
    """The same pairs through both packages' serve_pairs: SAD's maps are
    bit-exact with JAX's, as its volume and WTA are."""
    pairs = _pairs(5)
    want = list(jbatch.serve_pairs("sad", pairs, SAD, batch_size=2))
    before = dict(window_cost_cuda.LAUNCHES)
    got = list(serve_pairs("sad", pairs, port_cfg(SAD), batch_size=2, device="cpu"))
    assert window_cost_cuda.LAUNCHES == before
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_served_maps_agree_with_jax_ad_census():
    """The flagship's active path through both packages' serve_pairs:
    within test_torch_ad_census.py's WTA envelope (>= 99.5 % of pixels)."""
    cfg = cfgs.ADCensusConfig(disp_range=8)
    pairs = _pairs(3)
    want = list(jbatch.serve_pairs("ad_census", pairs, cfg, batch_size=2))
    got = list(serve_pairs("ad_census", pairs, port_cfg(cfg), batch_size=2, device="cpu"))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert float((g == np.asarray(w)).mean()) >= 0.995


def test_mesh_raises_naming_item_9():
    """``mesh=`` raised naming Queue 1 item 9 until the multi-device
    executors were ported; it now runs.  Over a batch axis of the world of
    one this process is (``parallel.make_mesh``), ``batched_pipeline`` and
    ``serve_pairs`` (a partial last batch padded) give the unsharded maps
    bit for bit; tests/test_torch_mesh.py runs them over four ranks."""
    from stereo_match_traditional_tpu_torch.parallel import make_mesh

    mesh = make_mesh(axis_names=("batch",))
    pairs = _pairs(3)
    ls, rs = (torch.from_numpy(np.stack(side)) for side in zip(*pairs))
    want = batched_pipeline("sad", port_cfg(SAD))(ls, rs)
    got = batched_pipeline("sad", port_cfg(SAD), mesh=mesh)(ls, rs)
    assert torch.equal(got.disp_left, want.disp_left)
    served = list(serve_pairs("sad", pairs, port_cfg(SAD), batch_size=2, mesh=mesh,
                              device="cpu"))
    assert len(served) == 3
    for g, w in zip(served, want.disp_left):
        np.testing.assert_array_equal(g, w.numpy())


def test_serve_pairs_rejects_empty_batches():
    with pytest.raises(ValueError, match="batch_size"):
        list(serve_pairs("sad", _pairs(1), port_cfg(SAD), batch_size=0, device="cpu"))
    assert list(serve_pairs("sad", [], port_cfg(SAD), device="cpu")) == []
