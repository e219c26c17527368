"""Disparity ranges above 256 (the kernels' wide route) against the JAX
package on the CPU.

On the card, above 256 disparities ``scanline_optimize_cuda`` and
``scanline_optimize_canonical_cuda`` run their four passes as banded passes
from a zero carry (``ops.kernels.scanline_banded_cuda.
scanline_optimize_composed`` / ``scanline_canonical_composed``, each pass a
launch of the wide kernel), and the band entries their two horizontal
passes.  Here the same compositions run on CPU tensors with each launch
stood in for by the plain banded pass (``banded_on_cpu``): they are held
bit for bit to the port's whole-image plain bodies and to the JAX
package's ``scanline_optimize`` (bit for bit) and
``scanline_optimize_canonical`` (bit for bit op by op; within 8 ulp of its
compiled scans, ROADMAP.md Queue 3); and the flagship FULL pipeline at D =
300 to JAX's under ``tests/test_torch_ad_census.py``'s envelopes.  Inputs
are seeded NumPy arrays."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.models import get_pipeline as jax_get_pipeline
from stereo_match_traditional_tpu.ops import scanline as jscan
from stereo_match_traditional_tpu.ops import volume as jvolume
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.ops import scanline as tscan
from stereo_match_traditional_tpu_torch.ops.kernels import scanline_banded_cuda as banded
from stereo_match_traditional_tpu_torch.ops.kernels import scanline_canonical_cuda, scanline_cuda
from stereo_match_traditional_tpu_torch.utils.convert import (
    config_from_dict, pair_to_torch, result_to_numpy,
)
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair
from banded_on_cpu import plain_launch
from test_torch_ad_census import _agreement

# (D, H, W) above 256 disparities, D > W, and the wide kernel's route edges
# on the card: 513 (past 16 values a walker lane) and 1025 (past 1024, the
# shared-memory route)
SHAPES = [(300, 6, 9), (260, 5, 7), (513, 5, 6), (1025, 5, 5)]
CONFIGS = [cfgs.ScanlineConfig(),
           cfgs.ScanlineConfig(faithful_vertical_l2=True, faithful_vertical_p2=True)]


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be ~1e-4 off on the first call of a
    process (see tests/test_torch_ad_census.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


@pytest.fixture
def launch_on_cpu(monkeypatch):
    """The banded kernels' raw launch stood in for by the plain passes."""
    monkeypatch.setattr(banded, "_launch", plain_launch)


def _inputs(d, h, w, seed):
    rng = np.random.default_rng(seed)
    cost = (rng.random((d, h, w)) * 20).astype(np.float32)
    left = rng.integers(0, 256, (h, w)).astype(np.uint8)
    right = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return cost, left, right


def _ulps(a, b):
    a = a.astype(np.float32).view(np.int32).astype(np.int64)
    b = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("cfg", CONFIGS, ids=["default", "vertical_quirks"])
@pytest.mark.parametrize("d,h,w", SHAPES)
def test_composed_scanline_matches_plain_and_jax(d, h, w, cfg, launch_on_cpu):
    """The legacy composition bit for bit with the port's plain
    ``scanline_optimize`` and the JAX package's, both vertical quirks."""
    cost, gray, _ = _inputs(d, h, w, d + h)
    port = config_from_dict("ScanlineConfig", dataclasses.asdict(cfg))
    p1, p2 = port.effective_penalties(d)
    got = banded.scanline_optimize_composed(torch.from_numpy(cost), torch.from_numpy(gray), p1,
                                            p2, not port.faithful_vertical_l2,
                                            port.faithful_vertical_p2)
    assert got.shape == (d, h, w) and got.is_contiguous()
    plain = tscan.scanline_optimize(torch.from_numpy(cost), torch.from_numpy(gray), port)
    assert torch.equal(got, plain)
    want = jscan.scanline_optimize(jnp.asarray(cost), jnp.asarray(gray), cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("view", ["left", "right"])
@pytest.mark.parametrize("d,h,w", SHAPES)
def test_composed_canonical_matches_plain_and_jax(d, h, w, view, launch_on_cpu):
    """The canonical composition bit for bit with the port's plain
    ``scanline_optimize_canonical`` and with JAX's run op by op."""
    cost, left, right = _inputs(d, h, w, d + w)
    args = (torch.from_numpy(cost), torch.from_numpy(left), torch.from_numpy(right), 1.0, 3.0,
            15.0, view)
    got = banded.scanline_canonical_composed(*args)
    assert got.shape == (d, h, w) and got.is_contiguous()
    assert torch.equal(got, tscan.scanline_optimize_canonical(*args))
    with jax.disable_jit():
        want = jscan.scanline_optimize_canonical(jnp.asarray(cost), jnp.asarray(left),
                                                 jnp.asarray(right), 1.0, 3.0, 15.0, view)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_composed_canonical_near_compiled_jax(launch_on_cpu):
    """Within 8 ulp of JAX's compiled scans (four passes, ROADMAP.md Queue 3's
    envelope of a few ulp a pass)."""
    d, h, w = SHAPES[0]
    cost, left, right = _inputs(d, h, w, 5)
    got = banded.scanline_canonical_composed(torch.from_numpy(cost), torch.from_numpy(left),
                                             torch.from_numpy(right), 1.0, 3.0, 15.0, "right")
    want = jscan.scanline_optimize_canonical(jnp.asarray(cost), jnp.asarray(left),
                                             jnp.asarray(right), 1.0, 3.0, 15.0, "right")
    assert _ulps(got.numpy(), np.asarray(want)) <= 8


def test_wrappers_on_cpu_take_the_plain_versions_above_256():
    """On CPU tensors the whole-image scanlines at D = 300 run their plain
    bodies and launch nothing."""
    cost, left, right = (torch.from_numpy(x) for x in _inputs(*SHAPES[0], 3))
    before = (dict(banded.LAUNCHES), scanline_cuda.LAUNCHES, scanline_canonical_cuda.LAUNCHES)
    got = tscan.scanline_optimize(cost, left)
    assert torch.equal(got, tscan._scanline_optimize_plain(cost, left))
    got = tscan.scanline_optimize_canonical(cost, left, right)
    assert torch.equal(got, tscan._scanline_optimize_canonical_plain(cost, left, right))
    assert before == (banded.LAUNCHES, scanline_cuda.LAUNCHES, scanline_canonical_cuda.LAUNCHES)


@pytest.mark.parametrize("canonical", [False, True], ids=["legacy", "canonical"])
def test_pass_entry_dispatch(canonical):
    """The explicit dispatch: the walker / mover kernel for D <= 256 with
    contiguous lanes, the wide kernel above 256 disparities or for strided
    lanes (the old horizontal layout)."""
    band = torch.zeros((257, 6, 9))
    for d, view, want in ((256, band[:256].permute(1, 0, 2), banded.WALKER),
                          (257, band.permute(1, 0, 2), banded.WIDE),
                          (256, band[:256].permute(2, 0, 1), banded.WIDE)):
        pen = torch.zeros(view.shape) if canonical else torch.zeros((view.shape[0],
                                                                     view.shape[2]))
        assert banded.pass_entry(canonical, d, view, pen) == want[canonical]
    assert banded.pass_entry(canonical, 8, torch.zeros((4, 8, 1)), torch.zeros((4, 8, 1)))\
        == banded.WALKER[canonical]


def test_full_pipeline_at_300_disparities_matches_jax():
    """ad_census FULL at D = 300 on a 24 x 320 pair, port (CPU) against the
    JAX package, under the flagship's envelopes (WTA maps >= 99.5 %, the
    post-processed map >= 99 %; ``disp_right`` outside the clamp
    triangle)."""
    d = 300
    L, R, _ = make_pair(24, 320, d, seed=6)
    cfg = cfgs.ADCensusConfig(disp_range=d, scanline=cfgs.ScanlineConfig(), run_post=True)
    jres = jax_get_pipeline("ad_census")[0](jnp.asarray(L), jnp.asarray(R), cfg)
    port = config_from_dict("ADCensusConfig", dataclasses.asdict(cfg))
    got = result_to_numpy(get_pipeline("ad_census")[0](*pair_to_torch(L, R, "cpu"), port))
    assert got.disp_left.max() <= d - 1
    _agreement(jres._asdict(), got._asdict(), d)


@pytest.mark.parametrize("canonical", [False, True], ids=["legacy", "canonical"])
def test_rows_pass_the_band_as_it_lies(canonical, monkeypatch, launch_on_cpu):
    """The horizontal passes above 256 disparities (``_rows``, under both
    band entries and both composed routes) hand the passes the band's own
    ``[W, D, t]`` view, a halo-cropped one too: no row-contiguous copy.  The
    results (the launches stood in for by the plain passes) equal the plain
    horizontal passes."""
    d, t, w = 300, 4, 9
    cost, left, right = (torch.from_numpy(x) for x in _inputs(d, t + 4, w, 11))
    band = cost.narrow(1, 2, t)
    rows_l, rows_r = left[2:-2], right[2:-2]
    seen = []
    run = banded._pass

    def recorded(canonical_, c, *args):
        seen.append(c)
        return run(canonical_, c, *args)

    monkeypatch.setattr(banded, "_pass", recorded)
    if canonical:
        s = tscan.horizontal_scales(d, rows_l, rows_r, 15.0, False)
        got = banded._rows(True, band, s[:-1], s[1:], 1.0, 3.0)
        want = tscan.canonical_horizontal_passes_banded(band, rows_l, rows_r, 1.0, 3.0, 15.0,
                                                        False)
    else:
        grey = rows_l.float()
        got = banded._rows(False, band, *tscan.horizontal_p2(grey, 0.5, 4.0), 0.5, 0.0)
        want = tscan.horizontal_passes_banded(band, grey, 0.5, 4.0)
    assert len(seen) == 2
    for c in seen:
        assert c.data_ptr() == band.data_ptr() and c.stride() == band.permute(2, 0, 1).stride()
    for g, v in zip(got, want):
        assert g.shape == (d, t, w) and torch.equal(g, v)


# [D, t, W] bands and the view a pass takes of them: a vertical pass's
# permute(1, 0, 2), a horizontal one's permute(2, 0, 1), a halo-cropped
# band's, one row, one column
LAYOUTS = [("vertical", (300, 7, 9), None), ("horizontal", (300, 7, 9), None),
           ("horizontal", (300, 7, 9), 2), ("horizontal", (257, 1, 9), None),
           ("vertical", (257, 7, 1), 1)]


@pytest.mark.parametrize("kind,shape,halo", LAYOUTS)
def test_wide_output_in_the_band_layout(kind, shape, halo):
    """The output a wide launch writes (``_empty_in_layout`` of the cost
    view, through whose strides the kernel's movers pick their copy order)
    is a new ``[D, t, W]`` band, contiguous, seen through the same
    permutation: the composed routes and band entries return contiguous
    volumes with no copy."""
    d, t, w = shape
    band = torch.zeros((d, t + 2 * (halo or 0), w))
    if halo:
        band = band.narrow(1, halo, t)
    perm = (1, 0, 2) if kind == "vertical" else (2, 0, 1)
    view = band.permute(*perm)
    out = banded._empty_in_layout(view)
    assert out.shape == view.shape
    back = out.permute(*[perm.index(i) for i in range(3)])
    assert back.shape == (d, t, w) and back.is_contiguous()


@pytest.mark.parametrize("t,w", [(4, 9), (1, 7), (6, 1)])
@pytest.mark.parametrize("view", ["left", "right"])
def test_horizontal_scales_run_along_the_columns(t, w, view):
    """``horizontal_scales`` (the canonical horizontal passes' penalties above
    256 disparities) lies in memory as the band does, ``[D, t, W + 1]``: the
    steps of a row side by side, the order in which the wide kernel copies
    a band read as it lies.  Its values are the JAX package's."""
    rng = np.random.default_rng(t * w)
    base, match = (rng.integers(0, 256, (t, w)).astype(np.uint8) for _ in range(2))
    got = tscan.horizontal_scales(300, torch.from_numpy(base), torch.from_numpy(match), 15.0,
                                  view == "right")
    assert got.shape == (w + 1, 300, t)
    assert got.permute(1, 2, 0).is_contiguous()
    for half in (got[:-1], got[1:]):
        assert half.stride(0) == 1
    g = np.pad(base.astype(np.float32).T, ((1, 1), (0, 0)), mode="edge")     # [W + 2, t]
    g2 = np.asarray(jvolume.shifted_stack(jnp.asarray(match, jnp.float32), 300, view))
    g2 = np.pad(g2.transpose(2, 0, 1), ((1, 1), (0, 0), (0, 0)), mode="edge")  # [W + 2, D, t]
    want = jscan.canonical_scale(g[1:], g[:-1], g2[1:], g2[:-1], 15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
