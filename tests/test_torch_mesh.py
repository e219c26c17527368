"""The port's multi-device parts over four ranks of a gloo group on the
CPU, in one launch (``tests/torch_mesh_worker.py``, suites ``tiled`` and
``mesh``): ``run_tiled`` over four row tiles; the ``(tile, disp)`` runners
on a 2 x 2 mesh against the port's direct path and the JAX package's
runners; the sharded WTAs against the unsharded ones; the halo exchange;
the sharded post functions against the whole-image ones; batches over a
mesh; and the mesh helpers.  Envelopes as ``tests/test_torch_tiled.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.parallel import make_mesh as jax_make_mesh
from stereo_match_traditional_tpu.parallel.tiled import ad_census_tile_disp as jax_tile_disp
from stereo_match_traditional_tpu.parallel.tiled import ncc_tile_disp as jax_ncc_tile_disp
from stereo_match_traditional_tpu_torch import config as C
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.batch import batched_pipeline
from stereo_match_traditional_tpu_torch.ops import post, wta
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair
from test_torch_tiled import CASES, EXACT, case_of, hold

WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be ~1e-4 off on the first call of a
    process (see tests/test_torch_ad_census_ops.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both suites, run once by four ranks."""
    return worker.launch("tiled,mesh", WORLD, tmp_path_factory.mktemp("mesh4"))


def _same_on_every_rank(ranks, key):
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"{key} rank {r}")
    return ranks[0][key]


def test_ranks_agree_on_every_gathered_result(ranks):
    """Every result that the functions gather or reduce is the same on every
    rank (the per-rank tiles of the halo, speckle, fill and median cases
    are checked below)."""
    local = ("halo", "speckles", "fill|", "median", "mesh|grid_local")
    for key in ranks[0]:
        if not key.startswith(local):
            _same_on_every_rank(ranks, key)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_four_ranks_match_direct(case, ranks):
    """``run_tiled`` over four tiles of 12 rows (the last 9 of them
    padding) against the port's direct path."""
    name, cfg, _ = CASES[case]
    lt, rt, lab = worker.pair()
    kw = dict(left_lab=lab[0], right_lab=lab[1]) if case == "asw lab" else {}
    hold(case_of(ranks[0], case), get_pipeline(name)[0](lt, rt, cfg, **kw), name in EXACT, case)


def test_mesh_helpers(ranks):
    """``make_mesh`` over the world, its errors (more devices than the
    world, a shape that does not use them, a subset of the world), the
    second ``initialize`` and ``host_chip_mesh`` by ``LOCAL_WORLD_SIZE``."""
    r = ranks[0]
    assert list(r["mesh|grid_shape"]) == [2, 2]
    assert str(r["mesh|again"]) == "already-initialized"
    assert str(r["status|initialize"]) == "initialized"
    for label in ("too_many", "bad_shape", "subset"):
        assert "devices" in str(r[f"mesh|{label}"]), label
    assert list(r["mesh|host_chip"]) == [2, 2]
    assert list(r["mesh|host_chip_names"]) == ["host", "chip"]
    coords = sorted(tuple(ranks[k]["mesh|grid_local"]) for k in range(WORLD))
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("halo", [0, 2, 7])
def test_add_row_halo(halo, ranks):
    """Tiles of 3 rows of a 10-row image (the last padded by its edge row),
    extended by 0, 2 and 7 rows (7 > 3: three hops): each rank's rows are
    the edge-replicated image's, also beyond the image."""
    x = np.arange(10 * 3).reshape(10, 3)
    for k in range(WORLD):
        rows = np.clip(np.arange(3 * k - halo, 3 * k + 3 + halo), 0, 9)
        np.testing.assert_array_equal(ranks[k][f"halo {halo}|int"], x[rows])
        np.testing.assert_array_equal(ranks[k][f"halo {halo}|bool"], x[rows] % 3 == 0)


@pytest.mark.parametrize("d", [10, 13])
def test_wta_sharded(d, ranks):
    """The two-stage WTA over four disparity shards (D = 10 and 13: the last
    shard padded) equals the whole volume's argmin and argmax, ties to the
    lowest d."""
    vol = torch.from_numpy(worker.wta_volume(d, d))
    np.testing.assert_array_equal(ranks[0][f"wta {d}|min"], wta.wta(vol, "min").numpy())
    np.testing.assert_array_equal(ranks[0][f"wta {d}|max"], wta.wta(vol, "max").numpy())
    assert "mode" in str(ranks[0]["wta|bad_mode"])


@pytest.mark.parametrize("d", [10, 13])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("exclude_d0", [True, False])
def test_optimal_disparity_sharded(d, subpixel, exclude_d0, ranks):
    """The sharded uniqueness WTA equals ``ops.wta.optimal_disparity`` on
    the whole volume bit for bit, with garbage in the padded slots."""
    vol = torch.from_numpy(worker.wta_volume(d, d))
    want = wta.optimal_disparity(vol, 0.01, subpixel, exclude_d0).numpy()
    np.testing.assert_array_equal(ranks[0][f"optimal {d}|{subpixel} {exclude_d0}"], want)


@pytest.mark.parametrize("d", [10, 13])
@pytest.mark.parametrize("run_post", [False, True])
def test_ad_census_tile_disp(d, run_post, ranks):
    """``ad_census_tile_disp`` on the 2 x 2 mesh (two row tiles, two
    disparity slices: the cost kernel's ``d_offset``) against the direct
    pipeline."""
    lt, rt, _ = worker.pair()
    want = get_pipeline("ad_census")[0](lt, rt, C.ADCensusConfig(disp_range=d, run_post=run_post))
    hold(case_of(ranks[0], f"ad_census_tile_disp {d} {run_post}"), want, False)


@pytest.mark.parametrize("d", [10, 13])
def test_ncc_tile_disp(d, ranks):
    """``ncc_tile_disp`` on the 2 x 2 mesh against the direct pipeline, bit
    for bit."""
    lt, rt, _ = worker.pair()
    want = get_pipeline("ncc")[0](lt, rt, C.NCCConfig(disp_range=d, win_size=2))
    np.testing.assert_array_equal(ranks[0][f"ncc_tile_disp {d}|disp_left"], want.disp_left.numpy())


def test_tile_disp_runners_match_jax(ranks):
    """Both runners against the JAX package's on a 2 x 2 mesh of its host
    devices, D = 10: ncc bit for bit, ad_census within the envelope."""
    L, R = (jnp.asarray(x.numpy()) for x in worker.pair()[:2])
    mesh = jax_make_mesh(4, ("tile", "disp"), (2, 2))
    want = jax.jit(jax_tile_disp(cfgs.ADCensusConfig(disp_range=10), mesh))(L, R)
    hold(case_of(ranks[0], "ad_census_tile_disp 10 False"), want, False)
    want = jax.jit(jax_ncc_tile_disp(cfgs.NCCConfig(disp_range=10, win_size=2), mesh))(L, R)
    np.testing.assert_array_equal(ranks[0]["ncc_tile_disp 10|disp_left"],
                                  np.asarray(want.disp_left))


@pytest.mark.parametrize("conn", [4, 8])
@pytest.mark.parametrize("bg", [None, 0.0])
def test_remove_speckles_sharded(conn, bg, ranks):
    """The sharded speckle filter over four tiles of 5 rows of an 18-row map
    whose serpentine component crosses every tile: each rank's rows equal
    the whole map's filter."""
    m = torch.from_numpy(worker.speckle_map(4))
    want = post.remove_speckles(m, 1.0, 9, connectivity=conn, background=bg).numpy()
    want = want[np.clip(np.arange(20), 0, 17)]
    assert (want != worker.speckle_map(4)[np.clip(np.arange(20), 0, 17)]).any()
    for k in range(WORLD):
        got = ranks[k][f"speckles {conn} {bg}|disp"]
        rows = slice(5 * k, min(5 * k + 5, 18))
        np.testing.assert_array_equal(got[:rows.stop - rows.start], want[rows], err_msg=str(k))


def test_fill_and_median_sharded(ranks):
    """The sharded 8-direction fill (a ray cap of 4) and the halo'd
    truncate medians (3 and 5) equal the whole map's."""
    m = torch.from_numpy(worker.speckle_map(4))
    holes = torch.where(m > 7, float("inf"), m)
    occl = m.to(torch.int64) % 2 == 0
    fill = post.fill_holes_8dir(holes, occl, ~occl, max_search=4).numpy()
    med3 = post.median_filter(holes, 3).numpy()
    med5 = post.median_filter(m, 5).numpy()
    for k in range(WORLD):
        rows = slice(5 * k, min(5 * k + 5, 18))
        n = rows.stop - rows.start
        np.testing.assert_array_equal(ranks[k]["fill|disp"][:n], fill[rows], err_msg=str(k))
        np.testing.assert_array_equal(ranks[k]["median|disp"][:n], med3[rows], err_msg=str(k))
        np.testing.assert_array_equal(ranks[k]["median5|disp"][:n], med5[rows], err_msg=str(k))


def test_batched_pipeline_and_serve_pairs_over_a_mesh(ranks):
    """A batch of 8 over a batch axis of 4 ranks equals the unsharded batch
    bit for bit; a batch of 6 raises JAX's ``ValueError`` on every rank; and
    ``serve_pairs`` pads its partial last batch (6 pairs, batches of 4) and
    yields one map a pair."""
    sad = C.SADConfig(max_disparity=8, winsize=1, compute_right=True)
    pairs = [make_pair(16, 24, 8, seed=s)[:2] for s in range(6)]
    ls = torch.from_numpy(np.stack([p[0] for p in pairs[:4]] * 2))
    rs = torch.from_numpy(np.stack([p[1] for p in pairs[:4]] * 2))
    want = batched_pipeline("sad", sad)(ls, rs)
    np.testing.assert_array_equal(ranks[0]["batch|disp_left"], want.disp_left.numpy())
    np.testing.assert_array_equal(ranks[0]["batch|disp_right"], want.disp_right.numpy())
    assert "must divide the batch axis (4)" in str(ranks[0]["batch|odd"])
    served = batched_pipeline("sad", sad)(*(torch.from_numpy(np.stack(s)) for s in zip(*pairs)))
    np.testing.assert_array_equal(ranks[0]["serve|disp"], served.disp_left.numpy())
