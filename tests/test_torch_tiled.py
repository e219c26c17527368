"""The port's tiled executor (``parallel.tiled.run_tiled``) over two ranks
of a gloo group on the CPU against the port's direct pipelines and the JAX
package's ``run_tiled``; the executor at world 1 in this process; and
``stereo-torch run --executor tiled`` as a child process, alone and under
torchrun.

Envelopes are ``tests/test_parallel.py``'s: bit for bit where the ops are
the same (sad, ncc, asw, cblsm: integer costs, exact prefix sums); for the
AD-Census family, whose float sums a tile's own prefix sums and the
sharded scanline may order differently, at most 0.5 % of pixels apart
outside the clamp triangle (the left ``D`` columns, the right ``D`` of the
right view)."""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as worker
from stereo_match_traditional_tpu import config as cfgs
from stereo_match_traditional_tpu.parallel import make_mesh as jax_make_mesh
from stereo_match_traditional_tpu.parallel import run_tiled as jax_run_tiled
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.parallel import distributed, make_mesh, run_tiled
from stereo_match_traditional_tpu_torch.utils.io import read_pfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("disp_left", "disp_right", "disp_final", "occlusion", "mismatch")
CASES = worker.tiled_cases()
EXACT = ("sad", "ncc", "asw", "cblsm")


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be ~1e-4 off on the first call of a
    process (see tests/test_torch_ad_census_ops.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case of the ``tiled`` suite, run once by two ranks."""
    return worker.launch("tiled", 2, tmp_path_factory.mktemp("tiled2"))


@pytest.fixture(scope="module")
def direct():
    """The port's direct path on the suite's pair, a result a case."""
    lt, rt, lab = worker.pair()
    out = {}
    for case, (name, cfg, _) in CASES.items():
        kw = dict(left_lab=lab[0], right_lab=lab[1]) if case == "asw lab" else {}
        out[case] = get_pipeline(name)[0](lt, rt, cfg, **kw)
    return out


def _outside_triangle(field, a, d=worker.D):
    return a[:, :-d] if field == "disp_right" else a[:, d:]


def hold(got, want, exact, label=""):
    """Every field of ``want`` (a StereoResult) in ``got`` (a dict of
    arrays), bit for bit or within the envelope."""
    for field in FIELDS:
        w = getattr(want, field)
        g = got.get(field)
        assert (w is None) == (g is None), (label, field)
        if w is None:
            continue
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape, (label, field)
        if exact:
            np.testing.assert_array_equal(g, w, err_msg=f"{label} {field}")
        else:
            frac = float(np.mean(_outside_triangle(field, g) != _outside_triangle(field, w)))
            assert frac <= 5e-3, (label, field, frac)


def case_of(result, case):
    return {k.split("|")[1]: v for k, v in result.items() if k.split("|")[0] == case}


def test_ranks_return_the_same_result(ranks):
    """Every rank returns the whole result, the same bits on each."""
    assert ranks[0].keys() == ranks[1].keys()
    for key in ranks[0]:
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key], err_msg=key)
    assert str(ranks[0]["status|initialize"]) == "initialized"


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_matches_direct(case, ranks, direct):
    """The five pipelines, with and without post (gathered and sharded),
    the legacy FULL with both quirk flags, the canonical family with and
    without its scanline and discontinuity adjustment, and asw ``lab``
    with its Lab pair as aux inputs, over two row tiles of a 45-row image
    (the second padded), against the port's direct path."""
    name = CASES[case][0]
    hold(case_of(ranks[0], case), direct[case], name in EXACT, case)


JAX_CASES = {
    "sad": cfgs.SADConfig(max_disparity=worker.D, winsize=1),
    "cblsm post": cfgs.CBLSMConfig(disp_range=worker.D, run_post=True),
    "ad_census FULL": cfgs.ADCensusConfig(disp_range=worker.D, scanline=cfgs.ScanlineConfig(),
                                          run_post=True),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_tiled_matches_jax_run_tiled(case, ranks):
    """The port's two ranks against the JAX package's ``run_tiled`` over two
    of its host devices on the same pair: sad bit for bit, the others
    within the envelope."""
    L, R = (x.numpy() for x in worker.pair()[:2])
    name = CASES[case][0]
    want = jax_run_tiled(name, jnp.asarray(L), jnp.asarray(R), JAX_CASES[case],
                         jax_make_mesh(2, ("tile",)))
    hold(case_of(ranks[0], case), want, name == "sad", case)


@pytest.mark.parametrize("case", ["sad post", "asw post", "ad_census FULL", "canonical FULL DA"])
def test_world_of_one_in_process(case, direct):
    """``run_tiled`` with no mesh in a process started alone: a process
    group of world 1 (``distributed.initialize``'s single process), one
    tile, the direct path's maps."""
    name, cfg, _ = CASES[case]
    lt, rt, _ = worker.pair()
    res = run_tiled(name, lt, rt, cfg)
    hold({k: v.numpy() for k, v in res._asdict().items() if v is not None}, direct[case],
         name in EXACT, case)
    assert distributed.initialize() == "already-initialized"
    mesh = make_mesh()
    assert tuple(mesh.mesh.shape) == (1,) and mesh.mesh_dim_names == ("tile",)


def test_world_of_one_rejects_other_meshes():
    """``make_mesh``'s errors: more devices than the world, a shape that
    does not use them."""
    distributed.initialize()
    with pytest.raises(ValueError, match="devices"):
        make_mesh(2, ("tile",))
    with pytest.raises(ValueError, match="devices"):
        make_mesh(axis_names=("tile", "disp"), shape=(2, 1))
    assert tuple(make_mesh(axis_names=("tile", "disp"), shape=(1, 1)).mesh.shape) == (1, 1)


def _cli(args, tmp_path, nproc=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    if nproc is None:
        cmd = [sys.executable, "-m", "stereo_match_traditional_tpu_torch.cli", *args]
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc-per-node={nproc}",
               f"--master-port={port}", "-m", "stereo_match_traditional_tpu_torch.cli", *args]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("nproc", [None, 2])
def test_cli_run_tiled(nproc, tmp_path):
    """``stereo-torch --cpu run ad_census --executor tiled`` alone (a world
    of one) and under torchrun with two processes: one summary line, from
    rank 0, and the PFM it writes is the direct path's map within the
    envelope (sad post: bit for bit)."""
    for name, sets in (("sad", ["--set", "run_post=true", "--set", "fill_max_search=9"]),
                       ("ad_census", ["--set", "run_post=true"])):
        pfm = tmp_path / f"{name}.pfm"
        lines = _cli(["--cpu", "run", name, "--synthetic", "26x40", "--disp-range", "8",
                      "--executor", "tiled", "--out-pfm", str(pfm), *sets], tmp_path, nproc)
        assert len(lines) == 1 and lines[0]["world"] == (nproc or 1), lines
        direct = _cli(["--cpu", "run", name, "--synthetic", "26x40", "--disp-range", "8",
                       "--out-pfm", str(tmp_path / "direct.pfm"), *sets], tmp_path)[0]
        got, want = read_pfm(str(pfm)), read_pfm(str(tmp_path / "direct.pfm"))
        assert lines[0]["shape"] == direct["shape"] == [26, 40]
        if name == "sad":
            np.testing.assert_array_equal(got, want)
        else:
            assert float(np.mean(got[:, 8:] != want[:, 8:])) <= 5e-3


SLICES = {10: (0, 3, 7), 13: (0, 5, 9, 12)}


@pytest.mark.parametrize("d", sorted(SLICES))
@pytest.mark.parametrize("op,view", [(op, view) for op in ("ad_volume", "census_volume",
                                                           "ad_census_volume")
                                     for view in ("left", "right")] + [("ncc_volume", "left")])
def test_plain_d_slices_join_to_whole_volume(op, view, d):
    """The plain versions' ``d_offset`` slices (D = 10 and 13, slices of
    unequal depth) joined along d equal the whole volume bit for bit, and
    each slice equals the JAX package's with the same ``d_offset``: the
    integer parts and NCC bit for bit, the fused cost within
    tests/test_torch_ad_census_ops.py's 1e-6."""
    from stereo_match_traditional_tpu.ops import volume as jvol
    from stereo_match_traditional_tpu_torch.ops import volume as tvol

    lt, rt, _ = worker.pair()
    L, R = lt.numpy(), rt.numpy()

    def port(n, o):
        if op == "ncc_volume":
            return tvol.ncc_volume(lt, rt, n, 2, d_offset=o)[0]
        return getattr(tvol, op)(lt, rt, n, view=view, d_offset=o)

    def ref(n, o):
        if op == "ncc_volume":
            return np.asarray(jvol.ncc_volume(L, R, n, 2, d_offset=o)[0])
        return np.asarray(getattr(jvol, op)(L, R, n, view=view, d_offset=o))

    bounds = list(SLICES[d]) + [d]
    parts = [port(e - o, o) for o, e in zip(bounds, bounds[1:])]
    assert torch.equal(torch.cat(parts), port(d, 0))
    for (o, e), got in zip(zip(bounds, bounds[1:]), parts):
        if op == "ad_census_volume":
            np.testing.assert_allclose(got.numpy(), ref(e - o, o), rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got.numpy(), ref(e - o, o))


def test_requested_multi_process_start_raises():
    """A launch that asks for several processes (torchrun's ``WORLD_SIZE``)
    and cannot start raises, where a process started alone gets a world of
    one: here the coordinator's address is missing."""
    code = ("import os, sys\n"
            "import torch.distributed as dist\n"
            "from stereo_match_traditional_tpu_torch.parallel import distributed\n"
            "try:\n"
            "    distributed.initialize(backend='gloo')\n"
            "except KeyError as e:\n"
            "    print('raised', e, dist.is_initialized())\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=REPO, WORLD_SIZE="2", RANK="0")
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.stdout.strip() == "raised 'MASTER_ADDR' False", (proc.stdout, proc.stderr)
