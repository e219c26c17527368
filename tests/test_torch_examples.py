"""The port's two examples, ``examples/demo_torch.py`` and
``examples/serving_torch.py``, run as a user runs them: with ``--cpu`` at
32x48, D=8, each in a subprocess started in the test's own temporary
directory.  The demo's five bad-2.0 values equal those of direct calls of
the port, its images are the normalised maps and its checkpoints load back;
the served maps are ``serve_pairs``' over the pairs in memory, alike over
the native and the Python loader, over a mesh of two gloo ranks under
``torch.distributed.run``, and with a configuration passed to ``main``."""

import importlib.util
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch.config import (
    ADCensusConfig, ScanlineConfig, disp_override_kw,
)
from stereo_match_traditional_tpu_torch.models import PIPELINES, get_pipeline
from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
from stereo_match_traditional_tpu_torch.utils import checkpoint, native
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.io import normalize_u8
from stereo_match_traditional_tpu_torch.utils.synthetic import bad_pixel_rate, make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
H, W, D = 32, 48, 8
SIZE = ["--size", f"{H}x{W}", "--disp", str(D)]
PAIRS = 5

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on PATH: the examples stage PGM pairs with the "
                                       "native host library")


@pytest.fixture(scope="module", autouse=True)
def _torch_exp_warmed_up():
    """torch's CPU exp has been seen to be off on the first call of a
    process (see tests/test_torch_ad_census_ops.py)."""
    torch.exp(-torch.rand(8, 9, 10).permute(1, 0, 2))


def _run(args, cwd, timeout=300, module=None):
    """Run an example as a user does: no PYTHONPATH, from ``cwd``, a
    directory of the test's own outside the checkout.  The example runs
    torch on one thread, as ``torch.distributed.run`` runs its workers: the
    first exp of a process whose chunks run on several threads at once has
    been seen to return other values (in about one process of ten), which
    moves a tie of the winner-take-all and is torch's doing, not the
    port's."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, *(module or []), *args]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, (cmd, proc.stdout[-2000:], proc.stderr[-3000:])
    return proc.stdout


@pytest.fixture(scope="module")
def direct():
    """Each pipeline's direct call on the demo's pair, as the demo builds it."""
    left, right, gt = make_pair(H, W, D, seed=0)
    lt, rt = pair_to_torch(left, right, "cpu")
    out = {}
    for name in sorted(PIPELINES):
        fn, cfg_cls = get_pipeline(name)
        disp = fn(lt, rt, cfg_cls(**disp_override_kw(cfg_cls, D))).disp_left.numpy()
        out[name] = (disp, bad_pixel_rate(disp, gt))
    return out


def test_demo_on_the_cpu(tmp_path, direct):
    out_dir = str(tmp_path / "demo")
    stdout = _run([os.path.join(EXAMPLES, "demo_torch.py"), "--cpu", *SIZE, "--out-dir",
                   out_dir], tmp_path)
    with open(os.path.join(out_dir, "summary.json")) as f:
        summary = json.load(f)
    assert summary["device"] == "cpu" and summary["shape"] == [H, W] and summary["disp"] == D
    assert summary["bad_2.0"] == {name: bad for name, (_, bad) in direct.items()}
    table = dict(line.split() for line in stdout.splitlines()[1:-1])
    assert table == {name: f"{bad:.3f}" for name, (_, bad) in direct.items()}
    for name, (disp, _) in direct.items():
        got = native.read_pnm(os.path.join(out_dir, f"disp_{name}.pgm"))
        np.testing.assert_array_equal(got, normalize_u8(disp))
        saved = checkpoint.load_result(os.path.join(out_dir, f"stages_{name}"))
        np.testing.assert_array_equal(saved.disp_left, disp)
    left, right, _ = make_pair(H, W, D, seed=0)
    np.testing.assert_array_equal(native.read_pnm(os.path.join(out_dir, "left.pgm")), left)
    np.testing.assert_array_equal(native.read_pnm(os.path.join(out_dir, "right.pgm")), right)


def test_demo_without_a_card_raises(tmp_path):
    """Without ``--cpu`` the demo needs a card, and says so."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out_dir = tmp_path / "demo"
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, "demo_torch.py"), *SIZE,
                           "--out-dir", str(out_dir)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA device: pass --cpu" in proc.stderr
    assert not out_dir.exists()


def _want_maps(full):
    """The normalised maps of ``serve_pairs`` over the served pairs in
    memory; ``full``: ad_census with its scanline and post chain."""
    pairs = [make_pair(H, W, D, seed=i)[:2] for i in range(PAIRS)]
    cfg = ADCensusConfig(disp_range=D, **(dict(scanline=ScanlineConfig(), run_post=True)
                                          if full else {}))
    return [normalize_u8(m) for m in serve_pairs("ad_census", pairs, cfg, batch_size=2,
                                                 device="cpu")]


def _cli_args(out_dir, loader):
    return ["--cpu", *SIZE, "--pairs", str(PAIRS), "--batch", "2", "--loader", loader,
            "--out-dir", out_dir]


def _served(out_dir):
    return [native.read_pnm(os.path.join(out_dir, f"pair{i:03d}_disp.pgm"))
            for i in range(PAIRS)]


def test_serving_loaders_write_the_same_maps(tmp_path):
    """``--loader native`` and ``--loader python`` write the same maps: the
    normalised maps of ``serve_pairs`` over the pairs in memory."""
    want = _want_maps(False)
    for loader in ("native", "python"):
        out_dir = str(tmp_path / loader)
        stdout = _run([os.path.join(EXAMPLES, "serving_torch.py"), *_cli_args(out_dir, loader)],
                      tmp_path)
        assert f"{PAIRS} pairs via {loader} threaded loader, batch=2:" in stdout
        for got, m in zip(_served(out_dir), want):
            np.testing.assert_array_equal(got, m)


@pytest.mark.parametrize("loader", ["native", "python"])
def test_serving_main_takes_a_configuration(tmp_path, monkeypatch, loader):
    """``main(argv, cfg)`` serves ``cfg`` (ad_census with its scanline and
    post chain), not the reference configuration."""
    monkeypatch.setattr(sys, "path", list(sys.path))     # the example extends it
    spec = importlib.util.spec_from_file_location(
        "serving_torch", os.path.join(EXAMPLES, "serving_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = ADCensusConfig(disp_range=D, scanline=ScanlineConfig(), run_post=True)
    out_dir = str(tmp_path / "full")
    served = example.main(_cli_args(out_dir, loader), cfg=cfg)
    assert served["pairs"] == PAIRS and served["loader"] == loader and not served["mesh"]
    assert served["maps"] == [os.path.join(out_dir, f"pair{i:03d}_disp.pgm")
                              for i in range(PAIRS)]
    want = _want_maps(True)
    assert any(not np.array_equal(a, b) for a, b in zip(want, _want_maps(False)))
    for got, m in zip(_served(out_dir), want):
        np.testing.assert_array_equal(got, m)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_serving_over_a_mesh_of_two_ranks(tmp_path):
    """Under ``torch.distributed.run`` with two gloo ranks and a batch of 2
    the batches are split over a ``batch`` mesh; rank 0 writes the maps of
    the unsharded run."""
    out_dir = str(tmp_path / "mesh")
    stdout = _run(["--nproc-per-node", "2", "--master-addr", "127.0.0.1", "--master-port",
                   str(_free_port()), os.path.join(EXAMPLES, "serving_torch.py"), "--cpu", *SIZE,
                   "--pairs", str(PAIRS), "--batch", "2", "--out-dir", out_dir], tmp_path,
                  module=["-m", "torch.distributed.run"])
    assert f"{PAIRS} pairs via native threaded loader, batch=2, mesh of 2:" in stdout
    for i, m in enumerate(_want_maps(False)):
        np.testing.assert_array_equal(native.read_pnm(os.path.join(out_dir,
                                                                   f"pair{i:03d}_disp.pgm")), m)
