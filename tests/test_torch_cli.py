"""The port's command line (mirrors tests/test_cli_utils.py), run with
``--cpu``: ``run`` with its summary, stages and PFM, real files, ``--set``,
the streamed executor, the executors and ``bench`` it has not, the card it needs without
``--cpu``, ``eval`` and ``info``; and ``StageTimer`` / ``profile``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from stereo_match_traditional_tpu_torch import cli
from stereo_match_traditional_tpu_torch.models import get_pipeline
from stereo_match_traditional_tpu_torch.models.registry import finish_from_volumes
from stereo_match_traditional_tpu_torch.utils import checkpoint
from stereo_match_traditional_tpu_torch.utils import io
from stereo_match_traditional_tpu_torch.utils.convert import pair_to_torch
from stereo_match_traditional_tpu_torch.utils.profiling import StageTimer, annotate, profile
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_run_synthetic(tmp_path, capsys):
    """Summary, stage directory and PFM; the PFM is the in-process map bit
    for bit, and the stages re-enter to it."""
    out, pfm, stages = tmp_path / "disp.png", tmp_path / "disp.pfm", tmp_path / "stages"
    rc = cli.main(["--cpu", "run", "sad", "--synthetic", "48x64", "--disp-range", "10",
                   "--out", str(out), "--out-pfm", str(pfm), "--save-stages", str(stages)])
    assert rc == 0
    summary = _summary(capsys)
    assert summary["shape"] == [48, 64] and summary["device"] == "cpu"
    assert summary["bad_2.0"] < 0.3
    assert set(summary["stages_ms"]) == {"pipeline"}
    assert out.exists() and io.imread(str(out)).shape == (48, 64)
    assert sorted(os.listdir(stages)) == ["cost_left.npy", "disp_left.npy", "manifest.json"]
    manifest = json.loads((stages / "manifest.json").read_text())
    assert manifest == {"fields": {"disp_left": "disp_left.npy"}, "meta": {"pipeline": "sad"}}
    L, R, _ = make_pair(48, 64, 10, seed=0)
    fn, cfg_cls = get_pipeline("sad")
    want = fn(*pair_to_torch(L, R, "cpu"), cfg_cls(max_disparity=10)).disp_left.numpy()
    np.testing.assert_array_equal(io.read_pfm(str(pfm)), want)
    back = finish_from_volumes("sad", torch.from_numpy(checkpoint.load_array(str(stages),
                                                                             "cost_left")),
                               None, cfg_cls(max_disparity=10))
    np.testing.assert_array_equal(back.disp_left.numpy(), want)


def test_cli_run_canonical_stages_reenter(tmp_path, capsys):
    """``--set`` reaches the canonical family with its post chain; the saved
    stages, the left arms included, re-enter to the PFM."""
    stages, pfm = tmp_path / "stages", tmp_path / "d.pfm"
    rc = cli.main(["--cpu", "run", "ad_census", "--synthetic", "24x32", "--disp-range", "8",
                   "--set", "aggregation=cross_two_pass", "--set", "run_post=true",
                   "--save-stages", str(stages), "--out-pfm", str(pfm)])
    assert rc == 0
    _summary(capsys)
    names = {n[:-4] for n in os.listdir(stages) if n.endswith(".npy")}
    assert {"arms_left_left", "arms_left_up", "aggregated_left", "disp_final"} <= names
    _, cfg_cls = get_pipeline("ad_census")
    cfg = cfg_cls(disp_range=8, aggregation="cross_two_pass", run_post=True)
    load = lambda k: torch.from_numpy(checkpoint.load_array(str(stages), k))  # noqa: E731
    res = finish_from_volumes("ad_census", load("aggregated_left"), load("aggregated_right"),
                              cfg, {k: load(f"arms_left_{k}") for k in
                                    ("left", "right", "up", "down")})
    np.testing.assert_array_equal(res.disp_final.numpy(), io.read_pfm(str(pfm)))


def test_cli_run_real_image_files(tmp_path, capsys):
    """File round trip: PNGs in (imageio), normalized-u8 disparity PNG out,
    ground truth from a PFM."""
    L, R, gt = make_pair(48, 64, 10, seed=3)
    lp, rp, out, gp = (tmp_path / n for n in ("l.png", "r.png", "d.png", "gt.pfm"))
    io.imwrite(str(lp), np.stack([L] * 3, axis=-1))      # colour in, gray-converted
    io.imwrite(str(rp), R)
    io.write_pfm(str(gp), gt)
    rc = cli.main(["--cpu", "run", "sad", "--left", str(lp), "--right", str(rp),
                   "--disp-range", "10", "--out", str(out), "--gt", str(gp)])
    assert rc == 0
    disp = io.imread(str(out))
    assert disp.shape[:2] == (48, 64) and disp.dtype == np.uint8
    summary = _summary(capsys)
    assert summary["shape"] == [48, 64] and summary["bad_2.0"] < 0.3


def test_cli_asw_scores_the_raw_map(capsys):
    rc = cli.main(["--cpu", "run", "asw", "--synthetic", "24x32", "--disp-range", "6",
                   "--set", "win_size=2"])
    assert rc == 0
    summary = _summary(capsys)
    assert summary["bad_2.0_map"].startswith("disp_left")


def test_cli_set_overrides(capsys):
    rc = cli.main(["--cpu", "run", "sad", "--synthetic", "32x48", "--disp-range", "8",
                   "--set", "winsize=1", "--set", "subpixel=true"])
    assert rc == 0
    assert _summary(capsys)["shape"] == [32, 48]


@pytest.mark.parametrize("argv,match", [
    (["--set", "bogus=1"], "unknown config field"),
    (["--set", "winsize"], "field=value"),
    (["--set", "run_post=maybe"], "expected a bool"),
], ids=["unknown", "no_equals", "bool"])
def test_cli_set_errors(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(["--cpu", "run", "sad", "--synthetic", "16x32", *argv])


def test_cli_nested_field_cannot_be_set():
    with pytest.raises(SystemExit, match="cannot be parsed"):
        cli.main(["--cpu", "run", "ad_census", "--synthetic", "16x32", "--set", "arms=1"])


@pytest.mark.parametrize("executor,match", [
    ("gspmd", "no torch counterpart"),
])
def test_cli_non_direct_executors_exit_naming_their_item(executor, match):
    with pytest.raises(SystemExit, match=match) as e:
        cli.main(["--cpu", "run", "sad", "--synthetic", "16x32", "--executor", executor])
    assert e.value.code not in (0, None)


@pytest.mark.parametrize("pipeline", ["ad_census", "sad"])
def test_cli_run_streamed(pipeline, tmp_path, capsys):
    """``--executor streamed --row-tile 16`` runs the pipeline over row bands
    (a partial last band at 53 rows) and writes the streamed executor's
    map, which equals the direct run's here."""
    base = ["--cpu", "run", pipeline, "--synthetic", "53x64", "--disp-range", "10"]
    for executor, out in (("streamed", "s.pfm"), ("direct", "d.pfm")):
        extra = ["--row-tile", "16"] if executor == "streamed" else []
        assert cli.main(base + ["--executor", executor, *extra,
                                "--out-pfm", str(tmp_path / out)]) == 0
        summary = _summary(capsys)
        assert summary["shape"] == [53, 64] and summary["device"] == "cpu"
    np.testing.assert_array_equal(io.read_pfm(str(tmp_path / "s.pfm")),
                                  io.read_pfm(str(tmp_path / "d.pfm")))


@pytest.mark.parametrize("pipeline", ["ad_census", "sad"])
def test_cli_run_tiled(pipeline, tmp_path, capsys):
    """``--executor tiled`` in a process started alone runs the pipeline on
    a world of one (``parallel.run_tiled``; a gloo group under ``--cpu``) and
    writes the direct run's map; tests/test_torch_tiled.py runs it under
    torchrun."""
    base = ["--cpu", "run", pipeline, "--synthetic", "37x48", "--disp-range", "8",
            "--set", "run_post=true"]
    for executor, out in (("tiled", "t.pfm"), ("direct", "d.pfm")):
        assert cli.main(base + ["--executor", executor, "--out-pfm", str(tmp_path / out)]) == 0
        summary = _summary(capsys)
        assert summary["shape"] == [37, 48] and summary["device"] == "cpu"
        assert summary.get("world") == (1 if executor == "tiled" else None)
    np.testing.assert_array_equal(io.read_pfm(str(tmp_path / "t.pfm")),
                                  io.read_pfm(str(tmp_path / "d.pfm")))


def test_cli_tiled_refuses_save_stages(tmp_path):
    with pytest.raises(SystemExit, match="requires --executor direct"):
        cli.main(["--cpu", "run", "sad", "--synthetic", "16x32", "--executor", "tiled",
                  "--save-stages", str(tmp_path)])


def test_cli_streamed_refuses_save_stages(tmp_path):
    with pytest.raises(SystemExit, match="requires --executor direct"):
        cli.main(["--cpu", "run", "sad", "--synthetic", "16x32", "--executor", "streamed",
                  "--save-stages", str(tmp_path)])


def test_cli_bench_exits_naming_item_8a():
    with pytest.raises(SystemExit, match="Queue 1 item 8a") as e:
        cli.main(["bench", "--pipeline", "sad"])
    assert e.value.code not in (0, None)


def test_cli_asw_lab_reaches_item_7(tmp_path, capsys):
    """``run asw --set variant=lab`` exits 0 and its map is the in-process
    pipeline's on the same Lab pair (the colour pair of the seed, converted
    by ``rgb_to_lab_u8``), bit for bit."""
    pfm = tmp_path / "lab.pfm"
    rc = cli.main(["--cpu", "run", "asw", "--synthetic", "24x32", "--disp-range", "6",
                   "--set", "variant=lab", "--out-pfm", str(pfm)])
    assert rc == 0
    assert _summary(capsys)["shape"] == [24, 32]
    L, R, _ = make_pair(24, 32, 6, seed=0)
    lc, rc_, _ = make_pair(24, 32, 6, seed=0, color=True)
    fn, cfg_cls = get_pipeline("asw")
    res = fn(*pair_to_torch(L, R, "cpu"), cfg_cls(disp_range=6, variant="lab"),
             left_lab=torch.from_numpy(io.rgb_to_lab_u8(lc)),
             right_lab=torch.from_numpy(io.rgb_to_lab_u8(rc_)))
    np.testing.assert_array_equal(io.read_pfm(str(pfm)), res.disp_final.numpy())


@pytest.mark.parametrize("cmd", ["run", "eval"])
def test_cli_needs_a_card_without_cpu(cmd, tmp_path):
    """Without ``--cpu`` and without a card, run and eval exit non-zero
    with a clear message instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    argv = (["run", "sad", "--synthetic", "16x32"] if cmd == "run"
            else ["eval", "sad", "--data", str(tmp_path)])
    with pytest.raises(SystemExit, match="no CUDA device") as e:
        cli.main(argv)
    assert e.value.code not in (0, None)


def test_cli_as_a_module_exits_non_zero_without_a_card():
    """``python -m stereo_match_traditional_tpu_torch.cli run`` in a child
    process: non-zero and the message on stderr where there is no card, 0
    with ``--cpu``; neither imports jax."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.argv = ['stereo-torch'] + sys.argv[1:]\n"
            "runpy.run_module('stereo_match_traditional_tpu_torch.cli', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    args = ["run", "sad", "--synthetic", "16x24", "--disp-range", "4"]
    cpu = subprocess.run([sys.executable, "-c", code, "--cpu", *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert cpu.returncode == 0, cpu.stderr
    assert json.loads(cpu.stdout.strip().splitlines()[-1])["shape"] == [16, 24]
    if not torch.cuda.is_available():
        card = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=120)
        assert card.returncode != 0 and "no CUDA device" in card.stderr
        assert card.stdout == ""


def test_cli_eval_dataset_dir(tmp_path, capsys):
    """Two Middlebury-2003-style scenes (GT PNG = disparity * 4, 0 unknown)."""
    for k, name in enumerate(("cones", "teddy")):
        L, R, gt = make_pair(32, 48, 8, seed=k)
        d = tmp_path / name
        d.mkdir()
        io.imwrite(str(d / "im2.png"), L)
        io.imwrite(str(d / "im6.png"), R)
        io.imwrite(str(d / "disp2.png"), np.clip(np.round(gt * 4), 0, 255).astype(np.uint8))
    rc = cli.main(["--cpu", "eval", "sad", "--data", str(tmp_path), "--disp-range", "8",
                   "--gt-scale", "4"])
    assert rc == 0
    out = _summary(capsys)
    assert [r["scene"] for r in out["scenes"]] == ["cones", "teddy"]
    assert 0 <= out["mean_bad_2.0"] < 0.4
    with pytest.raises(SystemExit, match="no scene"):
        cli.main(["--cpu", "eval", "sad", "--data", str(tmp_path), "--left-name", "none.png"])


def test_cli_info(capsys):
    assert cli.main(["--cpu", "info"]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["pipelines"] == ["ad_census", "asw", "cblsm", "ncc", "sad"]
    assert info["backend"] == "cpu" and info["devices"] == ["cpu"]
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out)
    if torch.cuda.is_available():
        assert info["devices"][0] == torch.cuda.get_device_name(0)
    else:
        assert info["backend"] == "cpu"


def test_stage_timer_reports_json():
    t = StageTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    rep = json.loads(t.report())
    assert set(rep["stages_ms"]) == {"a", "b"}


def test_profile_writes_a_trace_with_the_stage_ranges(tmp_path):
    """``profile(dir)`` writes a Chrome trace holding the pipeline's own
    ``stereo/<stage>`` ranges and the ``annotate`` / ``StageTimer`` ones;
    ``profile(None)`` traces nothing."""
    L, R, _ = make_pair(16, 20, 4, seed=0)
    fn, cfg_cls = get_pipeline("sad")

    @annotate("outer")
    def call():
        return fn(*pair_to_torch(L, R, "cpu"), cfg_cls(max_disparity=4))

    assert call.__name__ == "call"
    timer = StageTimer()
    with profile(str(tmp_path / "trace")), timer.stage("pipeline"):
        call()
    names = {e.get("name") for e in json.load(open(tmp_path / "trace" / "trace.json"))
             ["traceEvents"]}
    assert {"outer", "pipeline", "stereo/cost_volume", "stereo/wta"} <= names
    with profile(None):
        call()
