"""The command's refusals, and a whole run on the CPU at a small size, as
it is and with the timed path broken underneath: ``correct`` has to come
out false for each fault a cell can have."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench import manifest, run
from stereo_match_traditional_tpu_torch.models import batch as batch_mod

ROOT = Path(__file__).resolve().parents[2]
BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = dict(height=24, width=40, disp_range=8, feature_scale=4, sample_maps=3,
             warmup_seconds=0)


def small_traffic(cell, batch=None):
    """The cell's mix at 24 x 40, D=8 (and ``batch``); a batch holds distinct pairs."""
    traf = manifest.traffic(manifest.workload(BENCH, cell)["traffic"])
    b = batch or traf["batch"]
    return dict(traf, **SMALL, batch=b, trace_pairs=b, distinct_pairs=max(4, 2 * b))


def cpu_run(cell, batch=None, seed=2**33 + 5):
    return run.run_cell(cell, seed, 0.3, False, "cpu", traffic=small_traffic(cell, batch))


def test_the_command_without_a_card_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cmd = [sys.executable, "cardbench/run.py", "--workload", CELLS[0], "--seed", "3000000001",
           "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_measured_package_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setitem(sys.modules, "stereo_match_traditional_tpu_torch", None)
    args = ["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"]
    assert run.main(args) == run.EXIT_NO_PACKAGE
    assert capsys.readouterr().out == ""


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "stereo_match_traditional_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "stereo_match_traditional_tpu.ops", object())
    assert run.forbidden_modules() == ["jax", "stereo_match_traditional_tpu"]


@pytest.mark.parametrize("batch", [None, 4])
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_on_the_cpu_is_correct(cell, batch):
    out = cpu_run(cell, batch)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert out["compared"]["pixels_off"]["value"] == 0.0
    assert list(out)[-1] == "compared"
    names = {m["name"] for m in manifest.metrics_of(BENCH, "end_to_end", cell)}
    assert set(out["metrics"]) == names
    assert all(v["value"] > 0 for v in out["metrics"].values())


def _altered(get_pipeline):
    """A pipeline whose final maps have a 4 x 4 block changed where they are made."""

    def patched(name):
        fn, cls = get_pipeline(name)

        def wrong(left, right, cfg):
            res = fn(left, right, cfg)
            disp = res.disp_final.clone()
            disp[:4, :4] += 1.0
            return res._replace(disp_final=disp)

        return wrong, cls

    return patched


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_made_is_not_correct(cell, monkeypatch):
    monkeypatch.setattr(batch_mod, "get_pipeline", _altered(batch_mod.get_pipeline))
    out = cpu_run(cell)
    assert not out["correct"] and out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_the_batch_left_out_is_not_correct(cell, monkeypatch):
    """The cells serve batches of one, where the fault cannot occur; the check
    is held to it in batches of 4 of each cell's mix."""
    real = batch_mod.batched_pipeline

    def half(name, cfg=None, method="map", mesh=None, axis_name="batch"):
        run_all = real(name, cfg, method, mesh, axis_name)

        def run_half(ls, rs):
            n = (ls.shape[0] + 1) // 2
            res = run_all(ls[:n], rs[:n])
            idx = torch.arange(ls.shape[0]) % n
            return type(res)(*(None if f is None else f[idx] for f in res))

        return run_half

    monkeypatch.setattr(batch_mod, "batched_pipeline", half)
    out = cpu_run(cell, batch=4)
    assert not out["correct"] and out["failed"] >= 1


def test_pixels_off():
    from cardbench import check

    assert check.pixels_off(np.zeros((4, 5)), np.zeros((4, 5))) == 0.0
    assert check.pixels_off(np.zeros((4, 5)), np.eye(4, 5)) == pytest.approx(4 / 20)
    assert check.pixels_off(np.zeros((4, 5)), np.zeros((5, 4))) == 1.0
    inf = np.full((2, 2), np.inf)
    assert check.pixels_off(inf, inf) == 0.0
