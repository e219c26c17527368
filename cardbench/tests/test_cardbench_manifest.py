"""BENCHMARK.json against the benchmark's contract, and every piece it
names found by name."""

import json
import math

import pytest

from cardbench import check, manifest, work

BENCH = manifest.load()
LINE = 200


def test_manifest_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w.split("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_entries_have_only_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for kind in ("end_to_end", "per_layer") for m in BENCH[kind])
    yield from (k for c in BENCH["configs"] for k in c["reduced"])


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_only_the_allowed_characters(name):
    assert manifest.NAME.fullmatch(name)


def test_units_texts_and_uniqueness():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert manifest.UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    texts = [c["why"] for c in BENCH["configs"]] + [c["source"] for c in BENCH["configs"]]
    texts += [w["why"] for w in BENCH["workloads"]] + [m["layer"] for m in BENCH["per_layer"]]
    texts += BENCH["command"]
    for t in texts:
        assert 1 <= len(t) <= LINE and "\n" not in t and "\t" not in t
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] == 0.25


def test_run_seconds_fits_the_check_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_piece_of_a_cell_is_found_by_name(cell):
    conf = manifest.config(cell["config"])
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"cardbench/configs/{cell['config']}.json"
    assert conf["name"] == cell["config"] and conf["reduced"] == entry["reduced"]
    assert conf["source"] == entry["source"]
    assert callable(check.reference_module(conf["reference"]).disparity)
    traf = manifest.traffic(cell["traffic"])
    assert traf["batch"] >= 1 and traf["trace_pairs"] % traf["batch"] == 0
    assert 0 <= manifest.limits(cell["name"])["pixels_off"]["limit"] < 1
    e2e = {m["name"] for m in manifest.metrics_of(BENCH, "end_to_end", cell["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics_of(BENCH, "per_layer", cell["name"])
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_every_config_is_used_and_its_work_evaluates():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for name in sorted(p.stem for p in (manifest.HERE / "configs").glob("*.json")):
        w = work.stage_work(manifest.config(name)["work"], {"H": 375, "W": 1242, "D": 128})
        assert all(v["bytes"] > 0 and v["ops"] > 0 and math.isfinite(v["bytes"])
                   for v in w.values())


def test_one_layer_one_name():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_an_unknown_name_is_not_found():
    with pytest.raises(FileNotFoundError):
        manifest.traffic("no_such_mix")
    with pytest.raises(ValueError):
        manifest.config("../BENCHMARK")
    with pytest.raises(KeyError):
        manifest.workload(BENCH, "no.such.cell")
