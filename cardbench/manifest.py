"""Find the benchmark's pieces by the names ``BENCHMARK.json`` gives them.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a file of its own: ``configs/<config>.json`` and
``traffic/<traffic>.json``.  A metric is a reader of its own,
``metrics/<name>.py``; the limits of a cell's correctness check are
``limits/<workload>.json``.  Adding a cell, a mix or a metric adds files and
entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load(path: Path = BENCHMARK) -> dict:
    """``BENCHMARK.json`` as a dict."""
    return json.loads(Path(path).read_text())


def _read(kind: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"not a name: {name!r}")
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def workload(bench: dict, name: str) -> dict:
    """The cell called ``name``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json has no workload {name!r}")


def config(name: str) -> dict:
    """``configs/<name>.json``."""
    return _read("configs", name)


def traffic(name: str) -> dict:
    """``traffic/<name>.json``."""
    return _read("traffic", name)


def limits(workload_name: str) -> dict:
    """``limits/<workload>.json``: each compared number's limit."""
    return _read("limits", workload_name)


def metrics_of(bench: dict, kind: str, workload_name: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that the cell reports: those
    that list it under ``workloads`` and those that list no cells."""
    return [m for m in bench[kind] if workload_name in m.get("workloads", [workload_name])]


def reader(metric: str) -> Callable[[dict], object]:
    """The ``read(summary)`` function of ``metrics/<metric>.py``."""
    if not NAME.fullmatch(metric):
        raise ValueError(f"not a name: {metric!r}")
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"cardbench_metric_{metric}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {metric!r}: {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(bench: dict, kind: str, workload_name: str, summary: dict) -> Dict[str, dict]:
    """``{metric: {"value", "unit"}}`` of every ``end_to_end`` or
    ``per_layer`` metric of the cell whose reader finds something to read
    in ``summary``; a reader that finds nothing returns None."""
    out = {}
    for m in metrics_of(bench, kind, workload_name):
        value = reader(m["name"])(summary)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
