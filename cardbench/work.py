"""Each timed stage's least work at a cell's shapes, and its roofline bound.

A configuration file states, under ``work``, each stage's bytes and
operations as a list of ``[expression, reason]`` terms over the pair's
``H``, ``W`` and ``D``: each input of the stage read once and each output
written once, and the operations of the cheapest exact algorithm.  The
bound of a stage is the larger of its bytes over the card's bandwidth and
its operations over its float32 rate (``peaks.json``), so a later program
that replaces a kernel is read against the same yardstick.
"""

from __future__ import annotations

import ast
import json
import operator
from pathlib import Path
from typing import Dict, Mapping, Optional

PEAKS = Path(__file__).resolve().parent / "peaks.json"
_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv}


def evaluate(expr: str, sizes: Mapping[str, int]) -> float:
    """The value of an arithmetic ``expr`` (numbers, ``+ - * / //`` and the
    names in ``sizes``); anything else raises ``ValueError``."""

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return node.value
        if isinstance(node, ast.Name) and node.id in sizes:
            return sizes[node.id]
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](ev(node.left), ev(node.right))
        raise ValueError(f"not an arithmetic expression over {sorted(sizes)}: {expr!r}")

    return float(ev(ast.parse(expr, mode="eval")))


def stage_work(work: Mapping, sizes: Mapping[str, int]) -> Dict[str, Dict[str, float]]:
    """``{stage: {"bytes": b, "ops": o}}`` of one pair, summed over each
    stage's terms."""
    return {stage: {kind: sum(evaluate(expr, sizes) for expr, _why in terms[kind])
                    for kind in ("bytes", "ops")}
            for stage, terms in work.items()}


def peaks(card: str) -> Optional[Dict[str, float]]:
    """The card's published peaks, or None for a card not in the table."""
    return json.loads(PEAKS.read_text())["cards"].get(card)


def stage_bounds(work: Mapping, sizes: Mapping[str, int], card: str) -> Dict[str, float]:
    """``{stage: least seconds a pair}`` on ``card``; empty for a card not in
    the table of peaks."""
    p = peaks(card)
    if p is None:
        return {}
    return {stage: max(w["bytes"] / p["bytes_per_s"], w["ops"] / p["ops_per_s"])
            for stage, w in stage_work(work, sizes).items()}
