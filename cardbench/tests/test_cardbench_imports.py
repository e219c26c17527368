"""No module under cardbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the measured package.  Top-level names are
compared whole: the measured package's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "stereo_match_traditional_tpu"}
PORT = "stereo_match_traditional_tpu_torch"
SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def test_the_walk_sees_the_harness():
    rel = {str(p.relative_to(HERE)) for p in SOURCES}
    assert {"run.py", "reference/ad_census.py", "metrics/pairs_per_s.py"} <= rel


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert PORT not in top_level_imports(path)


def test_whole_names_are_compared(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import stereo_match_traditional_tpu_torch.models\nimport jaxtyping\n")
    assert top_level_imports(p) == {PORT, "jaxtyping"}
    assert not top_level_imports(p) & FORBIDDEN


def test_the_reference_loads_no_port_module():
    watched = sorted(FORBIDDEN | {PORT})
    code = ("import sys, cardbench.reference.ad_census, cardbench.check; "
            f"print(sorted({{m.split('.')[0] for m in sys.modules}} & set({watched!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
