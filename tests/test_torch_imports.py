"""The port imports neither jax nor the JAX package: every module imports
with both blocked, and no source file of the port names either in an
import."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "stereo_match_traditional_tpu_torch"
BLOCKED = ("jax", "stereo_match_traditional_tpu")    # the name or a dotted prefix


def _blocked(name):
    """``stereo_match_traditional_tpu_torch`` shares only the letters."""
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def _port_modules():
    pkg_dir = os.path.join(REPO, PKG)
    names = [PKG]
    for info in pkgutil.walk_packages([pkg_dir], prefix=PKG + "."):
        names.append(info.name)
    return names


def test_port_modules_are_found():
    mods = _port_modules()
    for expected in ("ops.kernels.asw_cuda", "ops.kernels.build", "models.asw",
                     "ops.post", "utils.convert", "ops.aggregate", "ops.scanline",
                     "ops.kernels.ad_census_cuda", "ops.kernels.scanline_cuda",
                     "models.ad_census", "ops.kernels.window_cost_cuda", "models.sad",
                     "models.ncc", "models.cblsm", "config", "utils.synthetic"):
        assert f"{PKG}.{expected}" in mods


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"blocked = {BLOCKED!r}\n"
        "for b in blocked:\n"
        "    sys.modules[b] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == b or m.startswith(b + '.') for b in blocked"
        " for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _sources():
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import_in_source(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert not _blocked(n), (path, n)
