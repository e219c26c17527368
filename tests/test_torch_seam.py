"""The port's one device-dispatch seam: the public functions of ``ops``
decide, once, between a kernel's launcher and their plain body; the
launchers in ``ops/kernels`` take CUDA tensors only and call nothing above
them; ``models`` and ``parallel`` call the public functions only.

These tests read the sources and call the launchers on CPU tensors: they
need no card and no jax."""

import ast
import inspect
import os
import types
from pathlib import Path

import pytest
import torch

from stereo_match_traditional_tpu_torch.config import CrossArmConfig, ScanlineConfig
from stereo_match_traditional_tpu_torch.ops import aggregate, on_cuda, post, scanline, volume
from stereo_match_traditional_tpu_torch.ops.kernels import (
    ad_census_cuda,
    aggregate_cuda,
    asw_cuda,
    post_cuda,
    scanline_banded_cuda,
    scanline_canonical_cuda,
    scanline_cuda,
    window_cost_cuda,
)

PKG = Path(volume.__file__).resolve().parents[1]
KERNELS = "stereo_match_traditional_tpu_torch.ops.kernels"

# The public functions that have a kernel, by module, each with its launcher
DISPATCHING = {
    volume: {"ad_volume": "ad_volume_cuda", "census_volume": "census_volume_cuda",
             "ad_census_volume": "ad_census_volume_cuda",
             "ad_census_volumes": "ad_census_volumes_cuda", "ad_volumes": "ad_volumes_cuda",
             "sad_volume": "sad_volume_cuda", "ncc_sums": "ncc_sums_cuda",
             "ncc_volume": "ncc_volume_cuda", "asw_volume": "asw_volume_left_cuda"},
    scanline: {"scanline_optimize": "scanline_optimize_cuda",
               "scanline_optimize_canonical": "scanline_optimize_canonical_cuda",
               "directional_pass_banded": "directional_pass_banded_cuda",
               "canonical_pass_banded": "canonical_pass_banded_cuda",
               "horizontal_passes_banded": "horizontal_passes_banded_cuda",
               "canonical_horizontal_passes_banded": "canonical_horizontal_passes_banded_cuda"},
    aggregate: {"cross_arms": "cross_arms_cuda", "rect_mean_aggregate": "rect_mean_cuda",
                "cross_aggregate": "cross_aggregate_cuda"},
    post: {"remove_speckles": "remove_speckles_cuda", "fill_holes_8dir": "fill_holes_8dir_cuda",
           "iterative_region_voting": "region_voting_cuda",
           "_fill_from_candidates": "fill_from_candidates_cuda"},
}
DISPATCHING_NAMES = {name for names in DISPATCHING.values() for name in names}


def _files(*parts):
    return sorted(p for p in PKG.joinpath(*parts).glob("*.py"))


def _rel(path):
    return os.path.relpath(path, PKG.parent)


def _tree(path):
    return ast.parse(path.read_text(), str(path))


@pytest.mark.parametrize("path", _files("models") + _files("parallel"), ids=_rel)
def test_models_and_executors_import_no_kernels(path):
    """``models/*`` and ``parallel/*`` reach the kernels only through the
    public ``ops`` functions: no import of ``ops.kernels`` or of a module
    under it."""
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            names = [module] + [f"{module}.{a.name}" for a in node.names]
        else:
            continue
        for name in names:
            assert not (name == KERNELS or name.startswith(KERNELS + ".")), (_rel(path), name)


@pytest.mark.parametrize("path", _files("ops", "kernels"), ids=_rel)
def test_launchers_call_nothing_above_them(path):
    """No launcher module names a plain body (``_<name>_plain``), a public
    function that dispatches, or a tensor's ``is_cuda``: it takes CUDA
    tensors only and has no CPU branch."""
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        elif isinstance(node, ast.alias):
            name = node.asname or node.name
        else:
            continue
        assert not (name.startswith("_") and name.endswith("_plain")), (_rel(path), name)
        assert name not in DISPATCHING_NAMES, (_rel(path), name)
        assert name != "is_cuda", (_rel(path), name)


@pytest.mark.parametrize("module,name", [(m, n) for m, names in DISPATCHING.items()
                                         for n in names],
                         ids=lambda x: x if isinstance(x, str) else x.__name__.split(".")[-1])
def test_each_public_function_branches_once(module, name):
    """Each public function with a kernel tests the device once
    (``ops.on_cuda``), calls its launcher and its own plain body, and
    nothing else of the kernels layer."""
    fn = getattr(module, name)
    tree = ast.parse(inspect.getsource(fn).lstrip())
    calls = [n.func for n in ast.walk(tree) if isinstance(n, ast.Call)]
    called = [c.id if isinstance(c, ast.Name) else c.attr for c in calls
              if isinstance(c, (ast.Name, ast.Attribute))]
    assert called.count("on_cuda") == 1, (name, called)
    assert DISPATCHING[module][name] in called, (name, called)
    plain = [c for c in called if c.startswith("_") and c.endswith("_plain")]
    assert plain == [f"_{name.lstrip('_')}_plain"], (name, plain)
    assert not any(n.id == "is_cuda" for n in ast.walk(tree) if isinstance(n, ast.Name))


def _u8(*shape):
    return torch.zeros(shape, dtype=torch.uint8)


def _f32(*shape):
    return torch.zeros(shape, dtype=torch.float32)


def _arms():
    return aggregate.Arms(*(torch.ones((6, 7), dtype=torch.int32) for _ in range(4)))


def _zero_carry(d, m):
    return _f32(d, m), _f32(m)


# Every launcher, with CPU arguments it would otherwise take, and the
# module whose ``LAUNCHES`` it counts in
LAUNCHERS = {
    "ad_census_volume_cuda": (lambda: ad_census_cuda.ad_census_volume_cuda(
        _u8(6, 7), _u8(6, 7), 4), ad_census_cuda),
    "ad_census_volumes_cuda": (lambda: ad_census_cuda.ad_census_volumes_cuda(
        _u8(6, 7), _u8(6, 7), 4), ad_census_cuda),
    "ad_volume_cuda": (lambda: ad_census_cuda.ad_volume_cuda(_u8(6, 7), _u8(6, 7), 4),
                       ad_census_cuda),
    "ad_volumes_cuda": (lambda: ad_census_cuda.ad_volumes_cuda(_u8(6, 7), _u8(6, 7), 4),
                        ad_census_cuda),
    "census_volume_cuda": (lambda: ad_census_cuda.census_volume_cuda(_u8(6, 7), _u8(6, 7), 4),
                           ad_census_cuda),
    "sad_volume_cuda": (lambda: window_cost_cuda.sad_volume_cuda(_u8(6, 7), _u8(6, 7), 4, 1),
                        window_cost_cuda),
    "ncc_sums_cuda": (lambda: window_cost_cuda.ncc_sums_cuda(_u8(6, 7), _u8(6, 7), 2),
                      window_cost_cuda),
    "ncc_volume_cuda": (lambda: window_cost_cuda.ncc_volume_cuda(
        _u8(6, 7), _u8(6, 7), 4, 2, -2.0), window_cost_cuda),
    "asw_volume_left_cuda": (lambda: asw_cuda.asw_volume_left_cuda(
        _f32(6, 7), _f32(6, 7), 4, 2, 50.0, 30.0, 40.0), asw_cuda),
    "scanline_optimize_cuda": (lambda: scanline_cuda.scanline_optimize_cuda(
        _f32(4, 6, 7), _u8(6, 7), ScanlineConfig()), scanline_cuda),
    "scanline_optimize_canonical_cuda": (
        lambda: scanline_canonical_cuda.scanline_optimize_canonical_cuda(
            _f32(4, 6, 7), _u8(6, 7), _u8(6, 7)), scanline_canonical_cuda),
    "directional_pass_banded_cuda": (
        lambda: scanline_banded_cuda.directional_pass_banded_cuda(
            _f32(6, 4, 7), _f32(6, 7), _zero_carry(4, 7), None, 0.5), scanline_banded_cuda),
    "canonical_pass_banded_cuda": (
        lambda: scanline_banded_cuda.canonical_pass_banded_cuda(
            _f32(6, 4, 7), _f32(6, 4, 7), _zero_carry(4, 7), None, 1.0, 3.0),
        scanline_banded_cuda),
    "horizontal_passes_banded_cuda": (
        lambda: scanline_banded_cuda.horizontal_passes_banded_cuda(
            _f32(4, 6, 7), _f32(6, 7), 0.5, 4.0), scanline_banded_cuda),
    "canonical_horizontal_passes_banded_cuda": (
        lambda: scanline_banded_cuda.canonical_horizontal_passes_banded_cuda(
            _f32(4, 6, 7), _u8(6, 7), _u8(6, 7), 1.0, 3.0, 15.0, False), scanline_banded_cuda),
    "scanline_optimize_composed": (lambda: scanline_banded_cuda.scanline_optimize_composed(
        _f32(300, 6, 7), _u8(6, 7), 0.5, 4.0, True, False), scanline_banded_cuda),
    "scanline_canonical_composed": (lambda: scanline_banded_cuda.scanline_canonical_composed(
        _f32(300, 6, 7), _u8(6, 7), _u8(6, 7), 1.0, 3.0, 15.0, "left"), scanline_banded_cuda),
    "cross_arms_cuda": (lambda: aggregate_cuda.cross_arms_cuda(_u8(6, 7), CrossArmConfig()),
                        aggregate_cuda),
    "rect_mean_cuda": (lambda: aggregate_cuda.rect_mean_cuda(_f32(4, 6, 7), _arms(), True, 34),
                       aggregate_cuda),
    "cross_aggregate_cuda": (lambda: aggregate_cuda.cross_aggregate_cuda(
        _f32(4, 6, 7), _arms(), 4, True, 34), aggregate_cuda),
    "fill_from_candidates_cuda": (lambda: post_cuda.fill_from_candidates_cuda(
        _f32(6, 7), torch.ones((6, 7), dtype=torch.bool), True, None, None), post_cuda),
    "fill_holes_8dir_cuda": (lambda: post_cuda.fill_holes_8dir_cuda(
        _f32(6, 7), torch.ones((6, 7), dtype=torch.bool), torch.zeros((6, 7), dtype=torch.bool)),
        post_cuda),
    "remove_speckles_cuda": (lambda: post_cuda.remove_speckles_cuda(_f32(6, 7)), post_cuda),
    "region_voting_cuda": (lambda: post_cuda.region_voting_cuda(_f32(6, 7), _arms(), 4),
                           post_cuda),
}


def _counts(module):
    launches = module.LAUNCHES
    return dict(launches) if isinstance(launches, dict) else launches


def test_every_launcher_is_listed():
    """:data:`LAUNCHERS` covers every public function of the launcher
    modules that launches (each the counterpart of a public op, or a
    route of one)."""
    modules = (ad_census_cuda, window_cost_cuda, asw_cuda, scanline_cuda, scanline_canonical_cuda,
               scanline_banded_cuda, aggregate_cuda, post_cuda)
    found = {name for m in modules for name, fn in vars(m).items()
             if inspect.isfunction(fn) and fn.__module__ == m.__name__
             and (name.endswith("_cuda") or name.endswith("_composed"))}
    assert found == set(LAUNCHERS)


@pytest.mark.parametrize("name", sorted(LAUNCHERS))
def test_launcher_rejects_cpu_tensors(name):
    """A launcher given CPU tensors raises ``ValueError`` before it reaches
    the library and leaves its ``LAUNCHES`` counter as it was."""
    call, module = LAUNCHERS[name]
    before = _counts(module)
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert _counts(module) == before


def test_the_seam_rejects_split_devices():
    """``ops.on_cuda`` is True for CUDA tensors, False for CPU ones, and
    raises ``ValueError`` for a mix (an object with ``is_cuda`` stands for
    a CUDA tensor here)."""
    cuda = types.SimpleNamespace(is_cuda=True, device="cuda:0")
    assert on_cuda(cuda, cuda) and not on_cuda(_u8(6, 7), _f32(6, 7))
    with pytest.raises(ValueError, match="all on CUDA devices or all on the CPU"):
        on_cuda(_u8(6, 7), cuda)
