"""The port's binding of the native host library (``utils.native``): the
counterpart of each test of ``tests/test_native.py``; every function bit
for bit against the JAX package's binding on the same seeded inputs (one
source, one set of flags); its codec and ``PairLoader`` against
``utils.loader``'s; the locked build into ``_build/`` from four processes
at once, which writes nothing under ``native/``; the errors raised where
no compiler is found or the build fails; and ``serve_pairs`` over the
native loader."""

import inspect
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from stereo_match_traditional_tpu.utils import native as jnative
from stereo_match_traditional_tpu_torch.config import ADCensusConfig
from stereo_match_traditional_tpu_torch.models.batch import serve_pairs
from stereo_match_traditional_tpu_torch.utils import io as io_utils
from stereo_match_traditional_tpu_torch.utils import loader, native
from stereo_match_traditional_tpu_torch.utils.synthetic import make_pair

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ on PATH: the native host library cannot be built")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "stereo_match_traditional_tpu_torch"

rng = np.random.default_rng(0)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's binding over a library built for this module alone
    with the Makefile's flags (its own build, an unlocked ``make`` in
    ``native/``, can race other test workers; ``tests/test_torch_io.py``
    does the same)."""
    so = tmp_path_factory.mktemp("stereo_host") / "libstereo_host.so"
    subprocess.run(["g++", *native.CXX_FLAGS, "-o", str(so), str(native.SOURCE)],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", str(so))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert jnative.available()
        yield jnative


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# -- the counterparts of tests/test_native.py -----------------------------------

def test_rgb_to_gray_matches_numpy():
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    got = native.rgb_to_gray_u8(img)
    want = io_utils.rgb_to_gray_u8(img)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1  # rounding ties


def test_rgb_to_lab_matches_numpy():
    img = rng.integers(0, 256, (21, 33, 3), dtype=np.uint8)
    got = native.rgb_to_lab_u8(img)
    want = io_utils.rgb_to_lab_u8(img)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_replicate_pad_matches_numpy():
    img = rng.integers(0, 256, (11, 17), dtype=np.uint8)
    np.testing.assert_array_equal(native.replicate_pad_u8(img, 4), io_utils.replicate_pad(img, 4))


def test_normalize_matches_numpy():
    x = rng.standard_normal((19, 23)).astype(np.float32) * 30
    x[2, 3] = np.inf
    got = native.normalize_u8(x)
    want = io_utils.normalize_u8(x)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_median3():
    img = rng.integers(0, 256, (15, 18), dtype=np.uint8)
    got = native.median3_u8(img)
    pad = np.pad(img, 1, mode="edge")               # oracle: replicate-border 3x3 median
    want = np.empty_like(img)
    for i in range(15):
        for j in range(18):
            want[i, j] = np.median(pad[i:i + 3, j:j + 3])
    np.testing.assert_array_equal(got, want)


def test_pnm_roundtrip(tmp_path):
    gray = rng.integers(0, 256, (9, 13), dtype=np.uint8)
    color = rng.integers(0, 256, (7, 5, 3), dtype=np.uint8)
    p1, p2 = str(tmp_path / "g.pgm"), str(tmp_path / "c.ppm")
    native.write_pnm(p1, gray)
    native.write_pnm(p2, color)
    np.testing.assert_array_equal(native.read_pnm(p1), gray)
    np.testing.assert_array_equal(native.read_pnm(p2), color)


def test_pfm_roundtrip_native(tmp_path):
    gray = rng.standard_normal((9, 13)).astype(np.float32)
    color = rng.standard_normal((7, 5, 3)).astype(np.float32)
    p1, p2 = str(tmp_path / "g.pfm"), str(tmp_path / "c.pfm")
    native.write_pfm(p1, gray)
    native.write_pfm(p2, color)
    np.testing.assert_array_equal(native.read_pfm(p1), gray)
    np.testing.assert_array_equal(native.read_pfm(p2), color)


def test_pfm_native_python_cross_compat(tmp_path):
    data = rng.standard_normal((11, 6)).astype(np.float32)
    pn, pp = str(tmp_path / "n.pfm"), str(tmp_path / "p.pfm")
    native.write_pfm(pn, data)
    np.testing.assert_array_equal(io_utils.read_pfm(pn), data)
    io_utils.write_pfm(pp, data)
    np.testing.assert_array_equal(native.read_pfm(pp), data)


def test_pfm_native_reads_big_endian(tmp_path):
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "be.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\n4 3\n1.0\n")
        f.write(data[::-1].astype(">f4").tobytes())
    np.testing.assert_array_equal(native.read_pfm(p), data)


def test_pfm_native_crlf_header(tmp_path):
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    p = str(tmp_path / "crlf.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\r\n3 2\r\n-1.0\r\n")
        f.write(data[::-1].astype("<f4").tobytes())
    np.testing.assert_array_equal(native.read_pfm(p), data)


def _pgm_pairs(tmp_path, n, shape=(10, 12), writer=native.write_pnm):
    pairs, imgs = [], []
    for k in range(n):
        left = rng.integers(0, 256, shape, dtype=np.uint8)
        right = rng.integers(0, 256, shape, dtype=np.uint8)
        lp, rp = str(tmp_path / f"l{k}.pgm"), str(tmp_path / f"r{k}.pgm")
        writer(lp, left)
        writer(rp, right)
        pairs.append((lp, rp))
        imgs.append((left, right))
    return pairs, imgs


def test_pair_loader_in_order(tmp_path):
    pairs, imgs = _pgm_pairs(tmp_path, 6)
    out = list(native.PairLoader(pairs, threads=3, depth=2))
    assert len(out) == 6
    for (gl, gr), (wl, wr) in zip(out, imgs):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)


def test_pair_loader_color_gray_conversion(tmp_path):
    color = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
    lp, rp = str(tmp_path / "l.ppm"), str(tmp_path / "r.ppm")
    native.write_pnm(lp, color)
    native.write_pnm(rp, color)
    it = native.PairLoader([(lp, rp)])
    gl, gr = next(iter(it))
    want = io_utils.rgb_to_gray_u8(color)
    assert np.abs(gl.astype(int) - want.astype(int)).max() <= 1
    _same(gl, native.rgb_to_gray_u8(color))
    it.close()


def test_pair_loader_grows_buffer_for_oversized_pair(tmp_path):
    """An image larger than max_bytes stays in the stream: the C side keeps
    it queued on -3 with its geometry, the buffers grow and the pair is
    taken on the retry."""
    big = rng.integers(0, 256, (40, 50), dtype=np.uint8)
    small = rng.integers(0, 256, (5, 6), dtype=np.uint8)
    pairs = []
    for k, img in enumerate((big, small)):
        lp, rp = str(tmp_path / f"ol{k}.pgm"), str(tmp_path / f"or{k}.pgm")
        native.write_pnm(lp, img)
        native.write_pnm(rp, img)
        pairs.append((lp, rp))
    out = list(native.PairLoader(pairs, threads=1, max_bytes=small.size))
    assert len(out) == 2
    np.testing.assert_array_equal(out[0][0], big)
    np.testing.assert_array_equal(out[1][0], small)


# -- bit for bit against the JAX package's binding --------------------------------

def _lab_grid():
    """Every 6th code of each channel: 43^3 colours, the Lab tables' range."""
    c = np.arange(0, 256, 6, dtype=np.uint8)
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(-1, 43, 3)


IMAGE_CALLS = {
    "rgb_to_gray_u8": lambda m, s: m.rgb_to_gray_u8(_rgb(s)),
    "rgb_to_gray_u8 (every code)": lambda m, s: m.rgb_to_gray_u8(_lab_grid()),
    "rgb_to_lab_u8": lambda m, s: m.rgb_to_lab_u8(_rgb(s)),
    "rgb_to_lab_u8 (every 6th code)": lambda m, s: m.rgb_to_lab_u8(_lab_grid()),
    "replicate_pad_u8 pad 0": lambda m, s: m.replicate_pad_u8(_rgb(s)[..., 0], 0),
    "replicate_pad_u8 pad 5": lambda m, s: m.replicate_pad_u8(_rgb(s)[..., 1], 5),
    "replicate_pad_u8 1x1": lambda m, s: m.replicate_pad_u8(_rgb(s)[:1, :1, 2], 3),
    "normalize_u8": lambda m, s: m.normalize_u8(_floats(s)),
    "normalize_u8 constant": lambda m, s: m.normalize_u8(np.full((4, 5), 7.0, np.float32)),
    "normalize_u8 none finite": lambda m, s: m.normalize_u8(np.full((3, 3), np.nan,
                                                                    np.float32)),
    "median3_u8": lambda m, s: m.median3_u8(_rgb(s)[..., 0]),
    "median3_u8 one row": lambda m, s: m.median3_u8(_rgb(s)[:1, :, 1]),
}


def _rgb(seed, h=17, w=23):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _floats(seed):
    x = np.random.default_rng(seed).standard_normal((19, 23)).astype(np.float32) * 30
    x[2, 3], x[4, 5], x[6, 7] = np.inf, -np.inf, np.nan
    return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("call", sorted(IMAGE_CALLS))
def test_functions_equal_jax_binding(jax_native, call, seed):
    _same(IMAGE_CALLS[call](native, seed), IMAGE_CALLS[call](jax_native, seed))


@pytest.mark.parametrize("data", [np.zeros((9, 13)), np.zeros((7, 5, 3)), np.zeros((1, 1))],
                         ids=["pgm", "ppm", "1x1"])
def test_pnm_codec_equals_jax_binding(jax_native, tmp_path, data):
    img = np.random.default_rng(3).integers(0, 256, data.shape, dtype=np.uint8)
    tp, jp = str(tmp_path / "t.pnm"), str(tmp_path / "j.pnm")
    native.write_pnm(tp, img)
    jax_native.write_pnm(jp, img)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    _same(native.read_pnm(jp), jax_native.read_pnm(tp))
    _same(native.read_pnm(tp), img)


@pytest.mark.parametrize("shape", [(9, 13), (7, 5, 3)], ids=["grey", "colour"])
def test_pfm_codec_equals_jax_binding(jax_native, tmp_path, shape):
    data = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    data.flat[3] = np.inf
    tp, jp = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    native.write_pfm(tp, data)
    jax_native.write_pfm(jp, data)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    _same(native.read_pfm(jp), jax_native.read_pfm(tp))
    _same(native.read_pfm(tp), data)


@pytest.mark.parametrize("ext", ["pgm", "ppm"])
def test_pair_loader_equals_jax_binding(jax_native, tmp_path, ext):
    pairs = []
    for k in range(5):
        imgs = [_rgb(10 + k) if ext == "ppm" else _rgb(10 + k)[..., 0] for _ in range(2)]
        pairs.append(tuple(str(tmp_path / f"{s}{k}.{ext}") for s in "lr"))
        for p, img in zip(pairs[-1], (imgs[0], imgs[1][::-1].copy())):
            native.write_pnm(p, img)
    got = list(native.PairLoader(pairs, threads=2, depth=2))
    want = list(jax_native.PairLoader(pairs, threads=3, depth=1))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g[0], w[0])
        _same(g[1], w[1])


def test_read_errors_equal_jax_binding(jax_native, tmp_path):
    """A missing file, a bad magic and a truncated raster raise in both."""
    bad = tmp_path / "bad.pgm"
    bad.write_bytes(b"P2\n2 2\n255\n0 0 0 0")
    short = tmp_path / "short.pgm"
    short.write_bytes(b"P5\n2 2\n255\n\0")
    for p in (tmp_path / "missing.pgm", bad, short):
        for m in (native, jax_native):
            with pytest.raises(IOError):
                m.read_pnm(str(p))
    big = tmp_path / "big.pfm"
    big.write_bytes(b"Pf\n1000000 1000000\n-1.0\n\0\0\0\0")
    for m in (native, jax_native):
        with pytest.raises(IOError, match="too small"):
            m.read_pfm(str(big))


def test_pair_loader_takes_the_jax_bindings_parameters():
    """``tests/test_torch_signatures.py`` compares functions; the class's
    parameters are compared here."""
    port = inspect.signature(native.PairLoader.__init__).parameters
    ref = inspect.signature(jnative.PairLoader.__init__).parameters
    assert list(port) == list(ref)
    assert [p.default for p in port.values()] == [p.default for p in ref.values()]


# -- against utils.loader --------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3), (1, 1)], ids=["pgm", "ppm", "1x1"])
def test_codec_equals_python_loader(tmp_path, shape):
    img = np.random.default_rng(8).integers(0, 256, shape, dtype=np.uint8)
    tp, pp = str(tmp_path / "n.pnm"), str(tmp_path / "p.pnm")
    native.write_pnm(tp, img)
    loader.write_pnm(pp, img)
    assert open(tp, "rb").read() == open(pp, "rb").read()
    _same(native.read_pnm(pp), loader.read_pnm(tp))


@pytest.mark.parametrize("threads,depth", [(0, 1), (1, 1), (4, 2)])
def test_pair_loader_equals_python_loader_on_pgm(tmp_path, threads, depth):
    """Alike bit for bit, and alike in the decode workers each runs (at
    least one), which each reports as ``threads``."""
    pairs, imgs = _pgm_pairs(tmp_path, 7, writer=loader.write_pnm)
    ours, theirs = (native.PairLoader(pairs, threads=threads, depth=depth),
                    loader.PairLoader(pairs, threads=threads, depth=depth))
    assert ours.threads == theirs.threads == max(1, threads)
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 7
    for g, w, i in zip(got, want, imgs):
        _same(g[0], w[0])
        _same(g[1], w[1])
        _same(g[0], i[0])


def test_pair_loader_on_ppm_within_one_of_python_loader(tmp_path):
    """On PPM the two grey conversions may round a tie apart: within 1."""
    pairs = []
    for k in range(3):
        pairs.append((str(tmp_path / f"l{k}.ppm"), str(tmp_path / f"r{k}.ppm")))
        native.write_pnm(pairs[-1][0], _rgb(20 + k))
        native.write_pnm(pairs[-1][1], _rgb(30 + k))
    for (gl, gr), (wl, wr) in zip(native.PairLoader(pairs), loader.PairLoader(pairs),
                                  strict=True):
        for g, w in ((gl, wl), (gr, wr)):
            assert g.shape == w.shape and np.abs(g.astype(int) - w.astype(int)).max() <= 1


def test_pair_loader_raises_on_a_bad_pair_in_order(tmp_path):
    """A pair that fails to decode raises at its place; its neighbours
    are served."""
    pairs, imgs = _pgm_pairs(tmp_path, 3)
    pairs[1] = (pairs[1][0], str(tmp_path / "missing.pgm"))
    it = native.PairLoader(pairs, threads=2)
    _same(next(it)[0], imgs[0][0])
    with pytest.raises(IOError, match="pair 1"):
        next(it)
    _same(next(it)[0], imgs[2][0])
    with pytest.raises(StopIteration):
        next(it)


# -- the build ---------------------------------------------------------------------

def test_build_goes_to_the_ports_own_ignored_directory():
    """Beside the module, named by the hash of the source and the flags, and
    listed in .gitignore; the source is the repository's."""
    assert native.BUILD_DIR == Path(REPO) / PKG / "utils" / "_build"
    assert native.SOURCE == Path(REPO) / "native" / "stereo_host" / "stereo_host.cpp"
    assert native.library_path() == native.BUILD_DIR / native.library_name()
    assert native.library_name().startswith("libstereo_host_")
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert f"{PKG}/utils/_build/" in ignored
    # the Makefile's flags
    make = open(os.path.join(REPO, "native", "stereo_host", "Makefile")).read()
    assert f"CXXFLAGS ?= {' '.join(native.CXX_FLAGS)}" in make


_CHILD = """
import json, os, sys, time
from pathlib import Path
import numpy as np
from stereo_match_traditional_tpu_torch.utils import native
ready = Path(sys.argv[1])
(ready / f"ready{sys.argv[2]}").touch()
deadline = time.time() + 120
while len(list(ready.glob("ready*"))) < int(sys.argv[3]):   # start the builds together
    assert time.time() < deadline, "the other processes did not start"
    time.sleep(0.01)
path = native.library_path()
img = np.random.default_rng(5).integers(0, 256, (6, 7, 3), dtype=np.uint8)
print(json.dumps({"path": str(path), "gray": native.rgb_to_gray_u8(img).tolist()}))
"""


def _tree(root):
    return sorted((os.path.relpath(os.path.join(d, f), root),
                   os.stat(os.path.join(d, f)).st_mtime_ns, os.stat(os.path.join(d, f)).st_size)
                  for d, _, files in os.walk(root) for f in files)


def test_four_processes_build_one_library_and_touch_nothing_under_native(tmp_path):
    """A checkout with an empty ``_build/``: four processes that reach the
    build at once leave one library (no temporary file), all four load it
    and compute with it, and the files under ``native/`` are the same
    before and after, with the same times."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(REPO, PKG), root / PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(REPO, "native", "stereo_host"), root / "native" / "stereo_host",
                    ignore=shutil.ignore_patterns("*.so"))
    before = _tree(root / "native")
    ready = tmp_path / "ready"
    ready.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, str(ready), str(k), "4"],
                              cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for k in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e[-2000:] for _, e in outs]
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    build = root / PKG / "utils" / "_build"
    assert sorted(os.listdir(build)) == sorted([native.library_name(), "build.lock"])
    assert {g["path"] for g in got} == {str(build / native.library_name())}
    img = np.random.default_rng(5).integers(0, 256, (6, 7, 3), dtype=np.uint8)
    assert all(g["gray"] == native.rgb_to_gray_u8(img).tolist() for g in got)
    assert _tree(root / "native") == before


NO_LIBRARY_CALLS = {
    "available": None,
    "rgb_to_gray_u8": lambda: native.rgb_to_gray_u8(np.zeros((2, 2, 3), np.uint8)),
    "rgb_to_lab_u8": lambda: native.rgb_to_lab_u8(np.zeros((2, 2, 3), np.uint8)),
    "replicate_pad_u8": lambda: native.replicate_pad_u8(np.zeros((2, 2), np.uint8), 1),
    "normalize_u8": lambda: native.normalize_u8(np.zeros((2, 2), np.float32)),
    "median3_u8": lambda: native.median3_u8(np.zeros((2, 2), np.uint8)),
    "read_pnm": lambda: native.read_pnm("x.pgm"),
    "read_pfm": lambda: native.read_pfm("x.pfm"),
    "write_pfm": lambda: native.write_pfm("x.pfm", np.zeros((2, 2), np.float32)),
    "write_pnm": lambda: native.write_pnm("x.pgm", np.zeros((2, 2), np.uint8)),
    "PairLoader": lambda: native.PairLoader([("l.pgm", "r.pgm")]),
}


@pytest.fixture
def unbuilt(tmp_path, monkeypatch):
    """The binding with nothing loaded and an empty build directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


@pytest.mark.parametrize("name", sorted(NO_LIBRARY_CALLS))
def test_no_compiler_raises(unbuilt, monkeypatch, name):
    """Without g++ every function raises RuntimeError naming it (where the
    JAX binding returns None); ``available()`` says False."""
    monkeypatch.setattr(shutil, "which", lambda cmd, *a, **k: None)
    if name == "available":
        assert native.available() is False
        return
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        NO_LIBRARY_CALLS[name]()
    assert not (unbuilt / "_build").exists()


def test_build_error_raises_with_the_compilers_message(unbuilt, monkeypatch):
    src = unbuilt / "broken.cpp"
    src.write_text('extern "C" int smt_broken( { return 0; }\n')
    monkeypatch.setattr(native, "SOURCE", src)
    assert native.available() is False
    with pytest.raises(RuntimeError, match=r"g\+\+ failed .*broken\.cpp") as err:
        native.read_pnm("x.pgm")
    assert "error" in str(err.value).split("\n", 1)[1]
    assert sorted(os.listdir(unbuilt / "_build")) == ["build.lock"]     # no library, no tmp


def test_bad_shapes_raise_before_the_call():
    for call in (lambda: native.rgb_to_gray_u8(np.zeros((2, 2), np.uint8)),
                 lambda: native.rgb_to_lab_u8(np.zeros((2, 2, 4), np.uint8)),
                 lambda: native.median3_u8(np.zeros((2, 2, 3), np.uint8)),
                 lambda: native.replicate_pad_u8(np.zeros((2, 2, 3), np.uint8), 1),
                 lambda: native.write_pnm("x.pgm", np.zeros((2,), np.uint8)),
                 lambda: native.write_pfm("x.pfm", np.zeros((2, 2, 2), np.float32))):
        with pytest.raises(ValueError, match="needs"):
            call()
    with pytest.raises(ValueError, match="pad >= 0"):
        native.replicate_pad_u8(np.zeros((2, 2), np.uint8), -1)


# -- serving over the native loader ---------------------------------------------------

@pytest.mark.parametrize("batch_size", [1, 3])
def test_serve_pairs_over_native_loader_equals_pairs_in_memory(tmp_path, batch_size):
    pairs, paths = [], []
    for k in range(5):
        left, right, _ = make_pair(24, 32, 8, seed=k)
        pairs.append((left, right))
        paths.append((str(tmp_path / f"l{k}.pgm"), str(tmp_path / f"r{k}.pgm")))
        native.write_pnm(paths[-1][0], left)
        native.write_pnm(paths[-1][1], right)
    cfg = ADCensusConfig(disp_range=8)
    got = list(serve_pairs("ad_census", native.PairLoader(paths), cfg, batch_size=batch_size,
                           device="cpu"))
    want = list(serve_pairs("ad_census", pairs, cfg, batch_size=batch_size, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        _same(g, w)
