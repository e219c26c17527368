"""The port's own ``utils.io`` against the JAX package's (every function,
byte-equal outputs on random inputs, file round trips both ways) and the
port's PGM/PPM codec and ``PairLoader`` (``utils.loader``) against the
native codec and loader of the JAX package's ``utils.native``."""

import os
import subprocess

import numpy as np
import pytest

from stereo_match_traditional_tpu.utils import io as jio
from stereo_match_traditional_tpu.utils import native
from stereo_match_traditional_tpu_torch.utils import io as tio
from stereo_match_traditional_tpu_torch.utils import loader

RNG_SEEDS = [0, 1, 2]
NATIVE_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native", "stereo_host", "stereo_host.cpp")


@pytest.fixture(scope="module", autouse=True)
def _native_library(tmp_path_factory):
    """The native binding loads a library built for this module alone.

    ``utils.native`` builds ``native/stereo_host/libstereo_host.so`` in place
    at first use with an unlocked ``make``; parallel test workers that reach
    that build together can ``dlopen`` a half-written file, and the binding
    then caches its failure and returns None for the rest of the process.
    Here the library is built with the Makefile's flags into this worker's
    own temporary directory, the binding is pointed at it and its cached
    state reset, and all three are restored after the module."""
    so = tmp_path_factory.mktemp("stereo_host") / "libstereo_host.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall",
                    "-o", str(so), NATIVE_SRC], check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "_SO", str(so))
        mp.setattr(native, "_lib", None)
        mp.setattr(native, "_tried", False)
        yield


def _rgb(seed, h=17, w=23):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_io_is_a_copy_with_the_same_functions():
    names = sorted(n for n, v in vars(jio).items()
                   if callable(v) and not n.startswith("_") and getattr(v, "__module__", "") == jio.__name__)
    assert names == ["imread", "imwrite", "normalize_u8", "read_gt_disparity", "read_pfm",
                     "replicate_pad", "rgb_to_gray_u8", "rgb_to_lab_u8",
                     "rgb_to_lab_u8_float", "transform_to_show", "write_pfm"]
    for n in names:
        assert getattr(tio, n).__module__ == tio.__name__, n


@pytest.mark.parametrize("seed", RNG_SEEDS)
@pytest.mark.parametrize("fn", ["rgb_to_gray_u8", "rgb_to_lab_u8", "rgb_to_lab_u8_float"])
def test_colour_conversions_equal_jax(fn, seed):
    img = _rgb(seed)
    img[0, :3] = [[0, 0, 0], [255, 255, 255], [255, 0, 128]]   # the ends of the tables
    _same(getattr(tio, fn)(img), getattr(jio, fn)(img))


def test_gray_input_passes_through():
    g = _rgb(3)[..., 0]
    _same(tio.rgb_to_gray_u8(g), jio.rgb_to_gray_u8(g))


@pytest.mark.parametrize("seed", RNG_SEEDS)
def test_display_maps_equal_jax(seed):
    """``transform_to_show``, ``normalize_u8`` and ``replicate_pad`` on
    float maps with non-finite values, negative values and flat maps."""
    rng = np.random.default_rng(seed)
    d = (rng.standard_normal((13, 19)) * 80).astype(np.float32)
    d[0, 0], d[1, 1], d[2, 2] = np.inf, -np.inf, np.nan
    for x in (d, np.full((4, 5), 7.0), np.full((3, 3), np.nan)):
        _same(tio.transform_to_show(x), jio.transform_to_show(x))
        _same(tio.normalize_u8(x), jio.normalize_u8(x))
    for pad in (0, 1, 4):
        _same(tio.replicate_pad(d, pad), jio.replicate_pad(d, pad))
        _same(tio.replicate_pad(_rgb(seed), pad), jio.replicate_pad(_rgb(seed), pad))


@pytest.mark.parametrize("shape", [(9, 11), (6, 7, 3)], ids=["Pf", "PF"])
@pytest.mark.parametrize("scale", [1.0, 1e-7, 4.0])
def test_pfm_files_equal_jax_both_ways(tmp_path, shape, scale):
    data = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    data.flat[0] = np.inf
    tp, jp = str(tmp_path / "t.pfm"), str(tmp_path / "j.pfm")
    tio.write_pfm(tp, data, scale)
    jio.write_pfm(jp, data, scale)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    _same(tio.read_pfm(jp), jio.read_pfm(jp))
    _same(tio.read_pfm(tp), data)


def test_pfm_big_endian_and_crlf_header(tmp_path):
    """A big-endian raster (positive scale) behind a CRLF header."""
    data = np.arange(12, dtype=np.float32).reshape(3, 4)
    p = str(tmp_path / "be.pfm")
    with open(p, "wb") as f:
        f.write(b"Pf\r\n4 3\r\n1.0\r\n" + data[::-1].astype(">f4").tobytes())
    _same(tio.read_pfm(p), jio.read_pfm(p))
    _same(tio.read_pfm(p), data)


@pytest.mark.parametrize("content,match", [
    (b"P5\n4 3\n1.0\n" + b"\0" * 12, "not a PFM"), (b"Pf\n4", "truncated PFM header"),
    (b"Pf\n4 3\n-1.0\n" + b"\0" * 8, "truncated PFM raster"), (b"Pf\n0 3\n-1\n", "bad PFM"),
], ids=["magic", "header", "raster", "size"])
def test_pfm_errors_equal_jax(tmp_path, content, match):
    p = str(tmp_path / "bad.pfm")
    open(p, "wb").write(content)
    for mod in (tio, jio):
        with pytest.raises(ValueError, match=match):
            mod.read_pfm(p)
    with pytest.raises(ValueError, match="scale"):
        tio.write_pfm(p, np.zeros((2, 2)), scale=0)
    with pytest.raises(ValueError, match="PFM needs"):
        tio.write_pfm(p, np.zeros((2, 2, 2)))


@pytest.mark.parametrize("ext", ["png", "pgm"])
def test_image_round_trips_equal_jax(tmp_path, ext):
    """imwrite/imread of gray and colour images, also across the two
    packages, and a 16-bit image read down to 8 bits."""
    for img in (_rgb(5), _rgb(6)[..., 1]):
        tp, jp = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
        if ext == "pgm" and img.ndim == 3:
            tp, jp = tp[:-3] + "ppm", jp[:-3] + "ppm"
        tio.imwrite(tp, img)
        jio.imwrite(jp, img)
        _same(tio.imread(tp), jio.imread(jp))
        _same(tio.imread(jp), img)
    import imageio.v3 as iio

    p16 = str(tmp_path / "d16.png")
    iio.imwrite(p16, np.arange(0, 65536, 257, dtype=np.uint16).reshape(16, 16))
    _same(tio.imread(p16), jio.imread(p16))


@pytest.mark.parametrize("fmt", ["pfm", "png"])
def test_gt_disparity_equals_jax(tmp_path, fmt, capsys):
    rng = np.random.default_rng(7)
    if fmt == "pfm":
        gt = (rng.random((10, 12)) * 60).astype(np.float32)
        gt[0, :3] = np.inf
        p = str(tmp_path / "gt.pfm")
        tio.write_pfm(p, gt)
    else:
        gt = rng.integers(0, 256, (10, 12), dtype=np.uint8)
        gt[0, :3] = 0
        p = str(tmp_path / "gt.png")
        tio.imwrite(p, gt)
    for scale in (None, 1.0, 4.0):
        got, want = tio.read_gt_disparity(p, scale), jio.read_gt_disparity(p, scale)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)        # NaN where unknown, in both
        assert np.isnan(got[0, :3]).all()
    assert "assuming integer GT scale" in capsys.readouterr().err or fmt == "pfm"


def test_png_paths_raise_without_imageio(tmp_path, monkeypatch):
    """Where imageio is missing (the card's machine) the PNG paths raise the
    copy's own error and PFM still works."""
    monkeypatch.setattr(tio, "_iio", None)
    for call in (lambda: tio.imread("x.png"), lambda: tio.imwrite("x.png", np.zeros((2, 2))),
                 lambda: tio.read_gt_disparity("x.png", 4.0)):
        with pytest.raises(RuntimeError, match="imageio is unavailable"):
            call()
    p = str(tmp_path / "d.pfm")
    tio.write_pfm(p, np.ones((2, 3), np.float32))
    _same(tio.read_pfm(p), np.ones((2, 3), np.float32))


# -- the PGM/PPM codec and the pair loader ----------------------------------

@pytest.mark.parametrize("shape", [(5, 7), (4, 6, 3), (1, 1)], ids=["pgm", "ppm", "1x1"])
def test_pnm_files_equal_native(tmp_path, shape):
    img = np.random.default_rng(8).integers(0, 256, shape, dtype=np.uint8)
    tp, np_path = str(tmp_path / "t.pnm"), str(tmp_path / "n.pnm")
    loader.write_pnm(tp, img)
    native.write_pnm(np_path, img)
    assert open(tp, "rb").read() == open(np_path, "rb").read()
    _same(loader.read_pnm(np_path), native.read_pnm(tp))
    _same(loader.read_pnm(tp), img)


def test_pnm_header_with_comments(tmp_path):
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    p = str(tmp_path / "c.pgm")
    open(p, "wb").write(b"P5\n# made by hand\n4 3\n# maxval next\n255\n" + img.tobytes())
    _same(loader.read_pnm(p), native.read_pnm(p))
    _same(loader.read_pnm(p), img)


@pytest.mark.parametrize("content,match", [
    (b"P2\n2 2\n255\n0 0 0 0", "binary PGM"), (b"P5\n2 2\n65535\n" + b"\0" * 8, "8-bit"),
    (b"P5\n2 2\n255\n\0", "truncated raster"), (b"P5\n2", "truncated header"),
], ids=["ascii", "16bit", "raster", "header"])
def test_pnm_errors(tmp_path, content, match):
    p = str(tmp_path / "bad.pgm")
    open(p, "wb").write(content)
    with pytest.raises(IOError, match=match):
        loader.read_pnm(p)
    with pytest.raises(IOError):             # the native codec refuses them too
        native.read_pnm(p)


@pytest.mark.parametrize("ext", ["pgm", "ppm"])
def test_loader_decode_equals_io(tmp_path, ext):
    """A PGM decodes as it is, a PPM through ``io.rgb_to_gray_u8``: what
    ``rgb_to_gray_u8(imread(...))`` gives, and the native decode."""
    img = _rgb(9) if ext == "ppm" else _rgb(9)[..., 2]
    p = str(tmp_path / f"x.{ext}")
    loader.write_pnm(p, img)
    want = tio.rgb_to_gray_u8(tio.imread(p))
    _same(loader.read_gray(p), want)
    _same(next(iter(loader.PairLoader([(p, p)])))[0], want)


def _write_pairs(tmp_path, n, shape=(12, 15)):
    rng = np.random.default_rng(10)
    paths, imgs = [], []
    for k in range(n):
        left = rng.integers(0, 256, shape, dtype=np.uint8)
        right = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        lp, rp = str(tmp_path / f"l{k}.pgm"), str(tmp_path / f"r{k}.ppm")
        loader.write_pnm(lp, left)
        loader.write_pnm(rp, right)
        paths.append((lp, rp))
        imgs.append((left, tio.rgb_to_gray_u8(right)))
    return paths, imgs


@pytest.mark.parametrize("threads,depth", [(1, 1), (4, 2), (3, 8)])
def test_pair_loader_yields_pairs_in_order(tmp_path, threads, depth):
    paths, imgs = _write_pairs(tmp_path, 7)
    got = list(loader.PairLoader(paths, threads=threads, depth=depth))
    assert len(got) == 7
    for (gl, gr), (wl, wr) in zip(got, imgs):
        _same(gl, wl)
        _same(gr, wr)
    # the native loader decodes alike; its C++ gray conversion may round a
    # .5 tie the other way (a contracted multiply-add), one code at most
    want = list(native.PairLoader(paths, threads=2, depth=2))
    for (gl, gr), (wl, wr) in zip(got, want, strict=True):
        _same(gl, wl)
        assert np.abs(gr.astype(int) - wr.astype(int)).max() <= 1


def test_pair_loader_keeps_at_most_depth_ahead(tmp_path):
    paths, _ = _write_pairs(tmp_path, 6)
    it = loader.PairLoader(paths, threads=2, depth=2)
    assert len(it._ahead) == 2
    next(it)
    assert len(it._ahead) == 2 and len(it._todo) == 3
    assert len(list(it)) == 5 and it._pool is None


@pytest.mark.parametrize("fault", ["missing", "corrupt", "shape"])
def test_pair_loader_raises_decode_errors_in_order(tmp_path, fault):
    """The pairs before the bad one arrive; the bad one raises in the
    consumer; the loader stops."""
    paths, imgs = _write_pairs(tmp_path, 4)
    bad = paths[2][0]
    if fault == "missing":
        os.remove(bad)
    elif fault == "corrupt":
        open(bad, "wb").write(b"P5\n99 99\n255\n\0")
    else:
        loader.write_pnm(bad, np.zeros((3, 3), np.uint8))
    it = loader.PairLoader(paths, threads=2, depth=4)
    for k in range(2):
        _same(next(it)[0], imgs[k][0])
    with pytest.raises(OSError):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
