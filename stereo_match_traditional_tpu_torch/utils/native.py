"""ctypes binding of the native host library, the counterpart of the JAX
package's ``utils/native``: the same public names and parameters over the
same C++ source, ``native/stereo_host/stereo_host.cpp`` (image codecs,
colour conversion, padding, display normalisation, a 3x3 median, PFM, and
``PairLoader``, a decode pool on C++ threads).

The library is built at first use, never at import: ``g++`` with the flags
of ``native/stereo_host/Makefile`` compiles the repository's source into
``_build/`` beside this file (listed in ``.gitignore``), under a name that
hashes the source and the flags, so a library is never stale.  One process
builds while the others wait on a file lock in ``_build/``; the build
writes a temporary name and renames it, so no process loads half a file.
Nothing is written under ``native/``.

There is no quiet fallback: where the library cannot be built or loaded,
every function raises ``RuntimeError`` naming the compiler or its error,
and :func:`available` says whether it builds and loads.  Python decode is
``utils.loader.PairLoader``, asked for by name.

The library is loaded with ``ctypes.CDLL``, which releases the GIL for the
length of every call, so ``PairLoader``'s blocking wait for the next pair
does not hold up the other Python threads.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Tuple

import numpy as np
import torch

from stereo_match_traditional_tpu_torch.utils.profiling import span

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE.parents[1] / "native" / "stereo_host" / "stereo_host.cpp"
BUILD_DIR = _HERE / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-pthread", "-std=c++17", "-Wall")  # the Makefile's
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib = None


def library_name() -> str:
    """The library's file name: a hash of the source and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return f"libstereo_host_{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Compile the library if none exists for the current source; return
    its path.  Raises ``RuntimeError`` naming the missing source or
    compiler, or with the compiler's error output."""
    if not SOURCE.exists():
        raise RuntimeError(f"native host library source {SOURCE} not found")
    lib = BUILD_DIR / library_name()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native host library "
                           f"from {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)        # released when the file closes
        if lib.exists():                        # built by another process meanwhile
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    """The loaded library with every entry point's C signature set; built at
    the first call.  Raises ``RuntimeError`` where it cannot be built or
    loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load the native host library {path}: {e}") from e
        i32, i64, cp, vp = ctypes.c_int, ctypes.c_int64, ctypes.c_char_p, ctypes.c_void_p
        u8p, f32p, i32p = (ctypes.POINTER(t) for t in (ctypes.c_uint8, ctypes.c_float, i32))
        lib.smt_rgb_to_gray_u8.argtypes = [u8p, i64, u8p]
        lib.smt_rgb_to_lab_u8.argtypes = [u8p, i64, u8p]
        lib.smt_replicate_pad_u8.argtypes = [u8p, i32, i32, i32, u8p]
        lib.smt_normalize_u8.argtypes = [f32p, i64, u8p]
        lib.smt_median3_u8.argtypes = [u8p, i32, i32, u8p]
        lib.smt_read_pnm.argtypes = [cp, u8p, i64, i32p, i32p, i32p, i32]
        lib.smt_write_pnm.argtypes = [cp, u8p, i32, i32, i32]
        lib.smt_read_pfm.argtypes = [cp, f32p, i64, i32p, i32p, i32p, i32]
        lib.smt_write_pfm.argtypes = [cp, f32p, i32, i32, i32]
        for name in ("smt_read_pnm", "smt_write_pnm", "smt_read_pfm", "smt_write_pfm",
                     "smt_loader_next"):
            getattr(lib, name).restype = i32
        for name in ("smt_rgb_to_gray_u8", "smt_rgb_to_lab_u8", "smt_replicate_pad_u8",
                     "smt_normalize_u8", "smt_median3_u8", "smt_loader_destroy"):
            getattr(lib, name).restype = None
        lib.smt_loader_create.argtypes = [ctypes.POINTER(cp), ctypes.POINTER(cp), i64, i32, i32]
        lib.smt_loader_create.restype = vp
        lib.smt_loader_next.argtypes = [vp, u8p, u8p, i64, i32p, i32p]
        lib.smt_loader_destroy.argtypes = [vp]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library builds and loads.  Where it does not, every other
    function of this module raises ``RuntimeError`` with the reason."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _image(img, name: str, dtype=np.uint8, grey=True, colour=True) -> np.ndarray:
    """``img`` as a C-contiguous array of ``dtype``, checked to be ``[H, W]``
    (``grey``) or ``[H, W, 3]`` (``colour``) before its pointer is passed."""
    img = np.ascontiguousarray(img, dtype)
    if not ((grey and img.ndim == 2) or (colour and img.ndim == 3 and img.shape[2] == 3)):
        shapes = " or ".join(s for s, ok in (("[H, W]", grey), ("[H, W, 3]", colour)) if ok)
        raise ValueError(f"{name} needs {shapes}, got {img.shape}")
    return img


def rgb_to_gray_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's fixed-point RGB -> grey, uint8 ``[H, W]``."""
    lib = _load()
    img = _image(img, "rgb_to_gray_u8", grey=False)
    out = np.empty(img.shape[:2], np.uint8)
    lib.smt_rgb_to_gray_u8(_u8p(img), img.shape[0] * img.shape[1], _u8p(out))
    return out


def rgb_to_lab_u8(img: np.ndarray) -> np.ndarray:
    """OpenCV's 8-bit Lab codes of an RGB image, uint8 ``[H, W, 3]``."""
    lib = _load()
    img = _image(img, "rgb_to_lab_u8", grey=False)
    out = np.empty_like(img)
    lib.smt_rgb_to_lab_u8(_u8p(img), img.shape[0] * img.shape[1], _u8p(out))
    return out


def replicate_pad_u8(img: np.ndarray, pad: int) -> np.ndarray:
    """``copyMakeBorder(BORDER_REPLICATE)`` of a uint8 ``[H, W]`` image."""
    lib = _load()
    img = _image(img, "replicate_pad_u8", colour=False)
    if pad < 0:
        raise ValueError(f"replicate_pad_u8 needs pad >= 0, got {pad}")
    h, w = img.shape
    out = np.empty((h + 2 * pad, w + 2 * pad), np.uint8)
    lib.smt_replicate_pad_u8(_u8p(img), h, w, pad, _u8p(out))
    return out


def normalize_u8(x: np.ndarray) -> np.ndarray:
    """Min-max stretch of the finite values to [0, 255] (non-finite -> 0)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty(x.shape, np.uint8)
    lib.smt_normalize_u8(_f32p(x), x.size, _u8p(out))
    return out


def median3_u8(img: np.ndarray) -> np.ndarray:
    """3x3 median of a uint8 ``[H, W]`` image, replicated borders."""
    lib = _load()
    img = _image(img, "median3_u8", colour=False)
    out = np.empty_like(img)
    lib.smt_median3_u8(_u8p(img), img.shape[0], img.shape[1], _u8p(out))
    return out


def _geometry():
    return ctypes.c_int(), ctypes.c_int(), ctypes.c_int()


def read_pnm(path: str) -> np.ndarray:
    """A binary PGM as uint8 ``[H, W]`` or a PPM as RGB ``[H, W, 3]``."""
    lib = _load()
    h, w, ch = _geometry()
    geo = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch))
    rc = lib.smt_read_pnm(os.fsencode(path), None, 0, *geo, 1)
    if rc != 0:
        raise IOError(f"read_pnm({path}): header error {rc}")
    buf = np.empty(h.value * w.value * ch.value, np.uint8)
    rc = lib.smt_read_pnm(os.fsencode(path), _u8p(buf), buf.size, *geo, 0)
    if rc != 0:
        raise IOError(f"read_pnm({path}): read error {rc}")
    img = buf.reshape(h.value, w.value, ch.value)
    return img[..., 0] if ch.value == 1 else img


def read_pfm(path: str) -> np.ndarray:
    """A PFM as float32 ``[H, W]`` or ``[H, W, 3]``, rows top to bottom."""
    lib = _load()
    h, w, ch = _geometry()
    geo = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(ch))
    rc = lib.smt_read_pfm(os.fsencode(path), None, 0, *geo, 1)
    if rc != 0:
        raise IOError(f"read_pfm({path}): header error {rc}")
    # bound the allocation by the file's size before trusting the header
    need = h.value * w.value * ch.value
    if need * 4 > os.path.getsize(path):
        raise IOError(f"read_pfm({path}): header claims {h.value}x{w.value}x{ch.value}"
                      " but the file is too small to hold that raster")
    buf = np.empty(need, np.float32)
    rc = lib.smt_read_pfm(os.fsencode(path), _f32p(buf), buf.size, *geo, 0)
    if rc != 0:
        raise IOError(f"read_pfm({path}): read error {rc}")
    img = buf.reshape(h.value, w.value, ch.value)
    return img[..., 0] if ch.value == 1 else img


def write_pfm(path: str, data: np.ndarray) -> None:
    """float32 ``[H, W]`` or ``[H, W, 3]`` as a PFM in the host's byte order."""
    lib = _load()
    data = _image(data, "write_pfm", np.float32)
    ch = 1 if data.ndim == 2 else data.shape[2]
    rc = lib.smt_write_pfm(os.fsencode(path), _f32p(data), data.shape[0], data.shape[1], ch)
    if rc != 0:
        raise IOError(f"write_pfm({path}): error {rc}")


def write_pnm(path: str, img: np.ndarray) -> None:
    """uint8 ``[H, W]`` as a binary PGM, ``[H, W, 3]`` as a PPM."""
    lib = _load()
    img = _image(img, "write_pnm")
    ch = 1 if img.ndim == 2 else img.shape[2]
    rc = lib.smt_write_pnm(os.fsencode(path), _u8p(img), img.shape[0], img.shape[1], ch)
    if rc != 0:
        raise IOError(f"write_pnm({path}): error {rc}")


class PairLoader:
    """Threaded, pipelined stereo-pair loader over the C++ worker pool.

    Decodes PGM/PPM pairs and grey-converts them (``rgb_to_gray_u8``) on
    ``threads`` native threads, at most ``depth`` pairs ahead, while the
    card works on the pairs before; iteration yields ``(left, right)``
    uint8 ``[H, W]`` arrays in submission order.  A pair larger than
    ``max_bytes`` a side stays queued on the C side, which reports its
    geometry; the buffers grow and the pair is taken on the retry.

    The C side copies each pair into buffers that the yielded arrays then
    own: fresh buffers, sized to the last pair, are made for the next one.
    Where a card is present they are page-locked (from torch's caching
    host allocator, so a block freed by an earlier pair is reused without
    faulting its pages in again), and ``models.batch.serve_pairs`` copies a
    single pair to the card straight from them.

    Each ``next()`` is two :func:`utils.profiling.span` s with ``pair=``
    the pair's index in the loader's stream: ``stereo/loader_wait`` (the
    wait on the pool and the C side's copy, both tries where the buffers
    grow) and ``stereo/loader_copy`` (the pair handed over and the next
    pair's buffers made).
    """

    def __init__(
        self,
        pairs: Iterable[Tuple[str, str]],
        threads: int = 4,
        depth: int = 4,
        max_bytes: int = 64 * 1024 * 1024,
    ) -> None:
        self._handle = None                 # for __del__, should _load raise
        self.threads = max(1, threads)      # the decode workers the C side starts
        self._lib = lib = _load()
        items = [(os.fsencode(str(a)), os.fsencode(str(b))) for a, b in pairs]
        lefts = (ctypes.c_char_p * len(items))(*[a for a, _ in items])
        rights = (ctypes.c_char_p * len(items))(*[b for _, b in items])
        # the C side copies the paths before it returns
        self._handle = lib.smt_loader_create(lefts, rights, len(items), threads, depth)
        self._pinned = torch.cuda.is_available()
        self._buf_l, self._buf_r = self._buffers(max_bytes)
        self._taken = 0

    def _buffers(self, nbytes: int) -> Tuple[np.ndarray, np.ndarray]:
        """Two fresh uint8 buffers of ``nbytes``, page-locked where a card is present."""
        if self._pinned:
            return tuple(torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()
                         for _ in range(2))
        return np.empty(nbytes, np.uint8), np.empty(nbytes, np.uint8)

    def __iter__(self):
        return self

    def _next(self, h, w) -> int:
        return self._lib.smt_loader_next(self._handle, _u8p(self._buf_l), _u8p(self._buf_r),
                                         self._buf_l.size, ctypes.byref(h), ctypes.byref(w))

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is None:
            raise StopIteration
        h, w = ctypes.c_int(), ctypes.c_int()
        with span("stereo/loader_wait", pair=self._taken):
            rc = self._next(h, w)
            if rc == -3:
                self._buf_l, self._buf_r = self._buffers(h.value * w.value)
                rc = self._next(h, w)
        if rc == 1:
            self.close()
            raise StopIteration
        self._taken += 1                    # a pair that failed is taken from the stream too
        if rc != 0:
            raise IOError(f"native PairLoader: pair {self._taken - 1} failed to decode "
                          f"(error {rc})")
        n = h.value * w.value
        with span("stereo/loader_copy", pair=self._taken - 1):
            left = self._buf_l[:n].reshape(h.value, w.value)
            right = self._buf_r[:n].reshape(h.value, w.value)
            self._buf_l, self._buf_r = self._buffers(n)
        return left, right

    def close(self) -> None:
        """Stop the workers; pairs not yet yielded are dropped."""
        if self._handle is not None:
            self._lib.smt_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
