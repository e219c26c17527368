"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and the objects are linked into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v -c -o <obj>.o csrc/<name>.cu   # per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o libstereo_kernels_<hash>.so *.o

No fast-math: the kernels are held to their plain versions to the bit or
nearly.  The library's name carries a hash of the sources, the headers they
share (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.  ``_build/``
sits beside this file and is listed in ``.gitignore``; nvcc's output
(ptxas register and shared-memory counts) is kept next to the library as
``<name>.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME or $CUDA_PATH")
    return str(path)


def library_name(csrc: Path = CSRC) -> str:
    """The library's file name: a hash of every source and header in
    ``csrc`` and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return f"libstereo_kernels_{digest.hexdigest()[:16]}.so"


def library_path() -> Path:
    """Compile the kernels if no library for the current sources exists;
    return its path.  Raises ``RuntimeError`` with nvcc's stderr if the
    build fails."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / library_name()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(sources, objs))
    ]
    log = []
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed.append(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    lib.with_suffix(".log").write_text("".join(log))
    os.replace(tmp, lib)    # atomic: a concurrent loader never sees half a file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's C signature set
    (ctypes would otherwise pass pointers as 32-bit ints)."""
    lib = ctypes.CDLL(str(library_path()))
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.asw_volume_left_f32.argtypes = [vp, vp, vp, i32, i32, i32, i32, f32, f32, f32, vp]
    lib.asw_volume_left_f32.restype = i32
    lib.ad_census_volume_f32.argtypes = [vp, vp, i32, vp, vp, vp, i32, i32, i32, i32, i32,
                                         i32, i32, i32, f32, f32, i32, vp]
    lib.ad_census_volume_f32.restype = i32
    lib.scanline_optimize_f32.argtypes = [vp, vp, vp, vp, i32, i32, i32, f32, f32,
                                          i32, i32, vp]
    lib.scanline_optimize_f32.restype = i32
    lib.scanline_canonical_f32.argtypes = [vp, vp, vp, i32, vp, vp, i32, i32, i32, f32, f32,
                                           f32, i32, vp]
    lib.scanline_canonical_f32.restype = i32
    lib.sad_volume_f32.argtypes = [vp, vp, i32, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.sad_volume_f32.restype = i32
    lib.ncc_window_sums_f32.argtypes = [vp, vp, i32, vp, i32, i32, i32, vp]
    lib.ncc_window_sums_f32.restype = i32
    lib.ncc_volume_f32.argtypes = [vp, vp, i32, vp, vp, i32, i32, i32, i32, i32, f32, f32,
                                   vp]
    lib.ncc_volume_f32.restype = i32
    i64 = ctypes.c_longlong
    lib.scanline_banded_f32.argtypes = [vp, i64, i64, i64, vp, i64, i64, vp, i64, i64, i64,
                                        vp, vp, vp, vp, i32, i32, i32, f32, i32, i32, vp]
    lib.scanline_banded_f32.restype = i32
    lib.scanline_banded_canonical_f32.argtypes = [vp, i64, i64, i64, vp, i64, i64, i64, vp,
                                                  i64, i64, i64, vp, vp, vp, vp, i32, i32, i32,
                                                  f32, f32, i32, vp]
    lib.scanline_banded_canonical_f32.restype = i32
    lib.scanline_horizontal_band_f32.argtypes = [vp, i64, i64, vp, vp, vp, i32, i32, i32, f32,
                                                 f32, vp]
    lib.scanline_horizontal_band_f32.restype = i32
    lib.scanline_canonical_horizontal_band_f32.argtypes = [vp, i64, i64, vp, vp, i32, vp, vp,
                                                           vp, i32, i32, i32, f32, f32, f32,
                                                           i32, vp]
    lib.scanline_canonical_horizontal_band_f32.restype = i32
    lib.stereo_kernels_error_string.argtypes = [i32]
    lib.stereo_kernels_error_string.restype = ctypes.c_char_p
    return lib
