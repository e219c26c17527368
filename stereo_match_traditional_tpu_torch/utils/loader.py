"""Binary PGM/PPM codec and a prefetching stereo-pair loader in plain
Python and NumPy: ``read_pnm``, ``write_pnm`` and ``PairLoader`` mirror
the names of ``utils.native``, the port's binding of the C++ host library
(``native/stereo_host``), whose ``PairLoader`` decodes on C++ threads.
The format, the decode and the order of the pairs are the native ones; a
PPM's grey image may differ from the native one by 1 where the rounding of
``rgb_to_gray_u8`` ties.  This is the loader to ask for by name where no
C++ compiler is at hand: ``utils.native`` has no fallback.
"""

from __future__ import annotations

import concurrent.futures
from collections import deque
from typing import Iterable, Optional, Tuple

import numpy as np

from stereo_match_traditional_tpu_torch.utils.io import rgb_to_gray_u8


def _header(data: bytes, path: str):
    """``(channels, h, w, raster offset)`` of a binary PGM (P5) or PPM
    (P6) with ``0 < maxval < 256``; ``#`` comments may sit between the
    numbers, and one whitespace byte ends the header."""
    if data[:2] not in (b"P5", b"P6"):
        raise IOError(f"read_pnm({path}): not a binary PGM/PPM (magic {data[:2]!r})")
    vals, pos = [], 2
    while len(vals) < 3:
        if pos >= len(data):
            raise IOError(f"read_pnm({path}): truncated header")
        c = data[pos:pos + 1]
        if c == b"#":
            end = data.find(b"\n", pos)
            pos = len(data) if end < 0 else end + 1
        elif c.isspace():
            pos += 1
        elif c.isdigit():
            start = pos
            while pos < len(data) and data[pos:pos + 1].isdigit():
                pos += 1
            vals.append(int(data[start:pos]))
            pos += 1                             # the byte that ends the number
        else:
            raise IOError(f"read_pnm({path}): bad header byte {c!r}")
    w, h, maxval = vals
    if not 0 < maxval < 256:
        raise IOError(f"read_pnm({path}): maxval {maxval} is not 8-bit")
    return (1 if data[:2] == b"P5" else 3), h, w, pos


def read_pnm(path: str) -> np.ndarray:
    """A binary PGM as uint8 ``[H, W]`` or a PPM as RGB ``[H, W, 3]``."""
    with open(path, "rb") as f:
        data = f.read()
    ch, h, w, pos = _header(data, path)
    need = h * w * ch
    if pos + need > len(data):
        raise IOError(f"read_pnm({path}): truncated raster ({h}x{w}x{ch})")
    img = np.frombuffer(data, np.uint8, count=need, offset=pos).reshape(h, w, ch)
    return img[..., 0].copy() if ch == 1 else img.copy()


def write_pnm(path: str, img: np.ndarray) -> None:
    """uint8 ``[H, W]`` as a binary PGM, ``[H, W, 3]`` as a PPM (maxval 255)."""
    img = np.ascontiguousarray(img, np.uint8)
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.ndim not in (2, 3) or ch not in (1, 3):
        raise ValueError(f"write_pnm needs [H, W] or [H, W, 3], got {img.shape}")
    with open(path, "wb") as f:
        f.write(b"P%d\n%d %d\n255\n" % (5 if ch == 1 else 6, img.shape[1], img.shape[0]))
        f.write(img.tobytes())


def read_gray(path: str) -> np.ndarray:
    """uint8 ``[H, W]``: a PGM as it is, a PPM through ``io.rgb_to_gray_u8``."""
    return rgb_to_gray_u8(read_pnm(path))


def _load_pair(left: str, right: str) -> Tuple[np.ndarray, np.ndarray]:
    pair = read_gray(left), read_gray(right)
    if pair[0].shape != pair[1].shape:
        raise IOError(f"pair shapes differ: {left} {pair[0].shape}, {right} {pair[1].shape}")
    return pair


class PairLoader:
    """Threaded, prefetching stereo-pair loader.

    Decodes PGM/PPM pairs and gray-converts them on ``threads`` worker
    threads, at most ``depth`` pairs ahead of the consumer, while the card
    works on the pairs before; iteration yields ``(left, right)`` uint8
    ``[H, W]`` arrays in submission order.  A pair that fails to decode
    raises its error in the consumer, at its place in the order.
    """

    def __init__(self, pairs: Iterable[Tuple[str, str]], threads: int = 4,
                 depth: int = 4) -> None:
        self._todo = deque((str(a), str(b)) for a, b in pairs)
        self._depth = max(1, depth)
        self.threads = max(1, threads)      # the decode workers that run
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = (
            concurrent.futures.ThreadPoolExecutor(self.threads,
                                                  thread_name_prefix="pair-loader"))
        self._ahead: deque = deque()
        self._fill()

    def _fill(self) -> None:
        while self._todo and len(self._ahead) < self._depth:
            self._ahead.append(self._pool.submit(_load_pair, *self._todo.popleft()))

    def __iter__(self):
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._pool is None or not self._ahead:
            self.close()
            raise StopIteration
        fut = self._ahead.popleft()
        self._fill()
        try:
            return fut.result()
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Stop the workers; pairs not yet yielded are dropped."""
        if self._pool is not None:
            for fut in self._ahead:
                fut.cancel()
            self._ahead.clear()
            self._todo.clear()
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

