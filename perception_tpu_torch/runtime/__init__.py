"""Native host runtime: C++ PCD parser, threaded frame prefetcher and the
PNG row unfilter.

Counterpart of ``perception_tpu/runtime/__init__.py`` with its own copy of
the C++ source (``fastio.cpp``, plus ``png_unfilter``). The library is
built with ``g++`` at first use into ``build/perception_tpu_torch/host/``
at the root of the checkout, under a name keyed on a hash of the source
and the flags, and bound with ctypes. This is host I/O, not the device:
every entry point keeps a Python fallback for a host without a
toolchain, and ``native_available()`` reports which path is active;
``build_native()`` raises with the compiler's message instead.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Sequence

import numpy as np

_SRC = Path(__file__).with_name("fastio.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "perception_tpu_torch" / "host"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    """Where ``fastio.cpp`` is built for the current source and flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + "\0".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libperception_host-{digest}.so"


@functools.lru_cache(maxsize=None)
def build_native() -> ctypes.CDLL:
    """Build (unless an up-to-date build exists) and load the library, once
    per process. Raises ``RuntimeError`` with the compiler's output if
    ``g++`` is missing or fails."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(out))
    lib.pcd_read_xyz.restype = ctypes.c_long
    lib.pcd_read_xyz.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long]
    lib.prefetcher_create.restype = ctypes.c_void_p
    lib.prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_int, ctypes.c_int,
    ]
    lib.prefetcher_next.restype = ctypes.c_long
    lib.prefetcher_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long]
    lib.prefetcher_peek_size.restype = ctypes.c_long
    lib.prefetcher_peek_size.argtypes = [ctypes.c_void_p]
    lib.prefetcher_destroy.restype = None
    lib.prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_int,
    ]
    return lib


def _lib():
    """The loaded library, or None where it cannot be built."""
    try:
        return build_native()
    except (RuntimeError, OSError):
        return None


def native_available() -> bool:
    return _lib() is not None


def read_pcd_native(path) -> np.ndarray:
    """Fast PCD xyz reader; falls back to the Python parser."""
    lib = _lib()
    if lib is None:
        from perception_tpu_torch.io.pcd import read_pcd

        return read_pcd(path)
    path_b = str(path).encode()
    n = lib.pcd_read_xyz(path_b, None, 0)
    if n < 0:
        raise ValueError(f"{path}: native PCD parse failed")
    out = np.empty((n, 3), np.float32)
    got = lib.pcd_read_xyz(path_b, out.ctypes.data_as(ctypes.c_void_p), n)
    return out[:got]


def png_unfilter_native(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Unfilter ``height`` PNG rows of 1 + ``stride`` bytes (filter type
    first) in the native library -> (height, stride) uint8. The caller
    checks ``native_available()`` first."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != height * (stride + 1) or bpp < 1:
        raise ValueError(f"PNG data of {raw.size} bytes is not {height} rows of {stride + 1}")
    out = np.empty((height, stride), np.uint8)
    if build_native().png_unfilter(raw.ctypes.data, out.ctypes.data, height, stride, bpp) != 0:
        raise ValueError("PNG row with a filter type other than 0-4")
    return out


class FramePrefetcher:
    """Ordered read-ahead of a file list on C++ worker threads.

    Yields each file's bytes in list order while workers read the next
    ones into a bounded ring. An unreadable file yields ``b""``. Falls back
    to plain sequential reads without the native library."""

    def __init__(self, paths: Sequence[str], threads: int = 2, ring: int = 4):
        self.paths = [str(p) for p in paths]
        self._i = 0
        self._lib = _lib()
        self._handle = None
        if self._lib is not None:
            self._names = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            self._handle = self._lib.prefetcher_create(self._names, len(self.paths), threads, ring)

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        if self._i >= len(self.paths):
            self.close()
            raise StopIteration
        self._i += 1
        if self._handle:
            size = self._lib.prefetcher_peek_size(self._handle)
            if size < 0:
                raise StopIteration
            buf = ctypes.create_string_buffer(size)
            self._lib.prefetcher_next(self._handle, buf, size)
            return buf.raw
        try:
            with open(self.paths[self._i - 1], "rb") as f:
                return f.read()
        except OSError:
            return b""

    def close(self) -> None:
        if self._handle:
            self._lib.prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
