"""ctypes bindings for the port's C++ host data plane (``oi_native.cpp``).

Provides:
  * ``parse_proc(path) -> np.ndarray``       (np.genfromtxt replacement)
  * ``radius_neighbors(points, cells, r)``   (cKDTree.query_ball_point ->
    CSR (offsets, indices), a uniform-grid hash; each cell's indices sorted
    ascending, as cKDTree returns them for a set of query points)

Copy of ``optimalinterpolation_tpu/native/__init__.py`` with another build:
the library is compiled at first use by ``g++`` called directly (``CXX_FLAGS``)
into ``native/_build/liboi_native_<hash>.so``, named by a hash of the source
and the flags, as ``ops/_cuda.py`` names the kernels' library. A build that
fails raises with the compiler's output: no caller falls back to SciPy or
``genfromtxt``. Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["build", "parse_proc", "radius_neighbors"]

SOURCE = Path(__file__).resolve().parent / "oi_native.cpp"
BUILD_DIR = SOURCE.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def build() -> Path:
    """Compile ``oi_native.cpp`` unless a library for this source and these
    flags exists; returns its path. Concurrent builds (test workers) each
    compile to a name of their own and move it into place atomically."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"liboi_native_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native data plane cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp"
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE.name} ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.oi_parse_proc.restype = ctypes.POINTER(ctypes.c_double)
    lib.oi_parse_proc.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.oi_free.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.oi_free.restype = None
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.oi_radius_count.argtypes = [f64p, ctypes.c_int64, f64p, ctypes.c_int64,
                                    ctypes.c_double, i64p]
    lib.oi_radius_count.restype = None
    lib.oi_radius_fill.argtypes = [f64p, ctypes.c_int64, f64p, ctypes.c_int64,
                                   ctypes.c_double, i64p, i64p]
    lib.oi_radius_fill.restype = None
    return lib


def parse_proc(path: str) -> np.ndarray:
    """Parse a .proc numeric text table to (rows, cols) float64. Non-numeric
    tokens become NaN; a ragged, empty or unreadable file raises."""
    lib = _library()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    ptr = lib.oi_parse_proc(os.fsencode(path), ctypes.byref(rows), ctypes.byref(cols))
    if not ptr:
        raise RuntimeError(f"native parse failed for {path} (unreadable, empty or ragged)")
    try:
        n = rows.value * cols.value
        return np.ctypeslib.as_array(ptr, shape=(n,)).reshape(rows.value, cols.value).copy()
    finally:
        lib.oi_free(ptr)


def radius_neighbors(points_xy: np.ndarray, cells_xy: np.ndarray,
                     radius: float) -> tuple[np.ndarray, np.ndarray]:
    """CSR fixed-radius neighbors: ``(offsets (M+1,), indices (total,))``,
    every point within ``radius`` (inclusive) of each cell, ascending."""
    lib = _library()
    pts = np.ascontiguousarray(points_xy, dtype=np.float64).reshape(-1, 2)
    cells = np.ascontiguousarray(cells_xy, dtype=np.float64).reshape(-1, 2)
    n, m = len(pts), len(cells)
    counts = np.empty(m, dtype=np.int64)
    lib.oi_radius_count(pts, n, cells, m, float(radius), counts)
    offsets = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    out = np.empty(int(offsets[-1]), dtype=np.int64)
    lib.oi_radius_fill(pts, n, cells, m, float(radius), offsets, out)
    return offsets, out
