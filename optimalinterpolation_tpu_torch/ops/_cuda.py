"""Build, load and launch the port's hand-written CUDA kernels (``csrc/``).

The kernels (K1 ``csrc/k1_factor_invert.cu``, K2 ``csrc/k2_predict.cu``, K3
``csrc/k3_nll_grad.cu``) have a plain C interface. They are compiled with
``nvcc`` for ``sm_90a``, one ``nvcc`` per source and all at once, and linked
into one shared library under ``csrc/_build/`` at first use, keyed by a hash
of the sources and flags, and loaded with ``ctypes``. Nothing here runs at import:
the CPU tests import every module on a machine without ``nvcc``.

Every C entry takes its tensors as raw device pointers, then the device index
and PyTorch's current stream, and returns ``cudaGetLastError()`` after the
launch; :func:`launch` raises if that is not 0. The C entries set the device
on the calling thread, and the first use is safe from several threads at
once (cell sharding, ``parallel.mesh``): one lock guards the build and load.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["build", "check", "launch", "load"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
SOURCES = ("k1_factor_invert.cu", "k2_predict.cu", "k3_nll_grad.cu")
HEADERS = ("factor_invert.cuh", "gp_common.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Every pointer and the stream as c_void_p: ctypes would cut them to 32 bits.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRIES = {
    # d, l, w, logdet, ok, b, device, stream
    "oi_k1_factor_invert": (_P, _P, _P, _P, _P, _I, _I, _P),
    # log_hypers, x, y, xstar, mask, mean, a_scr, w_scr, out, b, n, kind,
    # jitter, device, stream
    "oi_k2_predict": (_P,) * 9 + (_I, _I, _I, _F, _I, _P),
    # log_hypers, x, y, mask, a_scr, u_scr, w_scr, nll, grad, b, n, kind,
    # jitter, with_grad, device, stream
    "oi_k3_nll": (_P,) * 9 + (_I, _I, _I, _F, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``csrc/_build/liboi_kernels_<hash>.so``
    unless a library for these sources and flags exists; returns its path.
    ``nvcc``'s output (with ``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside it as ``<name>.log``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        digest.update(name.encode())
        digest.update((CSRC / name).read_bytes())
    lib = BUILD_DIR / f"liboi_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]  # waits for every compile
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        for s, p, out in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{out}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
        lib.with_suffix(".log").write_text("".join(logs) + link.stdout + link.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    return lib


_LOAD_LOCK = threading.Lock()
_LOADED: list = []  # the loaded library, once


def load() -> ctypes.CDLL:
    """The kernels' library, built (:func:`build`) and loaded at the first
    call; later calls, from any thread, return the same one."""
    with _LOAD_LOCK:
        if not _LOADED:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.oi_error_string.argtypes = [ctypes.c_int]
            lib.oi_error_string.restype = ctypes.c_char_p
            _LOADED.append(lib)
        return _LOADED[0]


def check(t: torch.Tensor, name: str, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: kernel needs float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: kernel needs a contiguous tensor")


def launch(entry: str, device: torch.device, *args) -> int:
    """Call C entry ``entry`` with ``args`` (tensors passed as device
    pointers), then the device index and the current stream; raise on a
    launch error. Returns the stream (``cudaStream_t`` as an int)."""
    lib = load()
    # a tensor goes as its device pointer; None is a null pointer
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(lib, entry)(*conv, device.index, stream)
    if err != 0:
        msg = lib.oi_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err} ({msg})")
    return stream
