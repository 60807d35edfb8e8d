"""ctypes bindings for the native (C++/OpenMP) .bed loader of the port.

``loader.cpp`` is the port's own copy of the JAX package's loader.  The
shared library is built lazily with the system g++ on first use into
``build/gvamp_tpu_torch/native/`` beside the package (a directory that
``.gitignore`` lists), under a file name keyed by a hash of the source and
flags; every entry point has a numpy fallback in the callers
(``gvamp_tpu_torch.io.plink``, ``gvamp_tpu_torch.data``), so environments
without a toolchain still work, they just load slower.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "gvamp_tpu_torch", "native")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgvamp_loader_{h.hexdigest()[:16]}.so")


def _build(lib: str) -> str | None:
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp]
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """The loaded library, building it if necessary; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        path = path if os.path.exists(path) else _build(path)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64, u8p, u32p, cch = (ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8),
                               ctypes.POINTER(ctypes.c_uint32), ctypes.c_char_p)
        lib.gvamp_bed_to_words.argtypes = [u8p, i64, i64, i64, u32p, i64, i64]
        lib.gvamp_bed_to_words.restype = ctypes.c_int
        lib.gvamp_read_bed_words.argtypes = [cch, i64, i64, i64, u32p, i64, i64]
        lib.gvamp_read_bed_words.restype = ctypes.c_int
        _lib = lib
        return _lib


def bed_to_words(bed_bytes: np.ndarray, N: int, n_words: int,
                 Mpad: int) -> np.ndarray | None:
    """uint8[M, mbytes] -> uint32[n_words, Mpad] planar word-major, or None
    if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bed = np.ascontiguousarray(bed_bytes, dtype=np.uint8)
    M, mbytes = bed.shape
    out = np.empty((n_words, Mpad), dtype=np.uint32)
    rc = lib.gvamp_bed_to_words(
        bed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), M, mbytes, N,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_words, Mpad)
    return out if rc == 0 else None


def read_bed_words(path: str, N: int, M: int, S: int, n_words: int,
                   Mpad: int) -> np.ndarray | None:
    """.bed slab [S, S+M) -> uint32[n_words, Mpad], or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n_words, Mpad), dtype=np.uint32)
    rc = lib.gvamp_read_bed_words(
        path.encode(), N, M, S,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n_words, Mpad)
    return out if rc == 0 else None
