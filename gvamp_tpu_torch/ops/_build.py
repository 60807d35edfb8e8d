"""Build and bind the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

The kernels (``gvamp_tpu_torch/csrc/*.cu``, with the headers beside them)
compile on first use into ``build/gvamp_tpu_torch/`` beside the package,
under a file name keyed by a hash of every file under ``csrc/`` and of the
flags, so an edit rebuilds and an unchanged tree reuses the library.  Each
source compiles in its own ``nvcc``, all started together, and one more
links them; a file that includes no PyTorch header takes seconds.

Import this module only where a kernel is launched: the CPU tests import
every other module of the port and must never reach a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "gvamp_tpu_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# what the last build printed (ptxas register / shared-memory report) and
# how long it took; empty when the library came from an earlier build
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib = None


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, else PATH, else the toolkit's default
    install location; raises if there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the gvamp_tpu_torch CUDA kernels")


def source_hash(csrc: str = CSRC) -> str:
    """Hash of the nvcc flags and of every file under ``csrc`` (its path
    and bytes), headers included, so an edit to any of them rebuilds."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for root, dirs, names in os.walk(csrc):
        dirs.sort()
        for name in sorted(names):
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, csrc).encode() + b"\0")
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if no library for their hash exists; return its
    path."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    lib = os.path.join(BUILD_DIR, f"libgvamp_tpu_torch_{source_hash(CSRC)}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    # one nvcc per source, all started together, then one link
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(sources, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    link = [nvcc, "-shared", "-o", tmp, *objs]
    try:
        for cmd, p, out in zip(cmds, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed (exit {p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"{proc.stderr}")
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, lib)
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      command="; ".join(" ".join(c) for c in [*cmds, link]),
                      log="".join(outs) + proc.stdout + proc.stderr)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            vp, i64 = ctypes.c_void_p, ctypes.c_int64
            for name in ("gvamp_axm_i8a", "gvamp_atxm_i8a"):
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, vp, i64, i64, i64, vp]
                fn.restype = ctypes.c_int
            lib.gvamp_atxm_i8.argtypes = [vp, vp, vp, vp, i64, i64, i64, vp]
            lib.gvamp_atxm_i8.restype = ctypes.c_int
            lib.gvamp_axm_i8.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64,
                                         vp]
            lib.gvamp_axm_i8.restype = ctypes.c_int
            lib.gvamp_atx.argtypes = [vp, vp, vp, i64, i64, vp]
            lib.gvamp_atx.restype = ctypes.c_int
            lib.gvamp_atx_parts.argtypes = [i64, i64]
            lib.gvamp_atx_parts.restype = i64
            lib.gvamp_ax.argtypes = [vp, vp, vp, vp, i64, i64, vp]
            lib.gvamp_ax.restype = ctypes.c_int
            lib.gvamp_ax_parts.argtypes = [i64, i64]
            lib.gvamp_ax_parts.restype = i64
            for name in ("gvamp_gram_aat_stripe", "gvamp_gram_aat_group"):
                fn = getattr(lib, name)
                fn.argtypes = []
                fn.restype = ctypes.c_int
            lib.gvamp_gram_aat_smem.argtypes = [i64]
            lib.gvamp_gram_aat_smem.restype = i64
            lib.gvamp_gram_aat_i8a.argtypes = [vp] * 8 + [i64, i64, i64, vp]
            lib.gvamp_gram_aat_i8a.restype = ctypes.c_int
            lib.gvamp_gram_aat_i8.argtypes = [vp] * 6 + [i64, i64, i64, vp]
            lib.gvamp_gram_aat_i8.restype = ctypes.c_int
            lib.gvamp_gram_band_nw.argtypes = []
            lib.gvamp_gram_band_nw.restype = ctypes.c_int
            lib.gvamp_gram_smem.argtypes = [i64, i64]
            lib.gvamp_gram_smem.restype = i64
            lib.gvamp_gram_scratch_ints.argtypes = [i64]
            lib.gvamp_gram_scratch_ints.restype = i64
            lib.gvamp_gram_i8a.argtypes = [vp] * 8 + [i64] * 4 + [vp]
            lib.gvamp_gram_i8a.restype = ctypes.c_int
            lib.gvamp_gram_i8.argtypes = [vp] * 8 + [i64] * 4 + [vp]
            lib.gvamp_gram_i8.restype = ctypes.c_int
            lib.gvamp_marker_counts.argtypes = [vp, vp, vp, i64, i64, vp]
            lib.gvamp_marker_counts.restype = ctypes.c_int
            lib.gvamp_atx_a.argtypes = [vp, vp, vp, i64, i64, vp]
            lib.gvamp_atx_a.restype = ctypes.c_int
            lib.gvamp_axm_i8s.argtypes = [vp] * 4 + [i64] * 3 + [vp]
            lib.gvamp_axm_i8s.restype = ctypes.c_int
            for name in ("gvamp_axm_bf16_parts", "gvamp_atxm_bf16_parts"):
                fn = getattr(lib, name)
                fn.argtypes = [i64] * 3
                fn.restype = i64
            lib.gvamp_axm_bf16.argtypes = [vp] * 3 + [i64] * 3 + [vp]
            lib.gvamp_axm_bf16.restype = ctypes.c_int
            lib.gvamp_atxm_bf16.argtypes = [vp] * 3 + [i64] * 3 + [vp]
            lib.gvamp_atxm_bf16.restype = ctypes.c_int
            lib.gvamp_study_stream.argtypes = [vp, vp] + [i64] * 5 + [vp]
            lib.gvamp_study_stream.restype = ctypes.c_int
            for name in ("gvamp_study_stream_sum", "gvamp_study_v1_decode_a",
                         "gvamp_study_v2_decode_ab", "gvamp_study_v3_bitcast"):
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp] + [i64] * 4 + [vp]
                fn.restype = ctypes.c_int
            lib.gvamp_study_v5_dot1.argtypes = [vp] * 3 + [i64] * 3 + [vp]
            lib.gvamp_study_v5_dot1.restype = ctypes.c_int
            lib.gvamp_fused_ab.argtypes = [vp] * 3 + [i64] * 5 + [vp]
            lib.gvamp_fused_ab.restype = ctypes.c_int
            for name in ("gvamp_study_i8decode", "gvamp_study_v8_atxm_vt"):
                fn = getattr(lib, name)
                fn.argtypes = [vp] * 3 + [i64] * 3 + [vp]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
