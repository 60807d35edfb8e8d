"""Study kernels of the PyTorch port: the rungs of the stream-ceiling ladder
between "read the packed words" and the product kernels, with their plain
PyTorch versions and the wrappers of the hand-written CUDA kernels
(``csrc/study.cu``).

Counterparts of the Pallas kernels of the JAX package's study tools, run
by ``gvamp_tpu_torch/tools/bench_stream.py`` and ``bench_variants.py``:

* ``stream``       int32[Nw, tm]: out[r, c] = sum_j words[r, j*tm + c]
  (replaces ``stream``, ``tools/bench_stream.py:33``)
* ``stream_sum``   int32[1, Nw]: each word row's sum (replaces
  ``stream_sum``, ``tools/bench_stream.py:59``)
* ``v0_stream``    the same function at bench_variants' one launch
  configuration, the rung "stream only" (replaces ``v0_stream``,
  ``tools/bench_variants.py:78``)
* ``v1_decode_a``  int32[1, Nw]: per row, the sum over markers of the
  SWAR a-plane decode of all four bit pairs added as u32 byte lanes
  (replaces ``v1_decode_a``, ``tools/bench_variants.py:103``)

Every sum wraps mod 2**32, as the int32 sums of the JAX kernels do, so a
kernel equals its plain version bit for bit whatever its launch
configuration.  Unlike the JAX kernels, whose grids drop the rows and
columns past the last full 256 x 512 tile, these sum every row for any Nw
and Mpad (``stream`` needs tm to divide Mpad).  The TPU kernels' tile
arguments (``tnw``, ``sem``) have no counterpart; the CUDA kernels take the
threads per block and the bytes per load instead, which change only the
time.

As in ``ops/matvec.py``, a wrapper takes its plain version only for a
tensor on the CPU; for a CUDA tensor it launches its kernel or raises, and
each launch adds one to ``matvec.LAUNCHES``.
"""

from __future__ import annotations

import torch

from gvamp_tpu_torch.ops import matvec

# the output width of stream (the JAX default tile, tm=512)
STREAM_TM = 512
# the launch configurations of bench_stream's sweep
THREADS = (128, 256, 512, 1024)
LOAD_BYTES = (4, 8, 16)
# the one launch configuration of bench_variants' rungs (v0_stream,
# v1_decode_a) and the default of stream / stream_sum
VARIANT_THREADS, VARIANT_LOAD_BYTES = 256, 16
# marker columns the plain v1_decode_a decodes per step: bounds its int32
# temporaries to a few hundred MB at Nw=20,480
_REF_COLS = 4096


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with the low 32 bits (x mod 2**32 read as int32)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def stream_ref(words: torch.Tensor, tm: int = STREAM_TM) -> torch.Tensor:
    nw, m = words.shape
    _check_tm(m, tm)
    return words.view(nw, m // tm, tm).sum(1, dtype=torch.int32)


def stream_sum_ref(words: torch.Tensor) -> torch.Tensor:
    return words.sum(1, dtype=torch.int32).view(1, words.shape[0])


v0_stream_ref = stream_sum_ref


def v1_decode_a_ref(words: torch.Tensor) -> torch.Tensor:
    """Sum over markers of sum_k _swar(w, k)[0] (u32 byte lanes, each at
    most 8, so no lane carries), mod 2**32, decoded _REF_COLS columns at a
    time.  A word's four planes sum to at most 0x08080808, exact in int32;
    the sum over markers is exact in int64."""
    nw, m = words.shape
    tot = torch.zeros(nw, dtype=torch.int64, device=words.device)
    for c in range(0, m, _REF_COLS):
        w = words[:, c:c + _REF_COLS]
        acc = sum(matvec._swar(w, k)[0] for k in range(4))
        tot += acc.sum(1, dtype=torch.int64)
    return _wrap_i32(tot).view(1, nw)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------


def _check_tm(m: int, tm: int) -> None:
    if tm <= 0 or m % tm:
        raise ValueError(f"stream: tm={tm} must divide Mpad={m}")


def _check_launch(name: str, words: torch.Tensor, threads: int,
                  load_bytes: int) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if words.device.type != "cuda":
        raise ValueError(f"{name}: words on {words.device}; the kernel runs "
                         f"on CUDA tensors only")
    if words.dtype != torch.int32 or words.ndim != 2:
        raise ValueError(f"{name}: words must be int32[Nw, Mpad], got "
                         f"{words.dtype}{list(words.shape)}")
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError(f"{name}: words must be contiguous and 16-byte "
                         f"aligned")
    if threads not in range(32, 1025, 32):
        raise ValueError(f"{name}: threads={threads} must be a multiple of "
                         f"32 up to 1024")
    if load_bytes not in LOAD_BYTES:
        raise ValueError(f"{name}: load_bytes={load_bytes} must be one of "
                         f"{LOAD_BYTES}")
    if words.shape[1] % (load_bytes // 4):
        raise ValueError(f"{name}: Mpad={words.shape[1]} must be a multiple "
                         f"of {load_bytes // 4} words for {load_bytes}-byte "
                         f"loads")


def stream(words: torch.Tensor, tm: int = STREAM_TM,
           threads: int = VARIANT_THREADS,
           load_bytes: int = VARIANT_LOAD_BYTES) -> torch.Tensor:
    """int32[Nw, tm]: out[r, c] = sum_j words[r, j*tm + c], wrapping."""
    if words.device.type == "cpu":
        return stream_ref(words, tm)
    _check_launch("stream", words, threads, load_bytes)
    nw, m = words.shape
    _check_tm(m, tm)
    if tm % (load_bytes // 4):
        raise ValueError(f"stream: tm={tm} must be a multiple of "
                         f"{load_bytes // 4} for {load_bytes}-byte loads")
    out = torch.zeros((nw, tm), dtype=torch.int32, device=words.device)
    if words.numel():
        from gvamp_tpu_torch.ops import _build
        matvec._launch("stream", _build.library().gvamp_study_stream,
                       words.device, words.data_ptr(), out.data_ptr(), nw, m,
                       tm, threads, load_bytes)
    return out


def _row_sum(name: str, fn_name: str, words: torch.Tensor, threads: int,
             load_bytes: int) -> torch.Tensor:
    _check_launch(name, words, threads, load_bytes)
    nw, m = words.shape
    out = torch.zeros((1, nw), dtype=torch.int32, device=words.device)
    if words.numel():
        from gvamp_tpu_torch.ops import _build
        matvec._launch(name, getattr(_build.library(), fn_name), words.device,
                       words.data_ptr(), out.data_ptr(), nw, m, threads,
                       load_bytes)
    return out


def stream_sum(words: torch.Tensor, threads: int = VARIANT_THREADS,
               load_bytes: int = VARIANT_LOAD_BYTES) -> torch.Tensor:
    """int32[1, Nw]: each word row's sum, wrapping."""
    if words.device.type == "cpu":
        return stream_sum_ref(words)
    return _row_sum("stream_sum", "gvamp_study_stream_sum", words, threads,
                    load_bytes)


def v0_stream(words: torch.Tensor) -> torch.Tensor:
    """stream_sum at bench_variants' launch configuration (its own name and
    launch count; the same CUDA kernel)."""
    if words.device.type == "cpu":
        return v0_stream_ref(words)
    return _row_sum("v0_stream", "gvamp_study_stream_sum", words,
                    VARIANT_THREADS, VARIANT_LOAD_BYTES)


def v1_decode_a(words: torch.Tensor) -> torch.Tensor:
    """int32[1, Nw]: per row, the wrapping sum over markers of the a-plane
    decode of all four bit pairs, through the engine kernels' swar_a."""
    if words.device.type == "cpu":
        return v1_decode_a_ref(words)
    return _row_sum("v1_decode_a", "gvamp_study_v1_decode_a", words,
                    VARIANT_THREADS, VARIANT_LOAD_BYTES)
