"""Helpers shared by the port's tools and ``chip_smoke.py``: packed words
made on the device from a seeded generator, kernel timers and each
kernel's least time on an NVIDIA H100 (its bound)."""

from __future__ import annotations

import time

import numpy as np
import torch

from gvamp_tpu_torch.ops.study import STREAM_TM

# columns of words drawn per step: a single randint over a whole matrix of
# several GB would need several times that in temporaries
WORDS_CHUNK = 4096


def random_words(gen: torch.Generator, nw: int, m: int,
                 device="cuda") -> torch.Tensor:
    """Uniformly random int32 words [nw, m] (every 2-bit code equally
    likely, so a quarter of the calls are missing), drawn WORDS_CHUNK
    columns at a time from ``gen``."""
    words = torch.empty((nw, m), dtype=torch.int32, device=device)
    for c in range(0, m, WORDS_CHUNK):
        w = min(WORDS_CHUNK, m - c)
        words[:, c:c + w] = torch.randint(-2**31, 2**31, (nw, w),
                                          dtype=torch.int32, generator=gen,
                                          device=device)
    return words


def complete_words(words: torch.Tensor, keep: torch.Tensor | None = None):
    """Every missing code 01 remapped to 11 (``tools/bench_gram.py:23-33``),
    except where ``keep`` has a 1 in the code's low bit."""
    lo = words & 0x55555555
    hi = (words >> 1) & 0x55555555
    is01 = lo & ~hi
    if keep is not None:
        is01 = is01 & ~keep
    return words | (is01 << 1)


def synth_words(gen: torch.Generator, miss: bool, n: int, m: int,
                device="cuda") -> torch.Tensor:
    """Words of N=n x M=m on ``device`` with the recipe of bench.py:45-86,
    WORDS_CHUNK columns at a time: random codes with every "01" (missing)
    remapped to "11", except that with ``miss`` the AND of four more random
    bit-streams keeps one in sixteen of them, so about 1.56% of the calls
    stay missing (configs Bm and Xm)."""
    from gvamp_tpu_torch.ops.layout import PlanarLayout
    nw = PlanarLayout.create(n).n_words
    words = torch.empty((nw, m), dtype=torch.int32, device=device)
    for c in range(0, m, WORDS_CHUNK):
        w = min(WORDS_CHUNK, m - c)
        raw = random_words(gen, nw, w, device)
        keep = None
        if miss:
            keep = torch.full_like(raw, 0x55555555)
            for _ in range(4):
                keep &= random_words(gen, nw, w, device)
        words[:, c:c + w] = complete_words(raw, keep)
    if words.device.type == "cuda":
        torch.cuda.synchronize()
    return words


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after a
    warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cpu_ms(fn, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` over ``reps`` calls, after a
    warm-up: cuda_ms's twin for tensors on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def timer(device):
    """cuda_ms for a CUDA device, else cpu_ms."""
    return cuda_ms if torch.device(device).type == "cuda" else cpu_ms


def smi(fields: str = "name,power.limit", index: int = 0) -> str:
    """``nvidia-smi --query-gpu=FIELDS --format=csv,noheader``'s line for
    card ``index``; raises if nvidia-smi fails."""
    import subprocess
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=30).stdout.strip().splitlines()[index]


def card_line(device) -> str:
    """The card's name, power limit and current SM and memory clocks as
    nvidia-smi reports them, or the CPU's name for a CPU device."""
    if torch.device(device).type != "cuda":
        return "device cpu"
    import subprocess
    fields = "name,power.limit,clocks.sm,clocks.mem"
    try:
        line = smi(fields, torch.device(device).index or 0)
    except (OSError, IndexError, subprocess.SubprocessError):
        line = "unavailable"
    return (f"device {torch.cuda.get_device_name(device)}; nvidia-smi "
            f"{fields.replace(',', ', ')}: {line}")


def need_device(device, tool: str) -> torch.device:
    """``device`` as a torch.device; raises SystemExit for CUDA without a
    card (the tools run on the card unless asked for the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device; pass --device cpu to run "
                         f"the plain versions on the CPU")
    return dev


# the card's published peaks (NVIDIA H100 SXM data sheet, dense, at 700 W):
# HBM bytes/s, int8 tensor-core ops/s, bf16 tensor-core ops/s, float32
# ops/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
# digit contractions per kernel (planes x sides), each 2 N M D int8 ops
INT8_CONTRACTIONS = {"axm_i8a": 1, "atxm_i8a": 1, "axm_i8": 2, "atxm_i8": 2,
                     "axm_i8s": 2, "gram_aat_i8a": 2, "gram_aat_i8": 4,
                     "gram_i8a": 2, "gram_i8": 4}
# bf16-split products: planes x 3 parts, each 2 N M B bf16 ops
BF16_PRODUCTS = {"axm_bf16": 2 * 3, "atxm_bf16": 2 * 3}
# f32 single-vector products: planes, each 2 N M f32 ops
F32_PLANES = {"atx": 2, "ax": 2, "atx_a": 1}
# the study kernels of ops/study.py that sum the words or their decode,
# charged by bytes alone (an integer-operation count written before the
# SASS is known could overstate the least time)
STUDY_KERNELS = ("stream", "stream_sum", "v0_stream", "v1_decode_a",
                 "v2_decode_ab", "v3_bitcast")
# the study kernels of ops/study.py that compute a library kernel's
# contract, charged as that kernel: the words (v7: the byte rows, the same
# 4 Nw Mpad bytes), the f32 columns in and out, and its int8 digit
# contractions
STUDY_PRODUCTS = {"v5_dot1": "axm_i8a", "v6_fused_ab": "axm_i8s",
                  "v7_i8decode": "axm_i8a", "v8_atxm_vt": "atxm_i8a",
                  "v7_i8decode_round2": "axm_i8a"}


def bound(name: str, nw: int, m: int, B: int):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one call on Nw x Mpad words at width B, the larger of the bytes it
    must move (the words, each f32 input and each f32 output once) over the
    HBM rate and its operations over the peak rate of their type: 2 N M D
    int8 operations per digit contraction (D = 4 B digit rows), 2 N M B
    bf16 operations per plane and part of the bf16-split products, or
    2 N M f32 operations per plane of the single-vector ones.  The study
    kernels of STUDY_KERNELS move the words and their int32 output (Nw x
    STREAM_TM for ``stream``, 4 Nw for ``v3_bitcast``, Nw for the other row
    sums) and are charged by bytes only; those of STUDY_PRODUCTS as the
    library kernel of their contract.  The statistics pass's count kernel
    (``marker_counts``) moves the words, a mask word per row and its
    int32[3, Mpad] counts, and is charged by bytes."""
    if name == "marker_counts":
        return 1e3 * (4 * nw * m + 4 * nw + 12 * m) / HBM_BYTES_PER_S, "bytes"
    if name in STUDY_KERNELS:
        out = 4 * nw * {"stream": STREAM_TM, "v3_bitcast": 4}.get(name, 1)
        return 1e3 * (4 * nw * m + out) / HBM_BYTES_PER_S, "bytes"
    name = STUDY_PRODUCTS.get(name, name)
    n = 16 * nw
    vec_n, vec_m = 4 * n, 4 * m  # f32 bytes of one column in N / in M
    io = {"axm_i8a": (vec_m + vec_n) * B, "atxm_i8a": (vec_n + vec_m) * B,
          "axm_i8": (2 * vec_m + vec_n) * B,
          "atxm_i8": (vec_n + 2 * vec_m) * B,
          "axm_i8s": (2 * vec_m + vec_n) * B,
          "axm_bf16": (2 * vec_m + vec_n) * B,
          "atxm_bf16": (vec_n + 2 * vec_m) * B,
          "atx": vec_n + 2 * vec_m, "ax": 2 * vec_m + vec_n,
          "atx_a": vec_n + vec_m,
          "gram_aat_i8a": 2 * vec_n * B + 2 * vec_m,
          "gram_aat_i8": 2 * vec_n * B + 2 * vec_m,
          "gram_i8a": 2 * vec_m * B + vec_n + 8 * B,
          "gram_i8": 4 * vec_m * B + vec_n}[name]
    t_bytes = (4 * nw * m + io) / HBM_BYTES_PER_S
    if name in INT8_CONTRACTIONS:
        t_ops = 2 * n * m * 4 * B * INT8_CONTRACTIONS[name] / INT8_OPS_PER_S
    elif name in BF16_PRODUCTS:
        t_ops = 2 * n * m * B * BF16_PRODUCTS[name] / BF16_OPS_PER_S
    else:
        t_ops = 2 * n * m * F32_PLANES[name] / F32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")
