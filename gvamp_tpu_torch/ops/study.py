"""Study kernels of the PyTorch port: the rungs of the kernel-variant
ladder between "read the packed words" and the product kernels, with their
plain PyTorch versions and the wrappers of the hand-written CUDA kernels
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
* ``v2_decode_ab`` int32[1, Nw]: the same with the a- and b-plane decodes
  added (each byte lane at most 12; replaces ``v2_decode_ab``,
  ``tools/bench_variants.py:126``)
* ``v3_bitcast``   int32[1, 4*Nw]: per byte row 4i+b, the sum over markers
  of byte b of word row i's a-decode (replaces ``v3_bitcast``,
  ``tools/bench_variants.py:152``)
* ``v5_dot1``      A_a @ W -> f32[4, Nb, B], ``axm_i8a``'s contract, with
  the four decoded planes staged in shared memory and one tensor-core
  contraction per tile (replaces ``v5_dot1``,
  ``tools/bench_variants.py:179``)
* ``v6_fused_ab``  A_a @ W - A_b @ U -> f32[4, Nb, B], ``axm_i8s``'s
  contract (W and -U under one joint digit scale), [a8 | b8] against
  [w8; -u8] in one K-concatenated contraction (replaces ``v6_fused_ab``,
  ``tools/bench_variants.py:215``, as intended: that wrapper lays the
  right-hand side out marker by marker, so its a and b columns meet the
  wrong rows); on the card ``csrc/fused_ab.cu``: the words through a ring
  of bulk copies into shared memory, both planes decoded in registers as
  the A operand of one wgmma chain per 32 markers, every digit row (up to
  256) in one read of the words, the digits laid out by
  ``fused_ab_digits``
* ``v7_i8decode``  A_a @ W -> f32[4, Nb, B], ``axm_i8a``'s contract, from
  the words pre-expanded to byte rows int8[4*Nw, Mpad] (``expand_words``),
  tensor-core fragments taken straight from the SWAR decode of each byte
  row, with no staging and no byte transpose (replaces ``v7_i8decode``,
  ``tools/bench_variants.py:296``; ``v7_i8decode_round2`` is the same
  kernel under its own launch count, for the same body at
  ``tools/bench_round2.py:102``)
* ``v8_atxm_vt``   A_a^T @ V -> f32[Mpad, B], ``atxm_i8a``'s contract, the
  contraction over people with V's digits transposed to [4, D, 4*Nw] and
  the fragments taken straight from the decoded words (replaces
  ``v8_atxm_vt``, ``tools/bench_round2.py:58``)

Every row sum wraps mod 2**32, as the int32 sums of the JAX kernels do, so
a kernel equals its plain version bit for bit whatever its launch
configuration.  The products share the quantisation and the fold with
their plain versions, which are ``matvec.axm_i8a_ref`` (v5, and v7 on the
words its bytes came from), ``matvec.axm_i8s_ref`` (v6) and
``matvec.atxm_i8a_ref`` (v8), and contract exactly in int32: bit for bit
too, and on the card equal to ``axm_i8a`` / ``atxm_i8a`` themselves.
Unlike the JAX kernels, whose grids drop the rows and columns past the
last full 256 x 512 tile, these cover every row for any Nw and Mpad
(``stream`` needs tm to divide Mpad, the products Mpad a multiple of 4).
The TPU kernels' tile arguments (``tnw``, ``sem``) have no counterpart;
``stream`` and ``stream_sum`` take the threads per block and the bytes per
load instead (bench_stream's sweep), which change only the time, and the
ladder's row sums run at one launch configuration.

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
# the one launch configuration of the ladder's row-sum rungs (v0_stream to
# v3_bitcast) and the default of stream / stream_sum
VARIANT_THREADS, VARIANT_LOAD_BYTES = 256, 16
# marker columns the plain decodes take per step: bounds their int32
# temporaries to a few hundred MB (v3_bitcast: 1.3 GB) at Nw=20,480
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


def _decoded_sums(words: torch.Tensor, with_b: bool,
                  byte_rows: bool) -> torch.Tensor:
    """int64[1, Nw] sums over markers of sum_k _swar(w, k)[0] (plus [1]
    when ``with_b``) per word row, or int64[1, 4*Nw] per byte row 4i+b when
    ``byte_rows``, decoded _REF_COLS columns at a time.  A word's four
    planes sum to at most 0x0C0C0C0C, exact in int32."""
    nw, m = words.shape
    tot = torch.zeros(nw * (4 if byte_rows else 1), dtype=torch.int64,
                      device=words.device)
    for c in range(0, m, _REF_COLS):
        w = words[:, c:c + _REF_COLS]
        acc = sum(sum(matvec._swar(w, k)) if with_b else matvec._swar(w, k)[0]
                  for k in range(4))
        if byte_rows:
            acc = matvec._bytes_to_rows(acc)
        tot += acc.sum(1, dtype=torch.int64)
    return tot.view(1, tot.numel())


def v1_decode_a_ref(words: torch.Tensor) -> torch.Tensor:
    """Sum over markers of sum_k _swar(w, k)[0] (u32 byte lanes, each at
    most 8, so no lane carries), mod 2**32."""
    return _wrap_i32(_decoded_sums(words, False, False))


def v2_decode_ab_ref(words: torch.Tensor) -> torch.Tensor:
    """Sum over markers of sum_k (a + b) of _swar(w, k) (u32 byte lanes,
    each at most 12), mod 2**32."""
    return _wrap_i32(_decoded_sums(words, True, False))


def v3_bitcast_ref(words: torch.Tensor) -> torch.Tensor:
    """int32[1, 4*Nw]: per byte row 4i+b, the sum over markers of byte b of
    sum_k _swar(w, k)[0] (at most 8 per marker; wrapped as the kernel's)."""
    return _wrap_i32(_decoded_sums(words, False, True))


# the same function, arithmetic and fold as the library kernels of their
# contracts: the plain versions are theirs
v5_dot1_ref = matvec.axm_i8a_ref
v6_fused_ab_ref = matvec.axm_i8s_ref
v8_atxm_vt_ref = matvec.atxm_i8a_ref


def expand_words(words: torch.Tensor) -> torch.Tensor:
    """int32[Nw, Mpad] words -> int8[4*Nw, Mpad] byte rows: row 4i+b is
    byte b of word row i (``tools/bench_round2.py``'s ``expand_words``),
    contiguous (at Nw = 1 the reshape alone would be a strided view)."""
    nw, m = words.shape
    return (words.contiguous().view(torch.int8).view(nw, m, 4)
            .permute(0, 2, 1).reshape(4 * nw, m).contiguous())


def collapse_bytes(bytes8: torch.Tensor) -> torch.Tensor:
    """The inverse of ``expand_words``: int8[4*Nw, Mpad] -> int32[Nw,
    Mpad]."""
    n8, m = bytes8.shape
    return (bytes8.view(n8 // 4, 4, m).permute(0, 2, 1).contiguous()
            .view(torch.int32).view(n8 // 4, m))


def v7_i8decode_ref(bytes8: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``axm_i8a_ref`` on the words the byte rows came from."""
    return matvec.axm_i8a_ref(collapse_bytes(bytes8), W)


v7_i8decode_round2_ref = v7_i8decode_ref


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
             load_bytes: int, lanes: int = 1) -> torch.Tensor:
    _check_launch(name, words, threads, load_bytes)
    nw, m = words.shape
    out = torch.zeros((1, lanes * nw), dtype=torch.int32, device=words.device)
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


def v2_decode_ab(words: torch.Tensor) -> torch.Tensor:
    """int32[1, Nw]: per row, the wrapping sum over markers of the a- and
    b-plane decodes of all four bit pairs (swar_a + swar_b)."""
    if words.device.type == "cpu":
        return v2_decode_ab_ref(words)
    return _row_sum("v2_decode_ab", "gvamp_study_v2_decode_ab", words,
                    VARIANT_THREADS, VARIANT_LOAD_BYTES)


def v3_bitcast(words: torch.Tensor) -> torch.Tensor:
    """int32[1, 4*Nw]: out[4i+b] = the sum over markers of byte b of word
    row i's a-plane decode (all four bit pairs)."""
    if words.device.type == "cpu":
        return v3_bitcast_ref(words)
    return _row_sum("v3_bitcast", "gvamp_study_v3_bitcast", words,
                    VARIANT_THREADS, VARIANT_LOAD_BYTES, lanes=4)


def v5_dot1(words: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A_a @ W -> f32[4, Nb, B] (axm_i8a's contract), the decoded planes
    staged in shared memory and contracted on the tensor cores; any B in
    one launch (the grid's z axis takes the digit rows eight at a time)."""
    if words.device.type == "cpu":
        return v5_dot1_ref(words, W)
    matvec._check_cuda("v5_dot1", words, W, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m:
        raise ValueError(f"v5_dot1: W must be [{m}, B], got {list(W.shape)}")
    matvec._check_bound("v5_dot1", m)
    w8t, ws = matvec._quant_rows(W)
    D = w8t.shape[0]
    zt = torch.zeros((D, 4, 4 * nw), dtype=torch.int32, device=words.device)
    if words.numel() and D:
        from gvamp_tpu_torch.ops import _build
        matvec._launch("v5_dot1", _build.library().gvamp_study_v5_dot1,
                       words.device, words.data_ptr(), w8t.data_ptr(),
                       zt.data_ptr(), nw, m, D)
    return matvec._fold_digits_zt(zt, ws, W.shape[1])


# v6_fused_ab's digit groups: the widths N of its kernel (csrc/fused_ab.cu,
# Fab<N>), D rounded up to the next, groups of the widest past it
FUSED_AB_N = (8, 16, 32, 64, 128, 256)


def fused_ab_n(D: int) -> int:
    """The digit group's width for D digit rows (fused_ab.cu's
    fused_ab_n)."""
    return next((n for n in FUSED_AB_N if n >= D), FUSED_AB_N[-1])


def fused_ab_kt(n: int) -> int:
    """Markers per word tile at group width ``n`` (fused_ab.cu's
    fused_ab_kt): 256, or 128 beyond n = 64, so that the stages of the
    ring, each with its digits (2 Kt n bytes), fit in shared memory."""
    return 256 if n <= 64 else 128


def fused_ab_digits(w8t: torch.Tensor, mu8t: torch.Tensor, n: int,
                    kt: int) -> torch.Tensor:
    """The digit rows of W and of -U (int8[D, Mpad] each) as fused_ab.cu
    reads them: int8[groups, tiles, 2, kt/16, n/8, 8, 16].  Each (group,
    tile) is one contiguous block, one bulk copy, and each type of it (w8,
    mu8) lies in wgmma's K-major core matrices: [16-marker chunk][group of
    8 digit rows][8 digit rows][16 markers].  Group z holds digit rows
    z n .. z n + n - 1, tile j markers j kt .. j kt + kt - 1; every entry
    past D or past Mpad is zero."""
    D, m = w8t.shape
    groups, tiles = -(-D // n), -(-m // kt)
    x = torch.zeros((2, groups * n, tiles * kt), dtype=torch.int8,
                    device=w8t.device)
    x[0, :D, :m] = w8t
    x[1, :D, :m] = mu8t
    x = x.view(2, groups, n // 8, 8, tiles, kt // 16, 16)
    return x.permute(1, 4, 0, 5, 2, 3, 6).contiguous()


def v6_fused_ab(words: torch.Tensor, W: torch.Tensor,
                U: torch.Tensor) -> torch.Tensor:
    """A_a @ W - A_b @ U -> f32[4, Nb, B] (axm_i8s's contract: W and -U
    quantised at one joint scale per column, one int32 sum, one fold),
    [a8 | b8] against [w8; -u8] in one wgmma chain; every digit row up to
    256 in one read of the words (groups of 256 over the grid beyond)."""
    if words.device.type == "cpu":
        return v6_fused_ab_ref(words, W, U)
    matvec._check_cuda("v6_fused_ab", words, W, torch.float32)
    matvec._check_cuda("v6_fused_ab", words, U, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m or U.shape != W.shape:
        raise ValueError(f"v6_fused_ab: W and U must be [{m}, B], got "
                         f"{list(W.shape)} and {list(U.shape)}")
    matvec._check_bound("v6_fused_ab", m, 381)
    w8t, mu8t, ws = matvec._quant_digits_pair(W, U)
    D = w8t.shape[0]
    zt = torch.zeros((D, 4, 4 * nw), dtype=torch.int32, device=words.device)
    if words.numel() and D:
        n = fused_ab_n(D)
        kt = fused_ab_kt(n)
        dig = fused_ab_digits(w8t, mu8t, n, kt)
        from gvamp_tpu_torch.ops import _build
        matvec._launch("v6_fused_ab", _build.library().gvamp_fused_ab,
                       words.device, words.data_ptr(), dig.data_ptr(),
                       zt.data_ptr(), nw, m, D, n, kt)
    return matvec._fold_digits_zt(zt, ws, W.shape[1])


def _i8decode(name: str, bytes8: torch.Tensor,
              W: torch.Tensor) -> torch.Tensor:
    """A_a @ W from the byte rows through i8decode_kernel, counted under
    ``name`` (the JAX package's two copies of v7_i8decode share the
    kernel)."""
    if bytes8.device.type == "cpu":
        return v7_i8decode_ref(bytes8, W)
    if bytes8.device.type != "cuda":
        raise ValueError(f"{name}: bytes on {bytes8.device}; the kernel runs "
                         f"on CUDA tensors only")
    if W.device != bytes8.device:
        raise ValueError(f"{name}: operands on {bytes8.device} and "
                         f"{W.device}")
    if bytes8.dtype != torch.int8 or bytes8.ndim != 2 or bytes8.shape[0] % 4:
        raise ValueError(f"{name}: bytes must be int8[4*Nw, Mpad], got "
                         f"{bytes8.dtype}{list(bytes8.shape)}")
    if W.dtype != torch.float32:
        raise ValueError(f"{name}: W must be torch.float32, got {W.dtype}")
    if not bytes8.is_contiguous() or bytes8.data_ptr() % 16:
        raise ValueError(f"{name}: bytes must be contiguous and 16-byte "
                         f"aligned")
    n8, m = bytes8.shape
    if m % 4:
        raise ValueError(f"{name}: Mpad={m} must be a multiple of 4")
    if W.ndim != 2 or W.shape[0] != m:
        raise ValueError(f"{name}: W must be [{m}, B], got {list(W.shape)}")
    matvec._check_bound(name, m)
    w8t, ws = matvec._quant_rows(W)
    D = w8t.shape[0]
    zt = torch.zeros((D, 4, n8), dtype=torch.int32, device=bytes8.device)
    if n8 and m and D:
        from gvamp_tpu_torch.ops import _build
        matvec._launch(name, _build.library().gvamp_study_i8decode,
                       bytes8.device, bytes8.data_ptr(), w8t.data_ptr(),
                       zt.data_ptr(), n8, m, D)
    return matvec._fold_digits_zt(zt, ws, W.shape[1])


def v7_i8decode(bytes8: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A_a @ W -> f32[4, Nb, B] (axm_i8a's contract) from the byte rows
    int8[4*Nw, Mpad] of ``expand_words``: each plane's tensor-core
    fragments are the SWAR decode of u32 loads of the byte rows, with no
    staging and no byte transpose; any B in one launch."""
    return _i8decode("v7_i8decode", bytes8, W)


def v7_i8decode_round2(bytes8: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``v7_i8decode`` for bench_round2, counted under its own name."""
    return _i8decode("v7_i8decode_round2", bytes8, W)


def v8_atxm_vt(words: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """A_a^T @ V -> f32[Mpad, B] (atxm_i8a's contract), contracted over
    people against V's digits transposed to [4, D, 4*Nw]: each plane's
    fragments are the SWAR decode of the words (markers as the mma's m) and
    u32 loads of the digits; any B in one launch."""
    if words.device.type == "cpu":
        return v8_atxm_vt_ref(words, V)
    matvec._check_cuda("v8_atxm_vt", words, V, torch.float32)
    nw, m = words.shape
    if V.ndim != 3 or V.shape[:2] != (4, 4 * nw):
        raise ValueError(f"v8_atxm_vt: V must be [4, {4 * nw}, B], got "
                         f"{list(V.shape)}")
    matvec._check_bound("v8_atxm_vt", 16 * nw)
    v8, s0 = matvec._quant_digits_t(V)
    D = v8.shape[1]
    av = torch.zeros((D, m), dtype=torch.int32, device=words.device)
    if words.numel() and D:
        from gvamp_tpu_torch.ops import _build
        matvec._launch("v8_atxm_vt", _build.library().gvamp_study_v8_atxm_vt,
                       words.device, words.data_ptr(), v8.data_ptr(),
                       av.data_ptr(), nw, m, D)
    return matvec._fold_digits_t(av, s0, V.shape[2])
