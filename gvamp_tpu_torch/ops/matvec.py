"""Packed-genotype products of the PyTorch port: plain versions and the
wrappers of the hand-written CUDA kernels (``csrc/matvec.cu``).

Counterpart of ``gvamp_tpu/ops/matvec.py`` for the linear main path.  The
word layout is the same (word-major ``[Nw, Mpad]``, 16 samples per word,
planar N order, 0x55 padding), held as ``torch.int32`` with the bits of the
JAX ``uint32`` words: PyTorch's ``uint32`` supports few operations.  Right
shifts on int32 are arithmetic, so every shift below is followed by a mask
that clears the sign fill.

Five kernels carry every packed-matrix read of the linear path:

* ``axm_i8a``  z[4, Nb, B] = A_a @ W   (replaces ``axm_i8a_pallas``)
* ``atxm_i8a`` av[Mpad, B] = A_a^T V   (replaces ``atxm_i8a_pallas``)
* ``axm_i8``   z[4, Nb, B] = A_a @ W - A_b @ U (replaces ``axm_i8_pallas``)
* ``atxm_i8``  (A_a^T V, A_b^T V) -> [Mpad, B] x2 (replaces
  ``atxm_i8_pallas``)
* ``atx``      (A_a^T v, A_b^T v) in f32 (replaces ``atx_pallas``, used once
  at load by the completeness check)

The a-only pair serves complete (imputed) genotypes, where the
non-missing indicator b is 1 on every real sample and its contractions
collapse to scalars; the general pair serves genotypes with missing calls.

The digit contract is the JAX package's: right-hand sides are quantised into
``_NDIG`` radix-127 int8 digits outside the kernel, the kernel contracts the
digits exactly in int32, and the fold back to f32 also runs outside the
kernel.  The wrappers and the plain versions share the quantisation and the
fold, so on one device a kernel's output equals its plain version's bit for
bit.

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches its kernel or raises; it never falls back.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels.
"""

from __future__ import annotations

import torch

_M1 = 0x01010101
_M3 = 0x03030303

# radix-127 int8 digits per f32 value (gvamp_tpu/ops/matvec.py:456)
_NDIG = 4
# forward-product column chunk (gvamp_tpu/ops/matvec.py:464); the CUDA
# kernel itself takes any width, the chunking keeps JAX's call structure
_BMAX_AXM_A = 64

LAUNCHES = {"axm_i8a": 0, "atxm_i8a": 0, "axm_i8": 0, "atxm_i8": 0,
            "atx": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# decode (plain PyTorch)
# --------------------------------------------------------------------------


def _swar(words: torch.Tensor, k: int):
    """SWAR decode of bit-pair plane k: int32 words -> (a, b) with one value
    per byte, a = {2,0,1,0}[code], b = {1,0,1,1}[code]."""
    c = (words >> (2 * k)) & _M3
    lo = c & _M1
    hi = (c >> 1) & _M1
    notlo = lo ^ _M1
    a = (notlo << 1) - (hi & notlo)
    b = hi | notlo
    return a, b


def _bytes_to_rows(x: torch.Tensor) -> torch.Tensor:
    """int32 [Nw, M] of byte values -> int32 [4*Nw, M]: byte b of word-row i
    becomes row 4i+b (the planar byte-position axis)."""
    nw, m = x.shape
    return torch.stack([(x >> (8 * j)) & 0xFF for j in range(4)],
                       dim=1).reshape(4 * nw, m)


def _decode_plane(words: torch.Tensor, dtype, plane: int) -> torch.Tensor:
    """Dosage (``plane`` 0) or non-missing indicator (``plane`` 1) planes
    [4, Nb, M] of a word block."""
    return torch.stack([_bytes_to_rows(_swar(words, k)[plane])
                        for k in range(4)]).to(dtype)


def decode_planar_dense(words: torch.Tensor, dtype=torch.float32):
    """int32[Nw, M] -> (a, b) dtype[4, Nb, M] planar-dense decode."""
    a_pl, b_pl = [], []
    for k in range(4):
        a, b = _swar(words, k)
        a_pl.append(_bytes_to_rows(a))
        b_pl.append(_bytes_to_rows(b))
    return torch.stack(a_pl).to(dtype), torch.stack(b_pl).to(dtype)


def two_sum(hi, lo, p):
    """Compensated accumulation (Knuth two-sum): (hi, lo) += p with the
    rounding error of the hi update captured exactly in lo."""
    s = hi + p
    bp = s - hi
    err = (hi - (s - bp)) + (p - bp)
    return s, lo + err


def nb_chunk(Nb: int, target: int = 8192) -> int:
    """Largest chunk length <= target dividing Nb (a multiple of 128) — the
    N-axis split for compensated moments."""
    q = Nb // 128
    d = max(dd for dd in range(1, min(q, target // 128) + 1) if q % dd == 0)
    return 128 * d


# --------------------------------------------------------------------------
# dense plain versions (counterparts of ax_xla ... atxm_xla)
# --------------------------------------------------------------------------

_REF_BLOCK = 512  # markers decoded per step: bounds the dense temporaries


def ax_ref(words, w, u, dtype=torch.float32):
    """z[k, p] = sum_m a_k[m, p] w[m] - b_k[m, p] u[m]."""
    a, b = decode_planar_dense(words, dtype)
    return (torch.einsum("knm,m->kn", a, w.to(dtype))
            - torch.einsum("knm,m->kn", b, u.to(dtype)))


def atx_ref(words, v_planar, dtype=torch.float32):
    """(av[M], bv[M]): the plain version of the ``atx`` kernel at f32,
    decoded ``_REF_BLOCK`` markers at a time."""
    v = v_planar.to(dtype)
    m = words.shape[1]
    av = torch.empty(m, dtype=dtype, device=words.device)
    bv = torch.empty(m, dtype=dtype, device=words.device)
    for lo in range(0, m, _REF_BLOCK):
        a, b = decode_planar_dense(words[:, lo:lo + _REF_BLOCK], dtype)
        av[lo:lo + _REF_BLOCK] = torch.einsum("knm,kn->m", a, v)
        bv[lo:lo + _REF_BLOCK] = torch.einsum("knm,kn->m", b, v)
    return av, bv


def axm_ref(words, W, U, dtype=torch.float32):
    a, b = decode_planar_dense(words, dtype)
    return (torch.einsum("knm,mj->knj", a, W.to(dtype))
            - torch.einsum("knm,mj->knj", b, U.to(dtype)))


def atxm_ref(words, V, dtype=torch.float32):
    a, b = decode_planar_dense(words, dtype)
    v = V.to(dtype)
    return torch.einsum("knm,knj->mj", a, v), torch.einsum("knm,knj->mj", b, v)


# --------------------------------------------------------------------------
# the digit contract (gvamp_tpu/ops/matvec.py:478-512, 680-700)
# --------------------------------------------------------------------------


def _quant_digits(x: torch.Tensor, axis: int):
    """f32 -> (int8 digits concatenated along ``axis``, per-column scales)."""
    x = x.to(torch.float32)
    red = tuple(i for i in range(x.ndim) if i != axis and x.shape[i] != 1)
    m = x.abs().amax(dim=red, keepdim=True) if red else x.abs()
    s0 = torch.where(m == 0, 1.0, m) / 127.0
    digs = []
    r = x
    s = s0
    for _ in range(_NDIG):
        d = torch.round(r / s)
        digs.append(d.to(torch.int8))
        r = r - d * s
        s = s / 127.0
    return torch.cat(digs, dim=axis), s0


def _quant_digits_t(V: torch.Tensor):
    """Digits of V^T: f32[4, Nb, B] -> (int8[4, NDIG*B, Nb], scales [B])."""
    vt = V.to(torch.float32).permute(0, 2, 1)
    v8, vs = _quant_digits(vt, 1)
    return v8.contiguous(), vs[0, :, 0]


def _fold_digits(z_i32, s0, B: int):
    """int32 [..., NDIG*B] digit products + scales [..., B] -> f32 [..., B]."""
    zf = z_i32.to(torch.float32)
    out = zf[..., :B] * s0
    scale = s0
    for d in range(1, _NDIG):
        scale = scale / 127.0
        out = out + zf[..., d * B:(d + 1) * B] * scale
    return out


def _fold_digits_zt(zt_i32, s0, B: int):
    """int32[NDIG*B, 4, Nb] digit rows + scales [B] -> f32[4, Nb, B].

    An elementwise fold (no matrix product), so its result does not depend
    on a library's reduction order and a kernel compares bit for bit."""
    zf = zt_i32.to(torch.float32).reshape(_NDIG, B, *zt_i32.shape[1:])
    out = zf[0] * s0[:, None, None]
    scale = s0
    for d in range(1, _NDIG):
        scale = scale / 127.0
        out = out + zf[d] * scale[:, None, None]
    return out.permute(1, 2, 0)


def _fold_digits_t(av_i32, s0, B: int):
    """int32[NDIG*B, M] digit rows + scales [B] -> f32[M, B]."""
    zf = av_i32.to(torch.float32)
    out = zf[:B] * s0[:, None]
    scale = s0
    for d in range(1, _NDIG):
        scale = scale / 127.0
        out = out + zf[d * B:(d + 1) * B] * scale[:, None]
    return out.T


# --------------------------------------------------------------------------
# plain versions of the integer contractions (exact, in float64)
# --------------------------------------------------------------------------


def _axm_int(words, dig, plane: int):
    """Exact digit products of one decoded plane: int32[D, 4, Nb] from
    digits int8[D, M].

    Integer partial sums stay below 254*M < 2**31, so float64 holds them
    exactly whatever the summation order."""
    nw, m = words.shape
    acc = torch.zeros((dig.shape[0], 4, 4 * nw), dtype=torch.float64,
                      device=words.device)
    for lo in range(0, m, _REF_BLOCK):
        p = _decode_plane(words[:, lo:lo + _REF_BLOCK], torch.float64, plane)
        acc += torch.einsum("knm,dm->dkn", p,
                            dig[:, lo:lo + _REF_BLOCK].to(torch.float64))
    return acc.to(torch.int32)


def _atxm_int(words, v8, plane: int):
    """Exact transpose digit products of one decoded plane: int32[D, M]
    from digits int8[4, D, Nb]."""
    m = words.shape[1]
    out = torch.empty((v8.shape[1], m), dtype=torch.int32, device=words.device)
    v = v8.to(torch.float64)
    for lo in range(0, m, _REF_BLOCK):
        p = _decode_plane(words[:, lo:lo + _REF_BLOCK], torch.float64, plane)
        out[:, lo:lo + _REF_BLOCK] = torch.einsum("kdn,knm->dm", v, p).to(
            torch.int32)
    return out


def axm_i8a_int_ref(words, w8t):
    """Exact digit products of A_a: int32[D, 4, Nb] from digits int8[D, M]."""
    return _axm_int(words, w8t, 0)


def atxm_i8a_int_ref(words, v8):
    """Exact digit products of A_a^T: int32[D, M] from digits int8[4, D, Nb]."""
    return _atxm_int(words, v8, 0)


def axm_i8_int_ref(words, w8t, u8t):
    """Exact (za, zb) int32[D, 4, Nb]: A_a against the digits of W and A_b
    against those of U (a = {2,0,1,0}[code], b = {1,0,1,1}[code])."""
    return _axm_int(words, w8t, 0), _axm_int(words, u8t, 1)


def atxm_i8_int_ref(words, v8):
    """Exact (av, bv) int32[D, Mpad]: both planes against the same digits."""
    return _atxm_int(words, v8, 0), _atxm_int(words, v8, 1)


def _quant_rows(W):
    """Digits of W^T, int8[NDIG*B, M], and the per-column scales [B]."""
    w8t, ws = _quant_digits(W.T, 0)
    return w8t.contiguous(), ws[:, 0]


def axm_i8a_ref(words, W):
    """Plain version of ``axm_i8a``: A_a @ W -> f32[4, Nb, B]."""
    w8t, ws = _quant_rows(W)
    return _fold_digits_zt(axm_i8a_int_ref(words, w8t), ws, W.shape[1])


def atxm_i8a_ref(words, V):
    """Plain version of ``atxm_i8a``: A_a^T V -> f32[Mpad, B]."""
    v8, s0 = _quant_digits_t(V)
    return _fold_digits_t(atxm_i8a_int_ref(words, v8), s0, V.shape[2])


def axm_i8_ref(words, W, U):
    """Plain version of ``axm_i8``: A_a @ W - A_b @ U -> f32[4, Nb, B], with
    W and U quantised separately (gvamp_tpu/ops/matvec.py:553-554)."""
    w8t, ws = _quant_rows(W)
    u8t, us = _quant_rows(U)
    za, zb = axm_i8_int_ref(words, w8t, u8t)
    B = W.shape[1]
    return _fold_digits_zt(za, ws, B) - _fold_digits_zt(zb, us, B)


def atxm_i8_ref(words, V):
    """Plain version of ``atxm_i8``: (A_a^T V, A_b^T V) -> f32[Mpad, B] x2,
    one quantisation of V shared by both planes (matvec.py:721, 741)."""
    v8, s0 = _quant_digits_t(V)
    av, bv = atxm_i8_int_ref(words, v8)
    B = V.shape[2]
    return _fold_digits_t(av, s0, B), _fold_digits_t(bv, s0, B)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_I32_LIMIT = 2 ** 31


def _check_cuda(name: str, words: torch.Tensor, rhs: torch.Tensor,
                rhs_dtype: torch.dtype) -> None:
    """Raise on anything the CUDA kernels do not take."""
    if words.device.type != "cuda":
        raise ValueError(f"{name}: words on {words.device}; the kernel runs "
                         f"on CUDA tensors only")
    if rhs.device != words.device:
        raise ValueError(f"{name}: operands on {words.device} and {rhs.device}")
    if words.dtype != torch.int32 or words.ndim != 2:
        raise ValueError(f"{name}: words must be int32[Nw, Mpad], got "
                         f"{words.dtype}{list(words.shape)}")
    if rhs.dtype != rhs_dtype:
        raise ValueError(f"{name}: right-hand side must be {rhs_dtype}, got "
                         f"{rhs.dtype} (float64 has no kernel in this port)")
    # the kernels read the words and the digit tensors the wrappers make
    # (contiguous, freshly allocated), never the right-hand side itself
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError(f"{name}: words must be contiguous and 16-byte "
                         f"aligned")
    if words.shape[1] % 4:
        raise ValueError(f"{name}: Mpad={words.shape[1]} must be a multiple "
                         f"of 4")


def _check_bound(name: str, k: int) -> None:
    """|sum| <= 254*K for a contraction of length K must fit int32."""
    if 254 * k >= _I32_LIMIT:
        raise ValueError(f"{name}: contraction length {k} overflows the int32 "
                         f"accumulator (254*K must stay below 2**31)")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Launch on PyTorch's current stream; raise on the launch's error code
    (``cudaGetLastError`` right after the launch, returned by the C side)."""
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1


def axm_i8a(words: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A_a @ W -> f32[4, Nb, B] on complete genotypes; the caller subtracts
    the b-side scalar colsum(mave W)."""
    B = W.shape[1]
    if B > _BMAX_AXM_A:
        return torch.cat([axm_i8a(words, W[:, lo:lo + _BMAX_AXM_A])
                          for lo in range(0, B, _BMAX_AXM_A)], dim=2)
    if words.device.type == "cpu":
        return axm_i8a_ref(words, W)
    _check_cuda("axm_i8a", words, W, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m:
        raise ValueError(f"axm_i8a: W must be [{m}, B], got {list(W.shape)}")
    _check_bound("axm_i8a", m)
    w8t, ws = _quant_rows(W)
    zt = torch.zeros((w8t.shape[0], 4, 4 * nw), dtype=torch.int32,
                     device=words.device)
    from gvamp_tpu_torch.ops import _build
    _launch("axm_i8a", _build.library().gvamp_axm_i8a, words.device,
            words.data_ptr(), w8t.data_ptr(), zt.data_ptr(), nw, m,
            w8t.shape[0])
    return _fold_digits_zt(zt, ws, B)


def atxm_i8a(words: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """A_a^T V -> f32[Mpad, B] on complete genotypes; the caller subtracts
    mave * colsum(V)."""
    if words.device.type == "cpu":
        return atxm_i8a_ref(words, V)
    _check_cuda("atxm_i8a", words, V, torch.float32)
    nw, m = words.shape
    if V.shape[:2] != (4, 4 * nw):
        raise ValueError(f"atxm_i8a: V must be [4, {4 * nw}, B], got "
                         f"{list(V.shape)}")
    _check_bound("atxm_i8a", 16 * nw)
    v8, s0 = _quant_digits_t(V)
    av = torch.zeros((v8.shape[1], m), dtype=torch.int32, device=words.device)
    from gvamp_tpu_torch.ops import _build
    _launch("atxm_i8a", _build.library().gvamp_atxm_i8a, words.device,
            words.data_ptr(), v8.data_ptr(), av.data_ptr(), nw, m, v8.shape[1])
    return _fold_digits_t(av, s0, V.shape[2])


def axm_i8(words: torch.Tensor, W: torch.Tensor,
           U: torch.Tensor) -> torch.Tensor:
    """A_a @ W - A_b @ U -> f32[4, Nb, B] on genotypes with missing calls.

    One launch for any B: the kernel spreads digit groups over its grid, and
    quantisation is per column, so the JAX wrapper's column chunking
    (``_BMAX_AXM``) would not change a value."""
    if words.device.type == "cpu":
        return axm_i8_ref(words, W, U)
    _check_cuda("axm_i8", words, W, torch.float32)
    _check_cuda("axm_i8", words, U, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m or U.shape != W.shape:
        raise ValueError(f"axm_i8: W and U must be [{m}, B], got "
                         f"{list(W.shape)} and {list(U.shape)}")
    _check_bound("axm_i8", m)
    w8t, ws = _quant_rows(W)
    u8t, us = _quant_rows(U)
    D = w8t.shape[0]
    za = torch.zeros((D, 4, 4 * nw), dtype=torch.int32, device=words.device)
    zb = torch.zeros_like(za)
    from gvamp_tpu_torch.ops import _build
    _launch("axm_i8", _build.library().gvamp_axm_i8, words.device,
            words.data_ptr(), w8t.data_ptr(), u8t.data_ptr(), za.data_ptr(),
            zb.data_ptr(), nw, m, D)
    B = W.shape[1]
    return _fold_digits_zt(za, ws, B) - _fold_digits_zt(zb, us, B)


def atxm_i8(words: torch.Tensor, V: torch.Tensor):
    """(A_a^T V, A_b^T V) -> f32[Mpad, B] x2 on genotypes with missing
    calls; the caller forms av - mave * bv."""
    if words.device.type == "cpu":
        return atxm_i8_ref(words, V)
    _check_cuda("atxm_i8", words, V, torch.float32)
    nw, m = words.shape
    if V.ndim != 3 or V.shape[:2] != (4, 4 * nw):
        raise ValueError(f"atxm_i8: V must be [4, {4 * nw}, B], got "
                         f"{list(V.shape)}")
    _check_bound("atxm_i8", 16 * nw)
    v8, s0 = _quant_digits_t(V)
    av = torch.zeros((v8.shape[1], m), dtype=torch.int32, device=words.device)
    bv = torch.zeros_like(av)
    from gvamp_tpu_torch.ops import _build
    _launch("atxm_i8", _build.library().gvamp_atxm_i8, words.device,
            words.data_ptr(), v8.data_ptr(), av.data_ptr(), bv.data_ptr(), nw,
            m, v8.shape[1])
    B = V.shape[2]
    return _fold_digits_t(av, s0, B), _fold_digits_t(bv, s0, B)


def atx(words: torch.Tensor, v_planar: torch.Tensor):
    """(A_a^T v, A_b^T v) -> f32[Mpad] x2 for one planar vector v[4, Nb].

    With v = 1 on the real samples, bv counts each marker's non-missing
    calls, exactly in f32 while the 16*Nw samples stay below 2**24."""
    if 16 * words.shape[0] >= 2 ** 24:
        raise ValueError(f"atx: {16 * words.shape[0]} samples; the f32 sums "
                         f"are exact counts only below 2**24")
    if words.device.type == "cpu":
        return atx_ref(words, v_planar, torch.float32)
    _check_cuda("atx", words, v_planar, torch.float32)
    nw, m = words.shape
    if tuple(v_planar.shape) != (4, 4 * nw):
        raise ValueError(f"atx: v must be [4, {4 * nw}], got "
                         f"{list(v_planar.shape)}")
    v = v_planar.contiguous()  # the kernel reads v itself
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    parts = lib.gvamp_atx_parts(nw, m)
    out = torch.empty((2, parts, m), dtype=torch.float32, device=words.device)
    _launch("atx", lib.gvamp_atx, words.device, words.data_ptr(),
            v.data_ptr(), out.data_ptr(), nw, m)
    # the per-band partial sums meet here, in a fixed order: deterministic
    av, bv = out.sum(dim=1)
    return av, bv
