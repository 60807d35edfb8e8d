"""Packed-genotype products of the PyTorch port: plain versions and the
wrappers of the hand-written CUDA kernels (``csrc/matvec.cu``,
``csrc/fragments.cu`` for the five digit products ``axm_i8a``,
``atxm_i8a``, ``axm_i8``, ``atxm_i8`` and ``axm_i8s``,
``csrc/bf16_split.cu`` for the bf16-split products ``axm_bf16`` and
``atxm_bf16``, ``csrc/gram_aat.cu`` for the fused dual Grams
``gram_aat_i8a`` and ``gram_aat_i8``, and ``csrc/gram_prim.cu`` for the
fused primal Grams ``gram_i8a`` and ``gram_i8``).

Counterpart of ``gvamp_tpu/ops/matvec.py`` for the linear main path.  The
word layout is the same (word-major ``[Nw, Mpad]``, 16 samples per word,
planar N order, 0x55 padding), held as ``torch.int32`` with the bits of the
JAX ``uint32`` words: PyTorch's ``uint32`` supports few operations.  Right
shifts on int32 are arithmetic, so every shift below is followed by a mask
that clears the sign fill.

Ten kernels carry every packed-matrix read of the engines:

* ``axm_i8a``  z[4, Nb, B] = A_a @ W   (replaces ``axm_i8a_pallas``)
* ``atxm_i8a`` av[Mpad, B] = A_a^T V   (replaces ``atxm_i8a_pallas``)
* ``axm_i8``   z[4, Nb, B] = A_a @ W - A_b @ U (replaces ``axm_i8_pallas``)
* ``atxm_i8``  (A_a^T V, A_b^T V) -> [Mpad, B] x2 (replaces
  ``atxm_i8_pallas``)
* ``atx``      (A_a^T v, A_b^T v) in f32 (replaces ``atx_pallas``, used once
  at load by the completeness check)
* ``ax``       z[4, Nb] = A_a w - A_b u in f32 (replaces ``ax_pallas``, the
  people statistics of the dual solve)
* ``gram_aat_i8a`` / ``gram_aat_i8``  the fused dual Gram A (A^T V) of the
  XXT solve in one read of the words (replace ``gram_aat_i8a_pallas`` /
  ``gram_aat_i8_pallas``)
* ``gram_i8a`` / ``gram_i8``  the fused primal Gram A^T (na (A W)) of the
  block CG in one read of the words, opt-in (``GVAMP_FUSED_GRAM=1``;
  replace ``gram_i8a_pallas`` / ``gram_i8_pallas``)

One more reads the words once per phenotype: ``marker_counts`` (the
integer counts S_a, S_b, S_aa of the statistics pass over an NA support,
``csrc/counts.cu``), which ``data.py`` turns into mave and msig.

Four more serve the tools of ``gvamp_tpu_torch/tools/`` (the kernel check,
the Gram study and the kernel profile), as their JAX counterparts serve
``tools/``:

* ``axm_bf16`` / ``atxm_bf16``  the products of ``axm_i8`` / ``atxm_i8``
  with the right-hand side split into three bf16 parts (``_split_hi_lo``;
  replace ``axm_pallas`` / ``atxm_pallas``)
* ``axm_i8s``  A_a @ W - A_b @ U with W and -U under one digit scale and
  one int32 sum (replaces ``axm_i8s_pallas``)
* ``atx_a``    A_a^T v in f32 (replaces ``atx_a_pallas``)

The a-only kernels serve complete (imputed) genotypes, where the
non-missing indicator b is 1 on every real sample and its contractions
collapse to scalars; the general ones serve genotypes with missing calls.

The digit contract is the JAX package's: right-hand sides are quantised into
``_NDIG`` radix-127 int8 digits outside the kernel, the kernel contracts the
digits exactly in int32, and the fold back to f32 also runs outside the
kernel.  The wrappers and the plain versions share the quantisation and the
fold, so on one device a kernel's output equals its plain version's bit for
bit.  The fused Grams fold and requantise inside the kernel, the dual one
per stripe of ``GRAM_AAT_STRIPE`` markers, the primal one per band of
``GRAM_BAND_NW`` word rows; their plain versions repeat those steps with
the same roundings (see ``gram_aat_i8a_ref`` and ``gram_i8a_ref``).

A wrapper takes its plain version only for a tensor on the CPU.  For a CUDA
tensor it launches its kernel or raises; it never falls back.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that its
main path went through the kernels; ``trace.LAUNCHED`` keeps their running
total.  Under a profiler each call of a public product wrapper is a
``product`` span with the wrapper's name and the width B it was passed
(``gvamp_tpu_torch.trace``).
"""

from __future__ import annotations

import functools

import torch

from gvamp_tpu_torch import trace

_M1 = 0x01010101
_M3 = 0x03030303

# radix-127 int8 digits per f32 value (gvamp_tpu/ops/matvec.py:456)
_NDIG = 4
# forward-product column chunks (gvamp_tpu/ops/matvec.py:463-464); the
# fused primal Grams chunk at them as JAX's do, while axm_i8a, axm_i8 and
# axm_i8s take any width in one launch (quantisation is per column, so a
# chunk would not change a value)
_BMAX_AXM = 32
_BMAX_AXM_A = 64
# column chunk of the bf16-split products (gvamp_tpu/ops/matvec.py:466); the
# wrappers keep it
_BMAX_BF16 = 64

# markers per stripe of the fused dual Gram: the kernel's work unit and its
# quantisation boundary (W is requantised per stripe and column), shared by
# the CUDA kernel (kGramS in csrc/gram_aat.cu) and the plain versions
GRAM_AAT_STRIPE = 64
# consecutive stripes whose folded partials one block of the fused dual Gram
# adds in stripe order before the one torch.sum over the groups: a
# summation-order boundary, shared by the CUDA kernel (kGramGroup) and the
# plain versions, never sized from the card
GRAM_AAT_GROUP = 8
# shared memory one block of a fused Gram may use on an H100 (227 KB, the
# opt-in maximum); the dual Gram's gram_aat_smem_bytes(Nw) must fit it
GRAM_AAT_SMEM_BUDGET = 232_448
# the widest words the fused dual Gram takes: N up to 13,152 (822 word
# rows), the route's edge; its shared memory would hold 887 rows, but the
# fused and the two-pass forms quantise W differently, so moving the edge
# would change the numbers a user gets at those N
GRAM_AAT_MAX_NW = 822

# word rows per band of the fused primal Gram: z is requantised per band, so
# the band height sets the numbers; shared by the CUDA kernel (kT in
# csrc/gram_prim.cu), the plain versions and the JAX parity tests (tnw=).
# The JAX package picks 64 at config B (_pick_tnw(Nw, 64)); here a block
# keeps a ring of GRAM_RING band tiles of its marker range in shared
# memory, and 16 rows keep three of them within the 227 KB budget at
# M=131,072 on 132 SMs.
GRAM_BAND_NW = 16
# band tiles in the fused primal Gram's shared-memory ring (kRing): the
# band being transposed, the next one, whose forward side has run, and the
# one being loaded
GRAM_RING = 3
# marker quads one block of the fused primal Gram takes at most: one
# 64-marker group per warp of its transpose side, whose running sums stay
# in registers (kMaxRowWords / 4 in csrc/gram_prim.cu); Mpad up to 135,168
# on 132 SMs
GRAM_MAX_QUADS = 256
# one persistent block per SM: the SM count of the card the words lie on,
# and an H100's for words on the CPU (the routing test of fn_gram)
GRAM_BLOCKS_H100 = 132

# one count per wrapper; the last eleven are the study kernels of
# ops/study.py
LAUNCHES = {"axm_i8a": 0, "atxm_i8a": 0, "axm_i8": 0, "atxm_i8": 0,
            "atx": 0, "ax": 0, "gram_aat_i8a": 0, "gram_aat_i8": 0,
            "gram_i8a": 0, "gram_i8": 0, "axm_bf16": 0, "atxm_bf16": 0,
            "axm_i8s": 0, "atx_a": 0, "marker_counts": 0, "stream": 0,
            "stream_sum": 0,
            "v0_stream": 0, "v1_decode_a": 0, "v2_decode_ab": 0,
            "v3_bitcast": 0, "v5_dot1": 0, "v6_fused_ab": 0,
            "v7_i8decode": 0, "v8_atxm_vt": 0, "v7_i8decode_round2": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# the products of one vector: B = 1
_ONE_VECTOR = ("atx", "ax", "atx_a")


def _product(fn):
    """A public product wrapper, spanned under a profiler as ``product``
    with its name and the width B of its right-hand side."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapper(words, X, *rest, **kw):
        if not trace.on():
            return fn(words, X, *rest, **kw)
        with trace.span("product", name=name,
                        B=1 if name in _ONE_VECTOR else int(X.shape[-1])):
            return fn(words, X, *rest, **kw)

    return wrapper


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
    """z[k, p] = sum_m a_k[m, p] w[m] - b_k[m, p] u[m]: the plain version of
    the ``ax`` kernel at f32, decoded ``_REF_BLOCK`` markers at a time."""
    w, u = w.to(dtype), u.to(dtype)
    z = torch.zeros((4, 4 * words.shape[0]), dtype=dtype, device=words.device)
    for lo in range(0, words.shape[1], _REF_BLOCK):
        a, b = decode_planar_dense(words[:, lo:lo + _REF_BLOCK], dtype)
        z += (torch.einsum("knm,m->kn", a, w[lo:lo + _REF_BLOCK])
              - torch.einsum("knm,m->kn", b, u[lo:lo + _REF_BLOCK]))
    return z


# The single-vector transposes sum all 16*Nw samples of a marker: one long
# f32 sum errs about 1e-6 of the largest entry at 1,024 samples, beyond the
# 5e-7 to which tools/kernel_check.py holds every product.  Their plain
# versions sum in float64 and round once (the kernels sum each word row in
# f32 and the rows in double); on dyadic inputs both are exact.


def atx_ref(words, v_planar, dtype=torch.float32):
    """(av[M], bv[M]): the plain version of the ``atx`` kernel, decoded
    ``_REF_BLOCK`` markers at a time, summed in float64, rounded to
    ``dtype``."""
    f64 = torch.float64
    v = v_planar.to(f64)
    m = words.shape[1]
    av = torch.empty(m, dtype=dtype, device=words.device)
    bv = torch.empty(m, dtype=dtype, device=words.device)
    for lo in range(0, m, _REF_BLOCK):
        a, b = decode_planar_dense(words[:, lo:lo + _REF_BLOCK], f64)
        av[lo:lo + _REF_BLOCK] = torch.einsum("knm,kn->m", a, v).to(dtype)
        bv[lo:lo + _REF_BLOCK] = torch.einsum("knm,kn->m", b, v).to(dtype)
    return av, bv


def atx_a_ref(words, v_planar):
    """av[M] = A_a^T v: the plain version of the ``atx_a`` kernel, the
    a-side of ``atx_ref``."""
    return atx_ref(words, v_planar)[0]


# --------------------------------------------------------------------------
# the statistics pass's counts (plain version of csrc/counts.cu)
# --------------------------------------------------------------------------

# bytes of one decoded int32 [4, Nb, block] plane that the plain counts
# allow: the block of markers shrinks with Nw, and the last block is ragged
_COUNT_BYTES = 2 ** 28


def na_mask_words(na_planar: torch.Tensor) -> torch.Tensor:
    """int32[Nw]: one mask word per word row with bit 8j+2k set where
    planar slot (k, 4i+j) of ``na_planar`` ([4, Nb]) is not 0, the low bit
    of that slot's 2-bit field in the words' own order (``ops/layout.py``).
    The callers' NA indicators are 0/1, so ``!= 0`` is the indicator."""
    nw = na_planar.shape[1] // 4
    na = (na_planar != 0).to(torch.int32).reshape(4, nw, 4)
    pos = torch.arange(4, dtype=torch.int32, device=na_planar.device)
    shift = 2 * pos[:, None, None] + 8 * pos[None, None, :]
    # distinct bits below 2**31: their sum is their union
    return (na << shift).sum(dim=(0, 2), dtype=torch.int32)


def marker_counts_ref(words: torch.Tensor,
                      na_planar: torch.Tensor) -> torch.Tensor:
    """int64[3, M]: S_a = sum a na, S_b = sum b na and S_aa = sum a^2 na
    per marker over the planar slots where ``na_planar`` is not 0, decoded
    in blocks of markers (the last one ragged) and summed in int64.  The
    plain version of ``marker_counts``: the CPU path, the float64 path and
    the kernel's oracle."""
    nw, m = words.shape
    na = (na_planar != 0).to(torch.int32)[:, :, None]
    out = torch.empty((3, m), dtype=torch.int64, device=words.device)
    block = max(1, min(_REF_BLOCK, _COUNT_BYTES // (64 * max(nw, 1))))
    for lo in range(0, m, block):
        a, b = decode_planar_dense(words[:, lo:lo + block], torch.int32)
        am = a * na
        out[0, lo:lo + block] = am.sum(dim=(0, 1), dtype=torch.int64)
        out[1, lo:lo + block] = (b * na).sum(dim=(0, 1), dtype=torch.int64)
        out[2, lo:lo + block] = (a * am).sum(dim=(0, 1), dtype=torch.int64)
    return out


def axm_ref(words, W, U, dtype=torch.float32):
    a, b = decode_planar_dense(words, dtype)
    return (torch.einsum("knm,mj->knj", a, W.to(dtype))
            - torch.einsum("knm,mj->knj", b, U.to(dtype)))


def atxm_ref(words, V, dtype=torch.float32):
    a, b = decode_planar_dense(words, dtype)
    v = V.to(dtype)
    return torch.einsum("knm,knj->mj", a, v), torch.einsum("knm,knj->mj", b, v)


# --------------------------------------------------------------------------
# the bf16 split (gvamp_tpu/ops/matvec.py:115-132, 319-435)
# --------------------------------------------------------------------------


def _split_hi_lo(x: torch.Tensor, dim: int) -> torch.Tensor:
    """f32 -> three bf16 parts hi, mid, lo concatenated along ``dim``, as
    ``gvamp_tpu/ops/matvec.py:115-132`` computes them: x ~= hi + mid + lo,
    each part the round-to-nearest-even bf16 of what the parts before it
    leave.  Eager PyTorch rounds every conversion, so mid and lo keep the
    residuals that XLA once folded to zero on the TPU (the reason for
    ``tools/tpu_check.py``)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r1 = x - hi.to(torch.float32)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(torch.float32)).to(torch.bfloat16)
    return torch.cat([hi, mid, lo], dim=dim)


def _sum_parts3(hi, mid, lo):
    """The three part products added as the TPU kernels add them: (hi +
    mid) + lo."""
    return (hi + mid) + lo


def _sum_parts(d: torch.Tensor, B: int) -> torch.Tensor:
    """The three part products [..., 3B] -> [..., B], (hi + mid) + lo."""
    return _sum_parts3(d[..., :B], d[..., B:2 * B], d[..., 2 * B:])


def axm_bf16_ref(words, W, U):
    """Plain version of ``axm_bf16``: A_a @ W - A_b @ U -> f32[4, Nb, B]
    from the bf16 parts of W and U, decoded ``_REF_BLOCK`` markers at a
    time; each block's part products (exact per term, f32 sums) meet as
    (hi + mid) + lo, as in ``_axm_kernel`` (gvamp_tpu/ops/matvec.py:338)."""
    nw, m = words.shape
    B = W.shape[1]
    w2 = _split_hi_lo(W, 1).to(torch.float32)
    u2 = _split_hi_lo(U, 1).to(torch.float32)
    z = torch.zeros((4, 4 * nw, B), dtype=torch.float32, device=words.device)
    for lo in range(0, m, _REF_BLOCK):
        a, b = decode_planar_dense(words[:, lo:lo + _REF_BLOCK], torch.float32)
        d = (torch.einsum("knm,mj->knj", a, w2[lo:lo + _REF_BLOCK])
             - torch.einsum("knm,mj->knj", b, u2[lo:lo + _REF_BLOCK]))
        z += _sum_parts(d, B)
    return z


def atxm_bf16_ref(words, V):
    """Plain version of ``atxm_bf16``: (A_a^T V, A_b^T V) -> f32[Mpad, B] x2
    from the bf16 parts of V, decoded ``_REF_BLOCK`` markers at a time, the
    part products meeting as (hi + mid) + lo."""
    m = words.shape[1]
    B = V.shape[2]
    v2 = _split_hi_lo(V, 2).to(torch.float32)
    av = torch.empty((m, B), dtype=torch.float32, device=words.device)
    bv = torch.empty_like(av)
    for lo in range(0, m, _REF_BLOCK):
        a, b = decode_planar_dense(words[:, lo:lo + _REF_BLOCK], torch.float32)
        av[lo:lo + _REF_BLOCK] = _sum_parts(
            torch.einsum("knm,knj->mj", a, v2), B)
        bv[lo:lo + _REF_BLOCK] = _sum_parts(
            torch.einsum("knm,knj->mj", b, v2), B)
    return av, bv


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


def axm_i8s_int_ref(words, w8t, mu8t):
    """Exact shared-accumulator digit products int32[D, 4, Nb]: A_a against
    the digits of W plus A_b against those of -U, summed in int32 (|sum| <=
    381*M)."""
    return _axm_int(words, w8t, 0) + _axm_int(words, mu8t, 1)


def axm_i8s_ref(words, W, U):
    """Plain version of ``axm_i8s``: A_a @ W - A_b @ U -> f32[4, Nb, B] with
    W and -U quantised at one shared scale per column
    (``_quant_digits_pair``) and folded once."""
    w8t, mu8t, ws = _quant_digits_pair(W, U)
    return _fold_digits_zt(axm_i8s_int_ref(words, w8t, mu8t), ws, W.shape[1])


# --------------------------------------------------------------------------
# the fused dual Gram (gvamp_tpu/ops/matvec.py:1207-1381, 1400-1520)
#
# Per stripe of S = GRAM_AAT_STRIPE markers: the transpose digit products t
# (exact int32), folded to f32; W = msig2 (A_a^T V - ...); W requantised
# into _NDIG digits with one scale per stripe and column; the forward digit
# products of those digits (exact int32), folded with the stripe's scales
# into one f32 partial z_j[B, 4, Nb].  The partials of each group of
# GRAM_AAT_GROUP consecutive stripes are added in stripe order.  The kernel
# does the same elementwise f32 steps with round-to-nearest intrinsics and
# no FMA contraction, and writes the group sums; z = sum_g z_g is one
# torch.sum over the group axis on both sides, so kernel and plain version
# agree bit for bit on a device.
# Every scale division is a division by a tensor (true IEEE division on
# the CPU and on CUDA, as the kernel's __fdiv_rn), never by a Python
# scalar, which PyTorch's CUDA backend turns into a product with the
# reciprocal.
# --------------------------------------------------------------------------


def _digit_scales(s0: torch.Tensor) -> torch.Tensor:
    """[NDIG, B] scales of V's digits, with the ops of ``_fold_digits_t``."""
    scales = [s0]
    for _ in range(1, _NDIG):
        scales.append(scales[-1] / 127.0)
    return torch.stack(scales)


def _quant_stripes(*xs: torch.Tensor):
    """Shared-scale digits of each x[B, Mpad], per stripe and column:
    ([int8[NDIG, B, Mpad]] per x, scales [NDIG, B, nJ])."""
    B, m = xs[0].shape
    S = GRAM_AAT_STRIPE
    parts = [x.reshape(B, m // S, S) for x in xs]
    mx = parts[0].abs().amax(dim=2)
    for p in parts[1:]:
        mx = torch.maximum(mx, p.abs().amax(dim=2))
    r127 = torch.full_like(mx, 127.0)
    s = torch.where(mx == 0, 1.0, mx) / r127
    digits = [[] for _ in parts]
    scales = []
    for _ in range(_NDIG):
        scales.append(s)
        for i, r in enumerate(parts):
            d = torch.round(r / s[..., None])
            digits[i].append(d.to(torch.int8))
            parts[i] = r - d * s[..., None]
        s = s / r127
    return ([torch.stack(d).reshape(_NDIG, B, m) for d in digits],
            torch.stack(scales))


def _gram_forward_ref(words, scales, w8, u8=None):
    """Folded forward products summed per group of GRAM_AAT_GROUP stripes,
    f32[nJ/G, B, 4, Nb]: per stripe the a-plane against the digits w8
    int8[NDIG, B, Mpad] (plus, with ``u8``, the b-plane against u8, summed
    in int32 before the fold, as the general kernel does), folded with the
    stripe scales [NDIG, B, nJ]; the stripes of a group added in stripe
    order, as the kernel adds them into its block's slice.  Integer sums
    stay below 381*S, exact in float64."""
    nw, m = words.shape
    S = GRAM_AAT_STRIPE
    step = GRAM_AAT_GROUP * S
    B = w8.shape[1]
    f64 = torch.float64
    out = torch.empty((-(-m // step), B, 4, 4 * nw), dtype=torch.float32,
                      device=words.device)
    for lo in range(0, m, step):
        hi = min(m, lo + step)
        j0, j1 = lo // S, hi // S
        blk = words[:, lo:hi]

        def contract(plane, dig):
            p = _decode_plane(blk, f64, plane).reshape(4, 4 * nw, j1 - j0, S)
            d = dig[:, :, lo:hi].to(f64).reshape(_NDIG, B, j1 - j0, S)
            return torch.einsum("knjs,dbjs->jdbkn", p, d)

        z = contract(0, w8)
        if u8 is not None:
            z = z + contract(1, u8)
        zf = z.to(torch.int32).to(torch.float32)           # [j, d, b, k, n]
        sc = scales[:, :, j0:j1].permute(2, 0, 1)[..., None, None]
        acc = zf[:, 0] * sc[:, 0]
        for d in range(1, _NDIG):
            acc = acc + zf[:, d] * sc[:, d]
        zg = acc[0]
        for j in range(1, j1 - j0):
            zg = zg + acc[j]
        out[lo // step] = zg
    return out


def _gram_group_sum(zg: torch.Tensor) -> torch.Tensor:
    """The group sums f32[nJ/G, B, 4, Nb] summed -> z f32[4, Nb, B]."""
    return zg.sum(dim=0).permute(1, 2, 0)


def _check_stripes(name: str, m: int) -> None:
    if m % GRAM_AAT_STRIPE:
        raise ValueError(f"{name}: Mpad={m} must be a multiple of the "
                         f"{GRAM_AAT_STRIPE}-marker stripe")


def gram_aat_i8a_ref(words, V, mave, msig2):
    """Plain version of ``gram_aat_i8a``: z[4, Nb, B] = A_a W - colsum(mave W)
    with W = msig2 (A_a^T V - colsum(V) mave), quantised per stripe.  ``V``
    is already NA-masked; the caller applies na * scale^2."""
    _check_stripes("gram_aat_i8a_ref", words.shape[1])
    B = V.shape[2]
    v8, vs = _quant_digits_t(V)
    sv = V.to(torch.float32).sum(dim=(0, 1))
    av = _fold_digits_t(atxm_i8a_int_ref(words, v8), vs, B).T   # [B, Mpad]
    W = msig2[None, :] * (av - sv[:, None] * mave[None, :])
    (w8,), scales = _quant_stripes(W)
    z = _gram_group_sum(_gram_forward_ref(words, scales, w8))
    return z - (W * mave[None, :]).sum(dim=1)[None, None, :]


def gram_aat_i8_ref(words, V, mave, msig2):
    """Plain version of ``gram_aat_i8``: z[4, Nb, B] = A_a W - A_b (mave W)
    with W = msig2 (A_a^T V - mave A_b^T V); W and -mave W share each
    stripe's digit scale (gvamp_tpu/ops/matvec.py:1242-1260)."""
    _check_stripes("gram_aat_i8_ref", words.shape[1])
    B = V.shape[2]
    v8, vs = _quant_digits_t(V)
    ai, bi = atxm_i8_int_ref(words, v8)
    av = _fold_digits_t(ai, vs, B).T
    bv = _fold_digits_t(bi, vs, B).T
    W = msig2[None, :] * (av - mave[None, :] * bv)
    mU = -mave[None, :] * W
    (w8, u8), scales = _quant_stripes(W, mU)
    return _gram_group_sum(_gram_forward_ref(words, scales, w8, u8))


def gram_aat_smem_bytes(nw: int) -> int:
    """Shared memory of one fused-dual-Gram block (csrc/gram_aat.cu
    gram_smem_bytes): the stripe cache, Nw x S words (swizzled, unpadded),
    then two [8 x S] int32 tiles of transpose sums, two [8 x S] int8 digit
    tiles and 2 x 4 f32 scales."""
    S = GRAM_AAT_STRIPE
    return 4 * S * nw + 4 * 2 * 8 * S + 2 * 8 * S + 4 * 2 * 4


def gram_aat_fits(nw: int, m: int) -> bool:
    """Whether the fused dual Gram takes these words: at most
    GRAM_AAT_MAX_NW word rows (whose stripe cache fits
    GRAM_AAT_SMEM_BUDGET) and whole stripes."""
    return nw <= GRAM_AAT_MAX_NW and m % GRAM_AAT_STRIPE == 0


# --------------------------------------------------------------------------
# the fused primal Gram (gvamp_tpu/ops/matvec.py:870-1204)
#
# The forward digit products of W (one quantisation over the whole marker
# axis, as axm_i8a's) are exact int32 sums, folded to f32 per sample and
# masked: z = na (fold(A_a W) - colsum_u) (general: na fold(A_a W - A_b U)
# with W and -U under one shared scale).  Per band of GRAM_BAND_NW word rows
# z is requantised into _NDIG digits with one scale per band and column,
# the transpose digit products of the band (exact) are folded with that
# band's scales, and av adds the folds band after band, in band order.  The
# kernel does the same elementwise f32 steps with round-to-nearest
# intrinsics and no FMA contraction; sv = colsum(z) is one torch.sum over
# the same contiguous z on both sides, and every scale division is a
# division by a tensor, so kernel and plain version agree bit for bit.
# --------------------------------------------------------------------------


def _quant_digits_pair(W: torch.Tensor, U: torch.Tensor):
    """Digits of W^T and -U^T under ONE shared scale per column (kernel #8's
    contract, gvamp_tpu/ops/matvec.py:604-615): (int8[NDIG*B, M] x2,
    scales [B])."""
    m = W.shape[0]
    s8, ss = _quant_digits(torch.cat([W.T, -U.T], dim=1).to(torch.float32), 0)
    return s8[:, :m].contiguous(), s8[:, m:].contiguous(), ss[:, 0]


def _mask_cols(na: torch.Tensor, B: int) -> torch.Tensor:
    """The NA mask as f32[4, Nb, B]: [4, Nb] (one mask for every column) or
    [4, Nb, B] (one per column, the multi-trait form)."""
    na = na.to(torch.float32)
    if na.ndim == 2:
        na = na[:, :, None].expand(*na.shape, B)
    return na.contiguous()


def _check_bands(name: str, nw: int) -> None:
    if nw % GRAM_BAND_NW:
        raise ValueError(f"{name}: Nw={nw} must be a multiple of the "
                         f"{GRAM_BAND_NW}-row band")


def _band_requant(z: torch.Tensor, nw: int):
    """Per-band digits of z[4, Nb, B]: (int8[4, nbands, 4T, NDIG*B] with
    digit-major columns d*B + b, scales [NDIG, nbands, B])."""
    B = z.shape[2]
    T = GRAM_BAND_NW
    r = z.reshape(4, nw // T, 4 * T, B)
    mx = r.abs().amax(dim=(0, 2))                         # [nbands, B]
    r127 = torch.full_like(mx, 127.0)
    s = torch.where(mx == 0, 1.0, mx) / r127
    digits, scales = [], []
    for _ in range(_NDIG):
        scales.append(s)
        d = torch.round(r / s[None, :, None, :])
        digits.append(d.to(torch.int8))
        r = r - d * s[None, :, None, :]
        s = s / r127
    return torch.cat(digits, dim=3), torch.stack(scales)


def _band_transpose_ref(words, z8, scales, plane: int) -> torch.Tensor:
    """sum over bands, in band order, of fold_j(A_j^T z8_j) on one decoded
    plane -> f32[B, Mpad].  Each band's digit products are integers below
    2 * 127 * 16T < 2**24, so an f32 batched product holds them exactly in
    any summation order (with TF32 too: the inputs have at most 7 bits)."""
    nw, m = words.shape
    T = GRAM_BAND_NW
    nb = nw // T
    B = scales.shape[2]
    zt = z8.to(torch.float32).permute(1, 3, 0, 2).reshape(nb, _NDIG * B,
                                                         16 * T)
    parts = torch.empty((nb, B, m), dtype=torch.float32, device=words.device)
    for lo in range(0, m, _REF_BLOCK):
        p = _decode_plane(words[:, lo:lo + _REF_BLOCK], torch.float32, plane)
        w = p.shape[2]
        p = p.reshape(4, nb, 4 * T, w).permute(1, 0, 2, 3).reshape(
            nb, 16 * T, w)
        t = torch.bmm(zt, p).reshape(nb, _NDIG, B, w)
        acc = t[:, 0] * scales[0][:, :, None]
        for d in range(1, _NDIG):
            acc = acc + t[:, d] * scales[d][:, :, None]
        parts[:, :, lo:lo + w] = acc
    av = torch.zeros((B, m), dtype=torch.float32, device=words.device)
    for j in range(nb):
        av = av + parts[j]
    return av


def _gram_chunks(fn, bmax: int, W, na, *cols):
    """``fn(W, na, *cols)`` over column chunks of at most ``bmax`` (a
    per-column mask [4, Nb, B] is cut with them), outputs concatenated
    along their column axis."""
    outs = [fn(W[:, lo:lo + bmax],
               na if na.ndim == 2 else na[:, :, lo:lo + bmax],
               *[c[..., lo:lo + bmax] for c in cols])
            for lo in range(0, W.shape[1], bmax)]
    return tuple(torch.cat(o, dim=-1) for o in zip(*outs))


def gram_i8a_ref(words, W, na_planar, colsum_u):
    """Plain version of ``gram_i8a``: (av[Mpad, B], sv[B]) with
    z = na (A_a W - colsum_u), av = A_a^T z and sv = colsum(z), z
    requantised per band of GRAM_BAND_NW word rows."""
    B = W.shape[1]
    if B > _BMAX_AXM_A:
        return _gram_chunks(lambda *a: gram_i8a_ref(words, *a), _BMAX_AXM_A,
                            W, na_planar, colsum_u)
    nw = words.shape[0]
    _check_bands("gram_i8a_ref", nw)
    w8t, ws = _quant_rows(W)
    z = _fold_digits_zt(axm_i8a_int_ref(words, w8t), ws, B)
    z = ((z - colsum_u.to(torch.float32)) * _mask_cols(na_planar, B)
         ).contiguous()
    z8, scales = _band_requant(z, nw)
    av = _band_transpose_ref(words, z8, scales, 0)
    return av.T, z.sum(dim=(0, 1))


def gram_i8_ref(words, W, U, na_planar):
    """Plain version of ``gram_i8``: (av, bv)[Mpad, B] with
    z = na (A_a W - A_b U) (W and -U under one shared digit scale per
    column), av = A_a^T z and bv = A_b^T z, z requantised per band."""
    B = W.shape[1]
    if B > _BMAX_AXM:
        return _gram_chunks(lambda W_, na_, U_: gram_i8_ref(words, W_, U_,
                                                            na_),
                            _BMAX_AXM, W, na_planar, U)
    nw = words.shape[0]
    _check_bands("gram_i8_ref", nw)
    w8t, mu8t, ws = _quant_digits_pair(W, U)
    z32 = axm_i8s_int_ref(words, w8t, mu8t)
    z = (_fold_digits_zt(z32, ws, B) * _mask_cols(na_planar, B)).contiguous()
    z8, scales = _band_requant(z, nw)
    return (_band_transpose_ref(words, z8, scales, 0).T,
            _band_transpose_ref(words, z8, scales, 1).T)


def gram_blocks(device: torch.device) -> int:
    """Persistent blocks of the fused primal Gram: one per SM of the card,
    GRAM_BLOCKS_H100 for words on the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return GRAM_BLOCKS_H100


def gram_smem_bytes(mpad: int, nblocks: int) -> int:
    """Shared memory of one fused-primal-Gram block (csrc/gram_prim.cu
    prim_smem_bytes): the ring of GRAM_RING band tiles, GRAM_BAND_NW rows
    of the block's 4 rq words each at a pitch of 4 rq + 24 words rounded
    up to 32 (each row shifted by up to 24 words), the forward digit tile
    (2 x 8 rows of 4 rq bytes rounded up to 128, plus 16), then 10,976
    bytes of barriers, the forward tile, the band's digits and the
    scales."""
    rq = -(-(mpad // 4) // nblocks)
    pitch = -(-(4 * rq + 24) // 32) * 32
    dig_pitch = -(-(4 * rq) // 128) * 128 + 16
    return (10_976 + 4 * GRAM_RING * GRAM_BAND_NW * pitch
            + 2 * 8 * dig_pitch)


def gram_fits(words: torch.Tensor) -> bool:
    """Whether the fused primal Gram takes these words: whole bands, whole
    marker quads and at most GRAM_MAX_QUADS quads per block (Mpad up to
    135,168 on 132 SMs; the block's shared memory then fits
    GRAM_AAT_SMEM_BUDGET)."""
    nw, m = words.shape
    return (nw % GRAM_BAND_NW == 0 and m % 4 == 0
            and -(-(m // 4) // gram_blocks(words.device)) <= GRAM_MAX_QUADS)


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
    # the kernels read the words, the digit tensors the wrappers make
    # (contiguous, freshly allocated) and, for the single-vector products,
    # the vectors once the wrappers have made them contiguous
    if not words.is_contiguous() or words.data_ptr() % 16:
        raise ValueError(f"{name}: words must be contiguous and 16-byte "
                         f"aligned")
    if words.shape[1] % 4:
        raise ValueError(f"{name}: Mpad={words.shape[1]} must be a multiple "
                         f"of 4")


def _check_bound(name: str, k: int, per_term: int = 254) -> None:
    """|sum| <= per_term*K for a contraction of length K must fit int32:
    254 = 2*127 for one plane against digits, 381 = 2*127 + 127 for both
    planes in one sum (axm_i8s)."""
    if per_term * k >= _I32_LIMIT:
        raise ValueError(f"{name}: contraction length {k} overflows the int32 "
                         f"accumulator ({per_term}*K must stay below 2**31)")


def _launch(name: str, fn, device: torch.device, *args) -> None:
    """Launch on PyTorch's current stream; raise on the launch's error code
    (``cudaGetLastError`` right after the launch, returned by the C side)."""
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name] += 1
    trace.LAUNCHED["count"] += 1


@_product
def axm_i8a(words: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """A_a @ W -> f32[4, Nb, B] on complete genotypes; the caller subtracts
    the b-side scalar colsum(mave W).

    One launch for any B: the kernel spreads digit groups over its grid, and
    quantisation is per column, so the JAX wrapper's column chunking
    (``_BMAX_AXM_A``) would not change a value."""
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
    return _fold_digits_zt(zt, ws, W.shape[1])


@_product
def atxm_i8a(words: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """A_a^T V -> f32[Mpad, B] on complete genotypes; the caller subtracts
    mave * colsum(V)."""
    if words.device.type == "cpu":
        return atxm_i8a_ref(words, V)
    _check_cuda("atxm_i8a", words, V, torch.float32)
    nw, m = words.shape
    if V.ndim != 3 or V.shape[:2] != (4, 4 * nw):
        raise ValueError(f"atxm_i8a: V must be [4, {4 * nw}, B], got "
                         f"{list(V.shape)}")
    _check_bound("atxm_i8a", 16 * nw)
    v8, s0 = _quant_digits_t(V)
    av = torch.zeros((v8.shape[1], m), dtype=torch.int32, device=words.device)
    from gvamp_tpu_torch.ops import _build
    _launch("atxm_i8a", _build.library().gvamp_atxm_i8a, words.device,
            words.data_ptr(), v8.data_ptr(), av.data_ptr(), nw, m, v8.shape[1])
    return _fold_digits_t(av, s0, V.shape[2])


@_product
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


@_product
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


def atx_launch(name: str, words: torch.Tensor, v_planar: torch.Tensor):
    """The checks and operands of one ``atx`` (both sides) or ``atx_a``
    (a-side) launch: (kernel, arguments, finish).  The kernel writes one
    f32 partial row per row band; ``finish()`` sums them, after the launch,
    in a fixed order.  The bare launch of tools/profile_kernels.py uses it
    too."""
    _check_cuda(name, words, v_planar, torch.float32)
    nw, m = words.shape
    if tuple(v_planar.shape) != (4, 4 * nw):
        raise ValueError(f"{name}: v must be [4, {4 * nw}], got "
                         f"{list(v_planar.shape)}")
    v = v_planar.contiguous()  # the kernel reads v itself
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    out = torch.empty((2 if name == "atx" else 1, lib.gvamp_atx_parts(nw, m),
                       m), dtype=torch.float32, device=words.device)
    args = (words.data_ptr(), v.data_ptr(), out.data_ptr(), nw, m)

    # finish holds v, so that it lives as long as a launch may read it; the
    # per-band partial rows meet here, in a fixed order: deterministic
    def finish(_operands=(v,)):
        s = out.sum(dim=1)
        return (s[0], s[1]) if name == "atx" else s[0]

    return getattr(lib, f"gvamp_{name}"), args, finish


@_product
def atx(words: torch.Tensor, v_planar: torch.Tensor):
    """(A_a^T v, A_b^T v) -> f32[Mpad] x2 for one planar vector v[4, Nb].

    With v = 1 on the real samples, bv counts each marker's non-missing
    calls, exactly in f32 while the 16*Nw samples stay below 2**24."""
    if 16 * words.shape[0] >= 2 ** 24:
        raise ValueError(f"atx: {16 * words.shape[0]} samples; the f32 sums "
                         f"are exact counts only below 2**24")
    if words.device.type == "cpu":
        return atx_ref(words, v_planar, torch.float32)
    fn, args, finish = atx_launch("atx", words, v_planar)
    _launch("atx", fn, words.device, *args)
    return finish()


def ax_launch(words: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """The checks and operands of one ``ax`` launch: (kernel, arguments,
    finish), as ``atx_launch``.  The kernel reads w and u in marker pairs
    (8-byte loads): a vector that is contiguous and 8-byte aligned is read
    in place, any other through a contiguous copy."""
    _check_cuda("ax", words, w, torch.float32)
    _check_cuda("ax", words, u, torch.float32)
    nw, m = words.shape
    if tuple(w.shape) != (m,) or tuple(u.shape) != (m,):
        raise ValueError(f"ax: w and u must be [{m}], got {list(w.shape)} "
                         f"and {list(u.shape)}")
    wc, uc = (x if x.is_contiguous() and x.data_ptr() % 8 == 0
              else x.clone(memory_format=torch.contiguous_format)
              for x in (w, u))
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    out = torch.empty((lib.gvamp_ax_parts(nw, m), 4, 4 * nw),
                      dtype=torch.float32, device=words.device)
    args = (words.data_ptr(), wc.data_ptr(), uc.data_ptr(), out.data_ptr(),
            nw, m)

    # finish holds the vectors read, as atx_launch's holds v; the per-band
    # partial rows meet here, in a fixed order: deterministic
    def finish(_operands=(wc, uc)):
        return out.sum(dim=0)

    return lib.gvamp_ax, args, finish


@_product
def ax(words: torch.Tensor, w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """z[4, Nb] = sum_m a_k[m, p] w[m] - b_k[m, p] u[m] in f32 (the raw
    single-vector product of the people statistics)."""
    if words.device.type == "cpu":
        return ax_ref(words, w, u, torch.float32)
    fn, args, finish = ax_launch(words, w, u)
    _launch("ax", fn, words.device, *args)
    return finish()


@_product
def atx_a(words: torch.Tensor, v_planar: torch.Tensor) -> torch.Tensor:
    """A_a^T v -> f32[Mpad] for one planar vector v[4, Nb]; on complete
    genotypes the caller takes the b-side as sum(v)."""
    if words.device.type == "cpu":
        return atx_a_ref(words, v_planar)
    fn, args, finish = atx_launch("atx_a", words, v_planar)
    _launch("atx_a", fn, words.device, *args)
    return finish()


def marker_counts(words: torch.Tensor,
                  na_planar: torch.Tensor) -> torch.Tensor:
    """int64[3, M]: the integer counts (S_a, S_b, S_aa) of every marker
    of ``words`` (int32[Nw, M]) over the slots where ``na_planar`` ([4,
    Nb]) is not 0, in one read of the words (the ``marker_counts`` kernel
    of ``csrc/counts.cu``); the plain version on the CPU.  No block or
    chunk has to divide Nw or M."""
    nw, m = words.shape
    if tuple(na_planar.shape) != (4, 4 * nw):
        raise ValueError(f"marker_counts: na must be [4, {4 * nw}], got "
                         f"{list(na_planar.shape)}")
    if words.device.type == "cpu":
        return marker_counts_ref(words, na_planar)
    mask = na_mask_words(na_planar)
    _check_cuda("marker_counts", words, mask, torch.int32)
    # S_aa <= 4 * 16 Nw: dosage 2 squared, 16 samples a word row
    _check_bound("marker_counts", nw, per_term=64)
    out = torch.zeros((3, m), dtype=torch.int32, device=words.device)
    from gvamp_tpu_torch.ops import _build
    _launch("marker_counts", _build.library().gvamp_marker_counts,
            words.device, words.data_ptr(), mask.data_ptr(), out.data_ptr(),
            nw, m)
    return out.to(torch.int64)


@_product
def axm_i8s(words: torch.Tensor, W: torch.Tensor,
            U: torch.Tensor) -> torch.Tensor:
    """A_a @ W - A_b @ U -> f32[4, Nb, B] on genotypes with missing calls,
    with W and -U quantised at one shared scale per column and both planes'
    digit products in one int32 sum, folded once.

    One launch for any B, as ``axm_i8``: the quantisation is per column, so
    the JAX wrapper's column chunking (``_BMAX_AXM``) would not change a
    value."""
    if words.device.type == "cpu":
        return axm_i8s_ref(words, W, U)
    _check_cuda("axm_i8s", words, W, torch.float32)
    _check_cuda("axm_i8s", words, U, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m or U.shape != W.shape:
        raise ValueError(f"axm_i8s: W and U must be [{m}, B], got "
                         f"{list(W.shape)} and {list(U.shape)}")
    _check_bound("axm_i8s", m, 381)
    w8t, mu8t, ws = _quant_digits_pair(W, U)
    D = w8t.shape[0]
    zt = torch.zeros((D, 4, 4 * nw), dtype=torch.int32, device=words.device)
    from gvamp_tpu_torch.ops import _build
    _launch("axm_i8s", _build.library().gvamp_axm_i8s, words.device,
            words.data_ptr(), w8t.data_ptr(), mu8t.data_ptr(), zt.data_ptr(),
            nw, m, D)
    return _fold_digits_zt(zt, ws, W.shape[1])


def bf16_group(B: int) -> int:
    """Columns per group of the bf16-split kernels at width B (group_cols
    in csrc/bf16_split.cu): the mma's 8 n hold the three parts of 1 column
    at B = 1 and of 2 columns otherwise, one group per gridDim.z."""
    return 1 if B == 1 else 2


def _pad_cols(x: torch.Tensor, cg: int) -> torch.Tensor:
    """x [..., B] with zero columns up to whole groups of ``cg``."""
    B = x.shape[-1]
    return torch.nn.functional.pad(x, (0, -(-B // cg) * cg - B))


# each quad of markers (people) as the bf16-split kernels' B fragments
# hold it: an A register of theirs pairs a quad's values 0 and 2, or 1 and 3
_BF16_QUAD = [0, 2, 1, 3]


def _pow2(n: torch.Tensor) -> torch.Tensor:
    """2^n as float32 for integers n in [-126, 127], exact: the exponent
    bits."""
    return ((n.to(torch.int32) + 127) << 23).view(torch.float32)


def _times_pow2(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x 2^n, exact (barring overflow and subnormal results), for integers
    n in [-252, 254] broadcast against x: two factors within f32's range."""
    h = torch.div(n, 2, rounding_mode="floor")
    return x * _pow2(h) * _pow2(n - h)


def bf16_exponents(*xs: torch.Tensor) -> torch.Tensor:
    """Per column (the last dimension): the exponent E with max |x| < 2^E
    over the xs (0 for a zero column), clamped to [-125, 128].  The
    bf16-split kernels read their A fragments as bf16 values a 4^k 2^-133
    (csrc/bf16_split.cu), so the wrappers scale each column of the
    right-hand side by 2^(127 - E), its largest value just below 2^127,
    and the results by 2^(E + 6): both exact, and every product and
    partial sum between lies in f32's normal range, rounding as the
    unscaled one does."""
    m = torch.stack([x.abs().reshape(-1, x.shape[-1]).amax(0) for x in xs])
    return torch.frexp(m.amax(0))[1].clamp(-125, 128)


def bf16_fold_z(out: torch.Tensor, B: int, E: torch.Tensor) -> torch.Tensor:
    """``axm_bf16``'s partial rows f32 [P, G, 3, cg, 4, Nb] -> [4, Nb, B]:
    the marker parts summed in a fixed order (deterministic), then the
    parts as (hi + mid) + lo, the padding columns dropped and each column
    scaled back by 2^(E + 6)."""
    s = out.sum(dim=0)
    z = _sum_parts3(s[:, 0], s[:, 1], s[:, 2])    # [G, cg, 4, Nb]
    z = z.reshape(-1, *z.shape[2:])[:B].permute(1, 2, 0)
    return _times_pow2(z, E + 6).contiguous()


def bf16_fold_v(out: torch.Tensor, B: int, E: torch.Tensor):
    """``atxm_bf16``'s partial rows f32 [2, P, G, 3, cg, Mpad] -> (av, bv)
    f32 [Mpad, B] each, summed and scaled back as ``bf16_fold_z`` does."""
    s = out.sum(dim=1)
    r = _sum_parts3(s[:, :, 0], s[:, :, 1], s[:, :, 2])  # [2, G, cg, Mpad]
    av, bv = _times_pow2(r.reshape(2, -1, r.shape[-1])[:, :B].transpose(1, 2),
                         E + 6)
    return av, bv


def axm_bf16_operands(W: torch.Tensor, U: torch.Tensor, cg: int):
    """The forward kernel's right-hand side, bf16 [G, 3 cg, Mpad/4, 2, 4],
    and E: row p*cg + c of group z holds part p (hi, mid, lo) of column
    z*cg + c of W 2^s and of -U 2^s (s = 127 - E per column,
    ``bf16_exponents`` of W and U together), interleaved per marker quad (a
    lane's fragments of both are one 16-byte copy), each quad in the order
    0, 2, 1, 3; zero columns pad B to G*cg."""
    E = bf16_exponents(W, U)
    M = W.shape[0]
    w2, u2 = (_split_hi_lo(_pad_cols(_times_pow2(x, 127 - E), cg), 1)
              for x in (W, -U))                   # [M, 3 G cg] each
    G = w2.shape[1] // (3 * cg)
    rows = torch.stack([w2, u2]).reshape(2, M // 4, 4, 3, G, cg)
    return (rows[:, :, _BF16_QUAD].permute(4, 3, 5, 1, 0, 2)
            .reshape(G, 3 * cg, M // 4, 2, 4).contiguous(), E)


def atxm_bf16_operands(V: torch.Tensor, cg: int):
    """The transpose kernel's right-hand side, bf16 [G, 3 cg, Nb/4, 4, 4],
    and E: row p*cg + c of group z holds part p of column z*cg + c of V's
    plane k times 2^(s - 2k) (s = 127 - E per column; the A values of plane
    k carry 4^k), the 4 planes of a person quad together (32 contiguous
    bytes a lane and row set), each quad in the order 0, 2, 1, 3; zero
    columns pad B to G*cg."""
    E = bf16_exponents(V)
    k = torch.arange(4, device=V.device).view(4, 1, 1)
    v2 = _split_hi_lo(_pad_cols(_times_pow2(V, 127 - E - 2 * k), cg), 2)
    nb = V.shape[1]
    G = v2.shape[2] // (3 * cg)
    planes = v2.reshape(4, nb // 4, 4, 3, G, cg)[:, :, _BF16_QUAD]
    return (planes.permute(4, 3, 5, 1, 0, 2)
            .reshape(G, 3 * cg, nb // 4, 4, 4).contiguous(), E)


def _bf16_parts(lib_parts, name: str, nw: int, m: int, B: int) -> int:
    parts = lib_parts(nw, m, B)
    if parts <= 0:
        raise RuntimeError(f"{name}: grid query failed with CUDA error "
                           f"{-parts}")
    return parts


@_product
def axm_bf16(words: torch.Tensor, W: torch.Tensor,
             U: torch.Tensor) -> torch.Tensor:
    """A_a @ W - A_b @ U -> f32[4, Nb, B] from the three bf16 parts of W
    and U; columns in chunks of ``_BMAX_BF16``, as ``axm_pallas``.

    The kernel writes one partial row set per part of the markers and per
    part (hi, mid, lo); they meet here in a fixed order, the parts last as
    (hi + mid) + lo."""
    B = W.shape[1]
    if B > _BMAX_BF16:
        return torch.cat([axm_bf16(words, W[:, lo:lo + _BMAX_BF16],
                                   U[:, lo:lo + _BMAX_BF16])
                          for lo in range(0, B, _BMAX_BF16)], dim=2)
    if words.device.type == "cpu":
        return axm_bf16_ref(words, W, U)
    _check_cuda("axm_bf16", words, W, torch.float32)
    _check_cuda("axm_bf16", words, U, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m or U.shape != W.shape:
        raise ValueError(f"axm_bf16: W and U must be [{m}, B], got "
                         f"{list(W.shape)} and {list(U.shape)}")
    cg = bf16_group(B)
    # the parts of W and of -U (negating a bf16 part is exact): one sum
    rhs, E = axm_bf16_operands(W, U, cg)
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    P = _bf16_parts(lib.gvamp_axm_bf16_parts, "axm_bf16", nw, m, B)
    out = torch.empty((P, rhs.shape[0], 3, cg, 4, 4 * nw),
                      dtype=torch.float32, device=words.device)
    _launch("axm_bf16", lib.gvamp_axm_bf16, words.device, words.data_ptr(),
            rhs.data_ptr(), out.data_ptr(), nw, m, B)
    return bf16_fold_z(out, B, E)


@_product
def atxm_bf16(words: torch.Tensor, V: torch.Tensor):
    """(A_a^T V, A_b^T V) -> f32[Mpad, B] x2 from the three bf16 parts of
    V; columns in chunks of ``_BMAX_BF16``, as ``atxm_pallas``."""
    B = V.shape[2]
    if B > _BMAX_BF16:
        outs = [atxm_bf16(words, V[:, :, lo:lo + _BMAX_BF16])
                for lo in range(0, B, _BMAX_BF16)]
        return tuple(torch.cat(o, dim=1) for o in zip(*outs))
    if words.device.type == "cpu":
        return atxm_bf16_ref(words, V)
    _check_cuda("atxm_bf16", words, V, torch.float32)
    nw, m = words.shape
    if V.ndim != 3 or V.shape[:2] != (4, 4 * nw):
        raise ValueError(f"atxm_bf16: V must be [4, {4 * nw}, B], got "
                         f"{list(V.shape)}")
    cg = bf16_group(B)
    v2, E = atxm_bf16_operands(V, cg)
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    P = _bf16_parts(lib.gvamp_atxm_bf16_parts, "atxm_bf16", nw, m, B)
    G = v2.shape[0]
    out = torch.empty((2, P, G, 3, cg, m), dtype=torch.float32,
                      device=words.device)
    _launch("atxm_bf16", lib.gvamp_atxm_bf16, words.device, words.data_ptr(),
            v2.data_ptr(), out.data_ptr(), nw, m, B)
    return bf16_fold_v(out, B, E)


def gram_aat_launch(name: str, words, V, mave, msig2):
    """The checks and operands of one fused-dual-Gram launch:
    (kernel, arguments, finish).  The kernel takes V's digits int8[4, 4B,
    Nb] with row 4b + d (one column's digits together; the digit rows of
    _quant_digits_t reordered), their scales, and writes the group sums
    f32[nJ/G, B, 4, Nb] (and, for ``gram_aat_i8a``, W itself); ``finish()``
    turns them, after the launch, into the wrapper's result with the plain
    version's own torch ops.  The bare launch of tools/profile_kernels.py
    uses it too."""
    _check_cuda(name, words, V, torch.float32)
    nw, m = words.shape
    if V.ndim != 3 or V.shape[:2] != (4, 4 * nw):
        raise ValueError(f"{name}: V must be [4, {4 * nw}, B], got "
                         f"{list(V.shape)}")
    for x in (mave, msig2):
        _check_cuda(name, words, x, torch.float32)
        if tuple(x.shape) != (m,):
            raise ValueError(f"{name}: mave and msig2 must be [{m}]")
    _check_stripes(name, m)
    if not gram_aat_fits(nw, m):
        raise ValueError(f"{name}: Nw={nw} word rows exceed GRAM_AAT_MAX_NW="
                         f"{GRAM_AAT_MAX_NW}")
    _check_bound(name, 16 * nw)
    _check_bound(name, 2 * GRAM_AAT_STRIPE)
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    if (lib.gvamp_gram_aat_stripe(), lib.gvamp_gram_aat_group(),
            lib.gvamp_gram_aat_smem(nw)) != (
            GRAM_AAT_STRIPE, GRAM_AAT_GROUP, gram_aat_smem_bytes(nw)):
        raise RuntimeError(f"{name}: csrc/gram_aat.cu and ops/matvec.py "
                           f"disagree on the stripe, the group or the shared "
                           f"memory")
    B = V.shape[2]
    v8, vs = _quant_digits_t(V)
    vdig = v8.reshape(4, _NDIG, B, 4 * nw).transpose(1, 2).contiguous()
    vsc = _digit_scales(vs).contiguous()
    mv, ms2 = mave.contiguous(), msig2.contiguous()
    n_groups = -(-(m // GRAM_AAT_STRIPE) // GRAM_AAT_GROUP)
    zpart = torch.empty((n_groups, B, 4, 4 * nw), dtype=torch.float32,
                        device=words.device)
    head = (words.data_ptr(), vdig.data_ptr(), vsc.data_ptr())
    if name == "gram_aat_i8a":
        sv = V.to(torch.float32).sum(dim=(0, 1))
        W = torch.empty((B, m), dtype=torch.float32, device=words.device)
        args = (*head, sv.data_ptr(), mv.data_ptr(), ms2.data_ptr(),
                zpart.data_ptr(), W.data_ptr(), nw, m, B)

        # finish holds the operands, so that they live as long as a launch
        # with ``args`` may read them
        def finish(_operands=(vdig, vsc, sv, mv, ms2)):
            return (_gram_group_sum(zpart)
                    - (W * mave[None, :]).sum(dim=1)[None, None, :])
    else:
        args = (*head, mv.data_ptr(), ms2.data_ptr(), zpart.data_ptr(), nw, m,
                B)

        def finish(_operands=(vdig, vsc, mv, ms2)):
            return _gram_group_sum(zpart)
    return getattr(lib, f"gvamp_{name}"), args, finish


@_product
def gram_aat_i8a(words: torch.Tensor, V: torch.Tensor, mave: torch.Tensor,
                 msig2: torch.Tensor) -> torch.Tensor:
    """Fused dual Gram on complete genotypes, one read of the words:
    z[4, Nb, B] = A_a W - colsum(mave W), W = msig2 (A_a^T V - sv mave),
    sv = colsum(V).  ``V`` is already NA-masked; the caller applies
    na * scale^2.  The kernel writes one f32 sum per group of stripes and W
    itself; the sum over the groups and colsum(mave W) run here, as in the
    plain version."""
    if words.device.type == "cpu":
        return gram_aat_i8a_ref(words, V, mave, msig2)
    fn, args, finish = gram_aat_launch("gram_aat_i8a", words, V, mave, msig2)
    _launch("gram_aat_i8a", fn, words.device, *args)
    return finish()


@_product
def gram_aat_i8(words: torch.Tensor, V: torch.Tensor, mave: torch.Tensor,
                msig2: torch.Tensor) -> torch.Tensor:
    """Fused dual Gram on genotypes with missing calls, one read of the
    words: z[4, Nb, B] = A_a W - A_b (mave W) with
    W = msig2 (A_a^T V - mave A_b^T V)."""
    if words.device.type == "cpu":
        return gram_aat_i8_ref(words, V, mave, msig2)
    fn, args, finish = gram_aat_launch("gram_aat_i8", words, V, mave, msig2)
    _launch("gram_aat_i8", fn, words.device, *args)
    return finish()


def gram_launch(name: str, words, W, na_planar, other):
    """The checks and operands of one fused-primal-Gram launch of at most
    one column chunk (64 columns for ``gram_i8a``, 32 for ``gram_i8``):
    (kernel, arguments, finish).  ``other`` is colsum_u [B] for
    ``gram_i8a`` and U [Mpad, B] for ``gram_i8``.  The kernel takes the
    digits of W (and of -U, under W's shared scale) int8[4B, Mpad] with row
    4b + d (the digit rows of _quant_rows / _quant_digits_pair reordered so
    that a column's digits lie together), their scales f32[4, B], the mask
    f32[4, Nb, B], a zeroed int32 scratch of counters and partial slots
    (zero again after a launch), and adds into av (and bv) f32[B, Mpad],
    zeroed here; ``gram_i8a`` also writes z f32[4, Nb, B].  ``finish()``
    turns them, after the launch, into the wrapper's result (sv = colsum(z)
    with the plain version's torch.sum).  The bare launch of
    tools/profile_kernels.py uses it too."""
    _check_cuda(name, words, W, torch.float32)
    nw, m = words.shape
    if W.ndim != 2 or W.shape[0] != m:
        raise ValueError(f"{name}: W must be [{m}, B], got {list(W.shape)}")
    B = W.shape[1]
    bmax = _BMAX_AXM_A if name == "gram_i8a" else _BMAX_AXM
    if B > bmax:
        raise ValueError(f"{name}: B={B} above the {bmax}-column chunk")
    if name == "gram_i8" and other.shape != W.shape:
        raise ValueError(f"gram_i8: W and U must have one shape, got "
                         f"{list(W.shape)} and {list(other.shape)}")
    if tuple(na_planar.shape[:2]) != (4, 4 * nw) or \
            na_planar.ndim not in (2, 3) or (
            na_planar.ndim == 3 and na_planar.shape[2] != B):
        raise ValueError(f"{name}: the mask must be [4, {4 * nw}] or "
                         f"[4, {4 * nw}, B], got {list(na_planar.shape)}")
    for x in (na_planar, other):
        _check_cuda(name, words, x, torch.float32)
    _check_bands(name, nw)
    nblocks = gram_blocks(words.device)
    if not gram_fits(words):
        raise ValueError(f"{name}: Mpad={m} gives more than GRAM_MAX_QUADS="
                         f"{GRAM_MAX_QUADS} marker quads to each of "
                         f"{nblocks} blocks")
    _check_bound(name, 2 * m)
    _check_bound(name, 16 * GRAM_BAND_NW)
    from gvamp_tpu_torch.ops import _build
    lib = _build.library()
    if lib.gvamp_gram_band_nw() != GRAM_BAND_NW or \
            lib.gvamp_gram_smem(m, nblocks) != gram_smem_bytes(m, nblocks):
        raise RuntimeError(f"{name}: csrc/gram_prim.cu and ops/matvec.py "
                           f"disagree on the band or its shared memory")
    dev = words.device

    def rows(d8):
        return d8.reshape(_NDIG, B, m).transpose(0, 1).reshape(
            _NDIG * B, m).contiguous()

    na = _mask_cols(na_planar, B)
    scratch = torch.zeros(lib.gvamp_gram_scratch_ints(B), dtype=torch.int32,
                          device=dev)
    av = torch.zeros((B, m), dtype=torch.float32, device=dev)
    if name == "gram_i8a":
        w8t, ws = _quant_rows(W)
        wd = rows(w8t)
        wsc = _digit_scales(ws).contiguous()
        cu = other.to(torch.float32).contiguous()
        z = torch.empty((4, 4 * nw, B), dtype=torch.float32, device=dev)
        args = (words.data_ptr(), wd.data_ptr(), wsc.data_ptr(),
                cu.data_ptr(), na.data_ptr(), scratch.data_ptr(),
                z.data_ptr(), av.data_ptr(), nw, m, B, nblocks)

        # finish holds the operands, so that they live as long as a launch
        # with ``args`` may read them
        def finish(_operands=(wd, wsc, cu, na, scratch)):
            return av.T, z.sum(dim=(0, 1))
    else:
        w8t, mu8t, ws = _quant_digits_pair(W, other)
        wd, ud = rows(w8t), rows(mu8t)
        wsc = _digit_scales(ws).contiguous()
        bv = torch.zeros_like(av)
        args = (words.data_ptr(), wd.data_ptr(), ud.data_ptr(),
                wsc.data_ptr(), na.data_ptr(), scratch.data_ptr(),
                av.data_ptr(), bv.data_ptr(), nw, m, B, nblocks)

        def finish(_operands=(wd, ud, wsc, na, scratch)):
            return av.T, bv.T
    return getattr(lib, f"gvamp_{name}"), args, finish


@_product
def gram_i8a(words: torch.Tensor, W: torch.Tensor, na_planar: torch.Tensor,
             colsum_u: torch.Tensor):
    """Fused primal Gram on complete genotypes, one read of the words:
    (av[Mpad, B], sv[B]) with z = na (A_a W - colsum_u), av = A_a^T z and
    sv = colsum(z).  The caller applies the mave / msig / scale^2
    corrections as for atxm_i8a(axm_i8a(.)).  ``na_planar`` is [4, Nb] or
    [4, Nb, B].  The kernel writes z; sv is its torch.sum, as in the plain
    version."""
    B = W.shape[1]
    if B > _BMAX_AXM_A:
        return _gram_chunks(lambda *a: gram_i8a(words, *a), _BMAX_AXM_A, W,
                            na_planar, colsum_u)
    if words.device.type == "cpu":
        return gram_i8a_ref(words, W, na_planar, colsum_u)
    fn, args, finish = gram_launch("gram_i8a", words, W, na_planar, colsum_u)
    _launch("gram_i8a", fn, words.device, *args)
    return finish()


@_product
def gram_i8(words: torch.Tensor, W: torch.Tensor, U: torch.Tensor,
            na_planar: torch.Tensor):
    """Fused primal Gram on genotypes with missing calls, one read of the
    words: (av, bv)[Mpad, B] with z = na (A_a W - A_b U), av = A_a^T z and
    bv = A_b^T z; W and -U share one digit scale per column.  The caller
    forms (av - mave bv) msig scale^2."""
    B = W.shape[1]
    if B > _BMAX_AXM:
        return _gram_chunks(lambda W_, na_, U_: gram_i8(words, W_, U_, na_),
                            _BMAX_AXM, W, na_planar, U)
    if words.device.type == "cpu":
        return gram_i8_ref(words, W, U, na_planar)
    fn, args, finish = gram_launch("gram_i8", words, W, na_planar, U)
    _launch("gram_i8", fn, words.device, *args)
    return finish()
