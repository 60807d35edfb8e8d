"""The lane maps of the fragment kernels (gvamp_tpu_torch/csrc/fragments.cu),
checked on the CPU, where the kernels cannot run.

A numpy emulator follows each kernel's loop as the source writes it: which
lane (g, t) of which warp loads which 16 bytes of the words and which u32
of the digits, the byte transpose and the SWAR decode that turn them into
A fragments (each plane at the top of its bytes, 64 times its value), the
mma.sync m16n8k32 u8 x s8 -> s32 semantics (the PTX fragment layout), the
parts of the contraction (int32 sums, shifted back by 6 at each part's
end) and the index each C fragment is added to.  Like the kernels, each
emulator has a compile-time form: both planes for the products on
genotypes with missing calls (axm_i8, atxm_i8), the a-plane alone for those
on complete genotypes (axm_i8a, atxm_i8a), and, forward, both planes into
one sum (axm_i8s, W and -U under one scale).  Its integers must equal the
port's plain versions (axm_i8_int_ref, atxm_i8_int_ref, axm_i8a_int_ref,
atxm_i8a_int_ref, axm_i8s_int_ref) and the JAX package's kernel bodies in
interpret mode; folded, they must match axm_i8_pallas / atxm_i8_pallas /
axm_i8a_pallas / atxm_i8a_pallas / axm_i8s_pallas as
tests/test_torch_matvec.py holds the port's wrappers.
The shapes are the edges the kernels' grids must cover:
Nw not a multiple of 8 or of a block's rows, Mpad not a multiple of a
step, D not a multiple of 8, and B = 22 (11 digit groups); at the
largest sums (every call a = 2, every digit 127) the longest part keeps
its 64-fold sum inside int32."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from test_torch_matvec import (FOLD_TOL, _close, _jax_atxm_i8_int,
                               _jax_atxm_int, _jax_axm_i8_int, _jax_axm_int,
                               _t, _words)
from test_torch_tools import _jax_axm_i8s_int

M1, M3, M5 = 0x01010101, 0x03030303, 0x55555555

# the kernels' constants (fragments.cu)
SCALE_SHIFT = 6                      # plane64: 64 times each value
SCALED_TERM = (2 << SCALE_SHIFT) * 127
FW_STEP, FW_SPLIT = 32, 4            # axm_i8: markers per step, warps per
#                                      group of 8 word rows
FW_MAX_STEPS = (2**31 - 1) // (32 * SCALED_TERM)
# axm_i8s: both planes in one sum, each term at most 64 x (2*127 + 127)
SHARED_TERM = (3 << SCALE_SHIFT) * 127
FW_SHARED_MAX_STEPS = (2**31 - 1) // (32 * SHARED_TERM)
TX_THREADS, TX_LOADS = 256, 2        # atxm_i8: threads, loads per row
TX_WARP_MARKERS = 32 * TX_LOADS
TX_MARKERS = TX_WARP_MARKERS * (TX_THREADS // 32)
TX_MAX_STEPS = (2**31 - 1) // (128 * SCALED_TERM)

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4


# --------------------------------------------------------------------------
# device helpers (swar.cuh, mma.cuh), on uint32 arrays
# --------------------------------------------------------------------------


def swar_a_fields(w):
    notlo = ~w & M5
    return ((notlo << 1) - ((w >> 1) & notlo)) & 0xFFFFFFFF


def swar_b_fields(w):
    return (~w | (w >> 1)) & M5


def plane(f, k):
    return (f >> (2 * k)) & M3


def plane64(f, k):
    return (f << (6 - 2 * k)) & 0xC0C0C0C0


def transpose_quad(x):
    """x [..., 4] uint32 words of four markers -> y [..., 4]: byte j of
    y[b] is byte b of word j (the __byte_perm sequence's result)."""
    by = (x[..., :, None] >> (8 * np.arange(4, dtype=np.int64))) & 0xFF
    # by[..., j, b]: byte b of word j
    return (by << (8 * np.arange(4, dtype=np.int64))[:, None]).sum(axis=-2)


def _bytes(r, signed=True):
    """uint32 [...] -> int8 (or uint8) values [..., 4] in byte order."""
    u = ((r[..., None] >> (8 * np.arange(4))) & 0xFF).astype(np.uint8)
    return (u.view(np.int8) if signed else u).astype(np.int64)


def wrap32(x):
    """int64 -> the int32 an accumulator of that sum holds."""
    return (x + 2**31) % 2**32 - 2**31


# the PTX fragment layout of m16n8k32 .s8: lane 4g+t holds A rows g (a0,
# a2) and g+8 (a1, a3) at columns 4t..4t+3 (a0, a1) and 16+4t.. (a2, a3);
# B column g at rows 4t.. (b0) and 16+4t.. (b1); C rows g (c0, c1) and
# g+8 (c2, c3) at columns 2t and 2t+1
_row, _col = np.meshgrid(np.arange(16), np.arange(32), indexing="ij")
A_LANE = 4 * (_row % 8) + (_col % 16) // 4
A_REG = _row // 8 + 2 * (_col // 16)
A_BYTE = _col % 4
_k, _n = np.meshgrid(np.arange(32), np.arange(8), indexing="ij")
B_LANE = 4 * _n + (_k % 16) // 4
B_REG = _k // 16
B_BYTE = _k % 4
C_ROW = G[:, None] + 8 * (np.arange(4)[None, :] // 2)
C_COL = 2 * T[:, None] + np.arange(4)[None, :] % 2


def mma(c, a, b, a_signed=False):
    """c [..., 32, 4] int64 += the warp's m16n8k32 product of the lanes'
    A registers a [..., 32, 4] (u8, or s8 with ``a_signed``) and B
    registers b [..., 32, 2] (s8), all uint32."""
    ab, bb = _bytes(a, a_signed), _bytes(b)
    A = ab[..., A_LANE, A_REG, A_BYTE]          # [..., 16, 32]
    B = bb[..., B_LANE, B_REG, B_BYTE]          # [..., 32, 8]
    return c + (A @ B)[..., C_ROW, C_COL]


def _u32(b8, idx):
    """The u32 at byte offsets ``idx`` [...] (multiples of 4) of the int8
    row array b8 [R, L], little-endian, as uint32 [...]; idx rows/cols are
    given as a pair of arrays."""
    r, o = idx
    by = b8.view(np.uint8).astype(np.int64)
    return sum(by[r, o + j] << (8 * j) for j in range(4))


# --------------------------------------------------------------------------
# the kernels' loops
# --------------------------------------------------------------------------


def _parts(steps, per_part):
    return [(lo, min(steps, lo + per_part)) for lo in range(0, steps, per_part)]


def emulate_axm_i8(words, w8t, u8t=None, per_part=None, both=True,
                   shared=False):
    """axm_i8_kernel<kForm>'s integers, (za, zb) int64[D, 4, 4*Nw] or, with
    ``both`` false (axm_i8a, no U), (za,), or, with ``shared`` (axm_i8s, U
    the digits of -U), (zt,) where both planes add into one set of sums:
    groups of 8 word rows x 8 digit rows walking 32 markers per step, the
    group's FW_SPLIT warps taking the steps of a part (FW_MAX_STEPS, or
    FW_SHARED_MAX_STEPS in the shared form) in turn, lane (g, t) loading 16
    bytes at m+4t and m+16+4t of word row i0+g and the u32 of digit row
    d0+g there; each warp's int32 sums of a part, shifted back, are added
    to the output."""
    nw, mpad = words.shape
    D = w8t.shape[0]
    w = words.astype(np.int64)
    nb = 4 * nw
    if per_part is None:
        per_part = FW_SHARED_MAX_STEPS if shared else FW_MAX_STEPS
    # (decode, digits) of each plane type the kernel accumulates, and the
    # set of sums each adds into
    types = [(swar_a_fields, w8t)] + [(swar_b_fields, u8t)] * (both or shared)
    sums = [0] * len(types) if shared else list(range(len(types)))
    outs = [np.zeros((D, 4, nb), np.int64) for _ in range(max(sums) + 1)]
    # every group (i0) and digit group (d0): batch axes
    i0 = np.arange(0, nw, 8)
    d0 = np.arange(0, D, 8)
    rows = np.minimum(i0[:, None] + G[None, :], nw - 1)           # [W, 32]
    drow = np.minimum(d0[:, None] + G[None, :], D - 1)            # [Z, 32]
    # where acc[2b + h][2*half + c] goes: planar row (2h + half,
    # 4(i0 + g) + b), digit row d0 + 2t + c
    b_, h_, half_, c_ = np.meshgrid(np.arange(4), np.arange(2), np.arange(2),
                                    np.arange(2), indexing="ij")
    tile, slot = (2 * b_ + h_).ravel(), (2 * half_ + c_).ravel()
    k_, bb_ = (2 * h_ + half_).ravel(), b_.ravel()
    dd = d0[:, None, None] + 2 * T[None, :, None] + c_.ravel()[None, None]
    ii = i0[:, None, None] + G[None, :, None]                     # [W, 32, 1]
    for lo, hi in _parts(-(-mpad // FW_STEP), per_part):
        accs = [np.zeros((FW_SPLIT, len(i0), len(d0), 8, 32, 4), np.int64)
                for _ in outs]
        for j in range(lo, hi):
            sub, m = (j - lo) % FW_SPLIT, j * FW_STEP
            cols = [m + 4 * T, m + 16 + 4 * T]                    # [32] each
            live = [c < mpad for c in cols]
            x = []
            for c, lv in zip(cols, live):
                idx = np.minimum(c, mpad - 4)[None, :, None] + np.arange(4)
                q = w[rows[:, :, None], idx]                       # [W, 32, 4]
                x.append(np.where(lv[None, :, None], q, 0))
            dig = []
            for _, d8 in types:
                dg = []
                for c, lv in zip(cols, live):
                    u = _u32(d8, (drow, np.minimum(c, mpad - 4)[None, :]))
                    dg.append(np.where(lv[None, :], u, 0))         # [Z, 32]
                dig.append(np.stack(dg, axis=-1)[None])            # [1,Z,32,2]
            y0, y1 = transpose_quad(x[0]), transpose_quad(x[1])    # [W,32,4]
            for b in range(4):
                for h in range(2):
                    for (dec, _), p, dgt in zip(types, sums, dig):
                        acc = accs[p]
                        f0, f1 = dec(y0[..., b]), dec(y1[..., b])
                        a = np.stack([plane64(f0, 2 * h),
                                      plane64(f0, 2 * h + 1),
                                      plane64(f1, 2 * h),
                                      plane64(f1, 2 * h + 1)],
                                     axis=-1)[:, None]             # [W,1,32,4]
                        acc[sub, :, :, 2 * b + h] = mma(
                            acc[sub, :, :, 2 * b + h], a, dgt)
        for acc, out in zip(accs, outs):
            # each warp's part shifted back, then the group's warps added
            part = (wrap32(acc) >> SCALE_SHIFT).sum(axis=0)        # [W,Z,8,32,4]
            v = np.moveaxis(part, 3, 2)[..., tile, slot]           # [W,Z,32,P]
            ok = (ii < nw)[:, None] & (dd < D)[None]               # [W,Z,32,16]
            W_, Z_, L_, P_ = np.nonzero(ok)
            np.add.at(out, (dd[Z_, L_, P_], k_[P_],
                            4 * ii[W_, L_, 0] + bb_[P_]), v[W_, Z_, L_, P_])
    return tuple(outs)


def emulate_atxm_i8(words, v8, per_part=TX_MAX_STEPS, both=True):
    """atxm_i8_kernel<both>'s integers, (av, bv) int64[D, Mpad] or, with
    ``both`` false (atxm_i8a), (av,): warps of 64 markers x 8 digit rows
    walking 8 word rows per step, lane (g, t) loading 16 bytes at markers
    m0+32l+4g of word rows 8st+t and 8st+t+4 and, per plane, the u32 of
    digit row d0+g at those people; each part's int32 sums, shifted back,
    are added to the output."""
    nw, mpad = words.shape
    D = v8.shape[1]
    nb = 4 * nw
    w = words.astype(np.int64)
    decs = [swar_a_fields] + [swar_b_fields] * both
    outs = [np.zeros((D, mpad), np.int64) for _ in decs]
    m0 = np.arange(0, mpad, TX_WARP_MARKERS)
    d0 = np.arange(0, D, 8)
    drow = np.minimum(d0[:, None] + G[None, :], D - 1)            # [Z, 32]
    v_rows = v8.reshape(4 * D, nb)
    cols = [np.minimum(m0[:, None] + 32 * l + 4 * G[None, :], mpad - 4)
            for l in range(TX_LOADS)]                              # [W, 32]
    # where acc[2l + h][2*half + c] goes: marker m0 + 32l + 4g + 2h + half,
    # digit row d0 + 2t + c
    lh_, half_, c_ = np.meshgrid(np.arange(2 * TX_LOADS), np.arange(2),
                                 np.arange(2), indexing="ij")
    tile, slot = lh_.ravel(), (2 * half_ + c_).ravel()
    mm = (m0[:, None, None] + 32 * (lh_.ravel() // 2)[None, None]
          + 4 * G[None, :, None] + 2 * (lh_.ravel() % 2)[None, None]
          + half_.ravel()[None, None])                             # [W, 32, P]
    dd = d0[:, None, None] + 2 * T[None, :, None] + c_.ravel()[None, None]
    for lo, hi in _parts(-(-nw // 8), per_part):
        accs = [np.zeros((len(m0), len(d0), 2 * TX_LOADS, 32, 4), np.int64)
                for _ in decs]
        for st in range(lo, hi):
            ia, ib = 8 * st + T, 8 * st + T + 4                    # [32]
            la, lb = ia < nw, ib < nw
            xa = [np.where(la[None, :, None],
                           w[np.minimum(ia, nw - 1)[None, :, None],
                             c[:, :, None] + np.arange(4)], 0) for c in cols]
            xb = [np.where(lb[None, :, None],
                           w[np.minimum(ib, nw - 1)[None, :, None],
                             c[:, :, None] + np.arange(4)], 0) for c in cols]
            for k in range(4):
                r = k * D + drow                                   # [Z, 32]
                b0 = np.where(la[None, :], _u32(
                    v_rows, (r, 4 * np.minimum(ia, nw - 1)[None, :])), 0)
                b1 = np.where(lb[None, :], _u32(
                    v_rows, (r, 4 * np.minimum(ib, nw - 1)[None, :])), 0)
                bb = np.stack([b0, b1], axis=-1)[None]             # [1,Z,32,2]
                for l in range(TX_LOADS):
                    for h in range(2):
                        for dec, acc in zip(decs, accs):
                            a = np.stack(
                                [plane64(dec(xa[l][..., 2 * h]), k),
                                 plane64(dec(xa[l][..., 2 * h + 1]), k),
                                 plane64(dec(xb[l][..., 2 * h]), k),
                                 plane64(dec(xb[l][..., 2 * h + 1]), k)],
                                axis=-1)[:, None]                  # [W,1,32,4]
                            acc[:, :, 2 * l + h] = mma(
                                acc[:, :, 2 * l + h], a, bb)
        for acc, out in zip(accs, outs):
            part = wrap32(acc) >> SCALE_SHIFT                      # [W,Z,4,32,4]
            v = np.moveaxis(part, 2, -2)[..., tile, slot]          # [W,Z,32,P]
            ok = (mm < mpad)[:, None] & (dd < D)[None]             # [W,Z,32,P]
            W_, Z_, L_, P_ = np.nonzero(ok)
            np.add.at(out, (dd[Z_, L_, P_], mm[W_, L_, P_]),
                      v[W_, Z_, L_, P_])
    return tuple(outs)


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------

# (Nw, Mpad, B): Nw = 7 (one partial step of 8 rows, one partial warp),
# 300 (not a multiple of 8 or of axm's 64-row block), 65; Mpad = 8 (below
# one step), 1,000 and 132 (partial last step, not a multiple of 128), 512
# (whole steps); B = 1 (D = 4, half the n-tile), 2, 5 (D = 20), 22 (D =
# 88, 11 groups)
CASES = [(7, 8, 22), (7, 1000, 1), (300, 8, 2), (300, 1000, 22),
         (64, 512, 1), (65, 132, 2), (13, 36, 5)]


def test_transpose_quad_and_field_decodes_match_the_plain_decode():
    """The helpers the emulator shares with the kernels: plane(fields, k)
    of both decodes equals the plain SWAR decode of plane k and
    plane64(fields, k) 64 times it, byte by byte; transpose_quad's byte j
    of y[b] is byte b of word j."""
    rng = np.random.default_rng(0)
    w = _words(rng, 1, 64)[0].astype(np.int64)
    for k in range(4):
        a, b = tmv._swar(torch.from_numpy(w.astype(np.uint32).view(
            np.int32)), k)
        for dec, want in ((swar_a_fields, a), (swar_b_fields, b)):
            want = want.numpy().view(np.uint32).astype(np.int64)
            np.testing.assert_array_equal(plane(dec(w), k), want)
            np.testing.assert_array_equal(plane64(dec(w), k), want << 6)
    y = transpose_quad(w.reshape(16, 4))
    for j in range(4):
        for b in range(4):
            np.testing.assert_array_equal((y[:, b] >> (8 * j)) & 0xFF,
                                          (w.reshape(16, 4)[:, j]
                                           >> (8 * b)) & 0xFF)


@pytest.mark.parametrize("a_signed", [False, True])
def test_mma_emulation_is_a_matrix_product(a_signed):
    """mma() places the lanes' registers by the PTX layout: scattering a
    known A (u8 or s8), B and C into the fragments gives C + A @ B back."""
    rng = np.random.default_rng(1)
    A = rng.integers(-128, 128, (16, 32)) if a_signed else rng.integers(
        0, 256, (16, 32))
    B = rng.integers(-128, 128, (32, 8))
    C = rng.integers(-1000, 1000, (16, 8))
    a = np.zeros((32, 4), np.int64)
    b = np.zeros((32, 2), np.int64)
    for r in range(16):
        for c in range(32):
            a[A_LANE[r, c], A_REG[r, c]] |= (int(A[r, c]) & 0xFF) << (
                8 * A_BYTE[r, c])
    for k in range(32):
        for n in range(8):
            b[B_LANE[k, n], B_REG[k, n]] |= (int(B[k, n]) & 0xFF) << (
                8 * B_BYTE[k, n])
    c = C[C_ROW, C_COL]
    out = mma(c, a, b, a_signed)
    D = np.zeros((16, 8), np.int64)
    D[C_ROW, C_COL] = out
    np.testing.assert_array_equal(D, C + A @ B)


@pytest.mark.parametrize("nw,m,B", CASES)
def test_axm_i8_lane_map_matches_refs(nw, m, B):
    """axm_i8_kernel's loop, emulated: (za, zb) equal axm_i8_int_ref and
    the JAX kernel body exactly; folded, A_a W - A_b U within FOLD_TOL of
    axm_i8_pallas."""
    rng = np.random.default_rng(nw * 7 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 3).astype(np.float32)
    w8t, ws = tmv._quant_rows(torch.from_numpy(W))
    u8t, us = tmv._quant_rows(torch.from_numpy(U))
    za, zb = emulate_axm_i8(words, w8t.numpy(), u8t.numpy())
    ra, rb = tmv.axm_i8_int_ref(_t(words), w8t, u8t)
    np.testing.assert_array_equal(za, ra.numpy())
    np.testing.assert_array_equal(zb, rb.numpy())
    ja, jb = _jax_axm_i8_int(words, w8t.numpy(), u8t.numpy())
    np.testing.assert_array_equal(za, np.asarray(ja))
    np.testing.assert_array_equal(zb, np.asarray(jb))
    got = (tmv._fold_digits_zt(torch.from_numpy(za).to(torch.int32), ws, B)
           - tmv._fold_digits_zt(torch.from_numpy(zb).to(torch.int32), us,
                                 B))
    _close(got, jmv.axm_i8_pallas(jnp.asarray(words), jnp.asarray(W),
                                  jnp.asarray(U)), FOLD_TOL)


@pytest.mark.parametrize("nw,m,B", CASES)
def test_atxm_i8_lane_map_matches_refs(nw, m, B):
    """atxm_i8_kernel's loop, emulated: (av, bv) equal atxm_i8_int_ref and
    the JAX kernel body exactly; folded, each within FOLD_TOL of
    atxm_i8_pallas."""
    rng = np.random.default_rng(nw * 13 + m + B)
    words = _words(rng, nw, m)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    v8, s0 = tmv._quant_digits_t(torch.from_numpy(V))
    av, bv = emulate_atxm_i8(words, v8.numpy())
    ra, rb = tmv.atxm_i8_int_ref(_t(words), v8)
    np.testing.assert_array_equal(av, ra.numpy())
    np.testing.assert_array_equal(bv, rb.numpy())
    ja, jb = _jax_atxm_i8_int(words, v8.numpy())
    np.testing.assert_array_equal(av, np.asarray(ja))
    np.testing.assert_array_equal(bv, np.asarray(jb))
    want = jmv.atxm_i8_pallas(jnp.asarray(words), jnp.asarray(V))
    for got, w in zip((av, bv), want):
        _close(tmv._fold_digits_t(torch.from_numpy(got).to(torch.int32), s0,
                                  B), w, FOLD_TOL)


# the edges of chip_smoke.FRAGMENT_SHAPES for the one-plane forms: Nw = 7
# and 300, Mpad = 8 and 1,000, B = 1, 2 and 22
A_ONLY_CASES = [(7, 8, 22), (7, 1000, 1), (300, 8, 2), (300, 1000, 22),
                (300, 1000, 1)]


@pytest.mark.parametrize("nw,m,B", A_ONLY_CASES)
def test_axm_i8a_lane_map_matches_refs(nw, m, B):
    """axm_i8_kernel<false>'s loop (axm_i8a), emulated: za equals
    axm_i8a_int_ref and the JAX _axm_i8a_kernel body exactly; folded,
    within FOLD_TOL of axm_i8a_pallas."""
    rng = np.random.default_rng(nw * 11 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    w8t, ws = tmv._quant_rows(torch.from_numpy(W))
    (za,) = emulate_axm_i8(words, w8t.numpy(), both=False)
    np.testing.assert_array_equal(za, tmv.axm_i8a_int_ref(_t(words),
                                                          w8t).numpy())
    np.testing.assert_array_equal(za, np.asarray(_jax_axm_int(words,
                                                              w8t.numpy())))
    _close(tmv._fold_digits_zt(torch.from_numpy(za).to(torch.int32), ws, B),
           jmv.axm_i8a_pallas(jnp.asarray(words), jnp.asarray(W)), FOLD_TOL)


@pytest.mark.parametrize("nw,m,B", A_ONLY_CASES)
def test_atxm_i8a_lane_map_matches_refs(nw, m, B):
    """atxm_i8_kernel<false>'s loop (atxm_i8a), emulated: av equals
    atxm_i8a_int_ref and the JAX _atxm_i8a_kernel body exactly; folded,
    within FOLD_TOL of atxm_i8a_pallas."""
    rng = np.random.default_rng(nw * 17 + m + B)
    words = _words(rng, nw, m)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    v8, s0 = tmv._quant_digits_t(torch.from_numpy(V))
    (av,) = emulate_atxm_i8(words, v8.numpy(), both=False)
    np.testing.assert_array_equal(av, tmv.atxm_i8a_int_ref(_t(words),
                                                           v8).numpy())
    np.testing.assert_array_equal(av, np.asarray(_jax_atxm_int(words,
                                                               v8.numpy())))
    _close(tmv._fold_digits_t(torch.from_numpy(av).to(torch.int32), s0, B),
           jmv.atxm_i8a_pallas(jnp.asarray(words), jnp.asarray(V)), FOLD_TOL)


# the shared form at the shapes of the lane-map tests above: CASES and the
# edges of FRAGMENT_SHAPES (Nw 7 / 300, Mpad 8 / 1,000, B 1 / 2 / 22)
SHARED_CASES = CASES + [(300, 1000, 1)]


@pytest.mark.parametrize("nw,m,B", SHARED_CASES)
def test_axm_i8s_lane_map_matches_refs(nw, m, B):
    """axm_i8_kernel<kShared>'s loop (axm_i8s), emulated: the a-plane
    against W's digits and the b-plane against -U's, added into one set of
    sums, equal axm_i8s_int_ref and the JAX _axm_i8s_kernel body exactly;
    folded once, within FOLD_TOL of axm_i8s_pallas."""
    rng = np.random.default_rng(nw * 19 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 1.5).astype(np.float32)
    w8t, mu8t, ws = tmv._quant_digits_pair(torch.from_numpy(W),
                                           torch.from_numpy(U))
    (zt,) = emulate_axm_i8(words, w8t.numpy(), mu8t.numpy(), shared=True)
    np.testing.assert_array_equal(zt, tmv.axm_i8s_int_ref(_t(words), w8t,
                                                          mu8t).numpy())
    np.testing.assert_array_equal(zt, np.asarray(_jax_axm_i8s_int(
        words, w8t.numpy(), mu8t.numpy())))
    _close(tmv._fold_digits_zt(torch.from_numpy(zt).to(torch.int32), ws, B),
           jmv.axm_i8s_pallas(jnp.asarray(words), jnp.asarray(W),
                              jnp.asarray(U)), FOLD_TOL)


def test_axm_i8a_one_launch_equals_its_column_chunks():
    """axm_i8a makes one launch for any B, where the JAX wrapper chunks the
    columns at _BMAX_AXM_A: at B = 70 (35 digit groups over gridDim.z) the
    emulated kernel's one call, folded, equals its two chunks' calls bit for
    bit, as the quantisation is per column; so does the wrapper."""
    rng = np.random.default_rng(70)
    nw, m, B = 9, 64, tmv._BMAX_AXM_A + 6
    words = _words(rng, nw, m)
    W = torch.from_numpy(rng.standard_normal((m, B)).astype(np.float32))

    def emulated(cols):
        w8t, ws = tmv._quant_rows(cols)
        (za,) = emulate_axm_i8(words, w8t.numpy(), both=False)
        return tmv._fold_digits_zt(torch.from_numpy(za).to(torch.int32), ws,
                                   cols.shape[1])

    chunks = [W[:, lo:lo + tmv._BMAX_AXM_A]
              for lo in range(0, B, tmv._BMAX_AXM_A)]
    assert len(chunks) == 2
    one = emulated(W)
    assert torch.equal(one, torch.cat([emulated(c) for c in chunks], dim=2))
    assert torch.equal(one, tmv.axm_i8a(_t(words), W))
    assert torch.equal(one, torch.cat([tmv.axm_i8a(_t(words), c)
                                       for c in chunks], dim=2))


@pytest.mark.parametrize("per_step,term,cap", [
    (32, SCALED_TERM, FW_MAX_STEPS), (128, SCALED_TERM, TX_MAX_STEPS),
    (32, SHARED_TERM, FW_SHARED_MAX_STEPS)],
    ids=["axm_i8", "atxm_i8", "axm_i8s"])
def test_part_caps_are_the_longest_that_fit_int32(per_step, term, cap):
    """A part of FW_MAX_STEPS / TX_MAX_STEPS / FW_SHARED_MAX_STEPS steps at
    the largest terms (64 x 2 x 127 for one plane type, 32 per output and
    step in axm_i8, 128 in atxm_i8; 64 x (2 x 127 + 127) for both planes in
    one sum, 32 per output and step in axm_i8s) stays inside int32, one
    step more would not."""
    assert cap * per_step * term < 2**31
    assert (cap + 1) * per_step * term >= 2**31


@pytest.mark.parametrize("kernel", ["axm_i8", "atxm_i8", "axm_i8a",
                                    "atxm_i8a", "axm_i8s"])
def test_largest_sums_stay_exact_in_the_longest_part(kernel):
    """Every call a = 2 (code 00) against digits of 127: the a-plane sums
    are the largest the words allow, 64 times them would leave int32, and a
    contraction a few steps longer than the part cap spans two parts.  The
    emulated kernel, in its two-plane form (axm_i8, atxm_i8) and its
    one-plane form (axm_i8a, atxm_i8a), equals the plain version there: a
    part's sums are per plane type, so one cap serves both forms.
    atxm_i8's one warp per output would leave int32 in one part; axm_i8's
    group of FW_SPLIT warps takes a part's steps in turn, so its cap holds
    with room.  The shared form (axm_i8s) adds b = 1 against digits of 127
    into the same sums, every term 64 x 381, over a few steps more than its
    own, shorter cap: equal to axm_i8s_int_ref too."""
    both = not kernel.endswith("a")
    if kernel == "axm_i8s":
        nw, m = 9, 32 * FW_SHARED_MAX_STEPS + 100
        words = np.zeros((nw, m), np.uint32)
        d8 = np.full((1, m), 127, np.int8)
        got = emulate_axm_i8(words, d8, d8, shared=True)
        want = (tmv.axm_i8s_int_ref(_t(words), torch.from_numpy(d8),
                                    torch.from_numpy(d8)),)
        assert len(got) == 1
        np.testing.assert_array_equal(got[0], want[0].numpy())
        assert int(want[0].abs().max()) == 381 * m
        assert int(want[0].abs().max()) << SCALE_SHIFT >= 2**31
        return
    if kernel.startswith("axm"):
        nw, m = 9, 32 * FW_MAX_STEPS + 100
        words = np.zeros((nw, m), np.uint32)
        w8t = np.full((1, m), 127, np.int8)
        d8 = torch.from_numpy(w8t)
        got = emulate_axm_i8(words, w8t, w8t, both=both)
        want = (tmv.axm_i8_int_ref(_t(words), d8, d8) if both
                else (tmv.axm_i8a_int_ref(_t(words), d8),))
        one_part = got
    else:
        nw, m = 8 * TX_MAX_STEPS + 20, 8
        words = np.zeros((nw, m), np.uint32)
        v8 = np.full((4, 1, 4 * nw), 127, np.int8)
        d8 = torch.from_numpy(v8)
        got = emulate_atxm_i8(words, v8, both=both)
        want = (tmv.atxm_i8_int_ref(_t(words), d8) if both
                else (tmv.atxm_i8a_int_ref(_t(words), d8),))
        one_part = emulate_atxm_i8(words, v8, per_part=10**9, both=both)
    assert len(got) == len(want) == 1 + both
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    # the a-plane's sums (b = 1 halves them)
    assert int(want[0].abs().max()) << SCALE_SHIFT >= 2**31
    if kernel.startswith("atxm"):
        assert not np.array_equal(one_part[0], want[0].numpy())


def test_chip_smoke_ptxas_entries_split_the_instantiations(monkeypatch):
    """chip_smoke's no-spill check reads each fragment product's own
    instantiation of the two templates: against the mangled names of
    axm_i8_kernel<kForm> (one plane, two planes, two planes in one sum) and
    atxm_i8_kernel<kBoth> (and of the other kernels of the report), the
    pattern of each of the five keys matches exactly one name, its own, and
    every instantiation is some key's; so do the keys of atx_kernel<kBoth>'s
    two instantiations, atx_a and atx."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    smoke = importlib.import_module("chip_smoke")
    ns = "_ZN45_GLOBAL__N__5b2f9e1c_12_fragments_cu_8d1e0f3a"

    def mangled(kernel, arg):
        return f"{ns}{len(kernel)}{kernel}IL{arg}EEEvPKjPKhS5_PiS6_llll"

    own = {"axm_i8a": mangled("axm_i8_kernel", "i0"),
           "axm_i8": mangled("axm_i8_kernel", "i1"),
           "axm_i8s": mangled("axm_i8_kernel", "i2"),
           "atxm_i8a": mangled("atxm_i8_kernel", "b0"),
           "atxm_i8": mangled("atxm_i8_kernel", "b1")}
    others = ["_ZN12_GLOBAL__N_110atx_kernelILb0EEEvPKjPKfPflll",
              "_ZN12_GLOBAL__N_110atx_kernelILb1EEEvPKjPKfPflll",
              "_ZN12_GLOBAL__N_115gram_aat_kernelILb0EEEvPKjPKfS3_S3_Pfll",
              "_ZN12_GLOBAL__N_115i8decode_kernelEPKaPKhPilll"]
    assert set(smoke.FRAGMENT_KERNELS) == set(own)
    for key, name in [*own.items(), ("atx_a", others[0]),
                      ("atx", others[1])]:
        hits = [n for n in [*own.values(), *others]
                if re.search(smoke.PTXAS_ENTRY[key], n)]
        assert hits == [name], key
