"""The bf16-split kernels (gvamp_tpu_torch/csrc/bf16_split.cu), checked on
the CPU, where they cannot run.

A numpy emulator follows each kernel's loop as the source writes it: the
A fragments as the decoded fields masked to one plane (bf16 values a 4^k
2^-133, read as the tensor cores read them), the byte transpose of the
forward loop, which lane (g, t) loads which words and which four bf16 of
the wrappers' operand layouts (each column scaled by a power of two, each
quad stored as 0, 2, 1, 3), the mma.sync m16n8k16 bf16 semantics (the
PTX fragment layout), the order of the mma into each C fragment, the
chains of a fixed number of steps from a zeroed C with per-chain f32 sums,
the kFwSplit warps of a forward group meeting in shared memory, the
per-part partial rows and the wrapper's fold.  Its outputs must equal the
plain versions (axm_bf16_ref, atxm_bf16_ref) bit for bit on dyadic inputs
and stay within kernel_check.TOL of float64 on Gaussian inputs, also at
config B's contraction lengths, with the column groups of B = 1, 2, 3, 5
and the wrappers' chunk edge at 64 / 65.  The mma's own additions are
modelled two ways: rounding to nearest, and truncating toward zero (the
tensor cores do not round to nearest); with truncation, the kernels' chain
length stays within the tolerance and one chain over the whole contraction
does not."""

import importlib
import os
import re

import numpy as np
import pytest
import torch

from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.tools.kernel_check import TOL

# the kernels' constants (bf16_split.cu)
M5 = 0x55555555
FW_GROUPS, FW_SPLIT, FW_LOADS, FW_CHAIN = 2, 4, 4, 2
FW_STEP = 16 * FW_LOADS
TX_LOADS, TX_CHAIN = 2, 2
TX_WARP_MARKERS = 32 * TX_LOADS
MAX_CHAINS = 128
# config B's contraction lengths: markers (forward) and word rows (people
# / 16, transpose)
CFG_B_M, CFG_B_NW = 131_072, 20_480

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
U32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# device helpers on uint64 arrays holding u32 values
# --------------------------------------------------------------------------


def swar_a_fields(w):
    """a = {2,0,1,0}[code] in place of each 2-bit field (swar.cuh)."""
    notlo = ~w & np.uint64(M5)
    return ((notlo << np.uint64(1)) - ((w >> np.uint64(1)) & notlo)) \
        & np.uint64(U32)


def swar_b_fields(w):
    """b = {1,0,1,1}[code] in the low bit of each 2-bit field."""
    return (~w | (w >> np.uint64(1))) & np.uint64(M5)


def plane_bits(f, k):
    """plane_bits(f, k): the fields of plane k in bytes 0 and 2 of f, in
    place: each half of the register is the bf16 value field 4^k 2^-133."""
    return f & np.uint64(0x00030003 << (2 * k))


def transpose_quad(x):
    """x [..., 4] words of four markers -> y [..., 4]: byte j of y[b] is
    byte b of word j."""
    sh = np.uint64(8) * np.arange(4, dtype=np.uint64)
    by = (x[..., :, None] >> sh) & np.uint64(0xFF)       # [..., j, b]
    return (by << sh[:, None]).sum(axis=-2, dtype=np.uint64)


def bf16_float(bits):
    """uint16 bf16 bits (in any integer array) -> float64 values."""
    b = (np.asarray(bits, np.uint64) & np.uint64(0xFFFF)).astype(np.uint32)
    return (b << np.uint32(16)).view(np.float32).astype(np.float64)


def halves(r):
    """u32 registers [...] -> their two bf16 values [..., 2], low first."""
    return np.stack([bf16_float(r), bf16_float(r >> np.uint64(16))], -1)


def pack4(v16):
    """Four bf16 bit patterns [..., 4] (one 8-byte load) -> the B fragment
    registers [..., 2]: (v0 | v1 << 16, v2 | v3 << 16)."""
    v = v16.astype(np.uint64)
    return np.stack([v[..., 0] | (v[..., 1] << np.uint64(16)),
                     v[..., 2] | (v[..., 3] << np.uint64(16))], -1)


# the PTX fragment layout of m16n8k16 .bf16: lane 4g+t holds A rows g (a0,
# a2) and g+8 (a1, a3) at columns 2t, 2t+1 (a0, a1) and 2t+8, 2t+9 (a2,
# a3), the lower column in the low half; B column g at rows 2t, 2t+1 (b0)
# and 2t+8, 2t+9 (b1); C rows g (c0, c1) and g+8 (c2, c3) at columns 2t
# and 2t+1
_row, _col = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
A_LANE = 4 * (_row % 8) + (_col % 8) // 2
A_REG = _row // 8 + 2 * (_col // 8)
A_HALF = _col % 2
_k, _n = np.meshgrid(np.arange(16), np.arange(8), indexing="ij")
B_LANE = 4 * _n + (_k % 8) // 2
B_REG = _k // 8
B_HALF = _k % 2
C_ROW = G[:, None] + 8 * (np.arange(4)[None, :] // 2)
C_COL = 2 * T[:, None] + np.arange(4)[None, :] % 2


def mma_dots(a, b):
    """The exact products of one warp's m16n8k16 mma, per C slot: a [...,
    32, 4] and b [..., 32, 2] u32 registers -> float64 [..., 32, 4], the
    dot of each slot's 16 products (exact: a bf16 code value times a bf16
    part has at most 16 significant bits)."""
    av, bv = halves(a), halves(b)
    A = av[..., A_LANE, A_REG, A_HALF]                 # [..., 16, 16]
    B = bv[..., B_LANE, B_REG, B_HALF]                 # [..., 16, 8]
    return (A @ B)[..., C_ROW, C_COL]


def round_nearest(x):
    return x.astype(np.float32)


def round_toward_zero(x):
    """float64 -> float32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def accumulate(dots, chains, n_sums, mma_round):
    """The chains and running sums of a kernel: dots [S, O, ...] float64
    (step, mma order within the step), chains [(sum index, [steps])] in
    each sum's order.  Each chain starts from a zeroed C and adds its mma
    in order, each rounded by ``mma_round``; __fadd_rn adds it into its
    f32 running sum.  Returns float32 [n_sums, ...]."""
    acc = np.zeros((n_sums,) + dots.shape[2:], np.float32)
    for si, steps in chains:
        c = np.zeros(dots.shape[2:], np.float32)
        for s in steps:
            for o in range(dots.shape[1]):
                c = mma_round(c.astype(np.float64) + dots[s, o])
        acc[si] = (acc[si].astype(np.float64) + c).astype(np.float32)
    return acc


def _parts(steps, per_part):
    return [(lo, min(steps, lo + per_part)) for lo in range(0, steps, per_part)]


def _bits(x):
    return x.contiguous().view(torch.int16).numpy().astype(np.uint16)


# --------------------------------------------------------------------------
# axm_bf16_kernel
# --------------------------------------------------------------------------


def fw_dots(words, rhs, z, j_lo, j_hi):
    """The mma dots of steps j_lo..j_hi-1 of column group z, for every
    group of 8 word rows: float64 [S, 2 FW_LOADS, I, 32, 8, 4] (step; mma
    order a- then b-plane of load 0, then of load 1, ...; group i0 = 8 I;
    lane; tile 2b+h; C slot)."""
    nw, mpad = words.shape
    R = rhs.shape[1]
    i0 = np.arange(0, nw, 8)
    rows = np.minimum(i0[:, None] + G[None, :], nw - 1)          # [I, 32]
    j = np.arange(j_lo, j_hi)
    out = np.zeros((len(j), 2 * FW_LOADS, len(i0), 32, 8, 4))
    for q in range(FW_LOADS):
        mq = FW_STEP * j[:, None] + 16 * q + 4 * T[None, :]        # [S, 32]
        live = mq < mpad
        idx = np.minimum(mq, mpad - 4)[..., None] + np.arange(4)   # [S,32,4]
        x = words[rows[None, :, :, None], idx[:, None]]            # [S,I,32,4]
        x = np.where(live[:, None, :, None], x, 0).astype(np.uint64)
        y = transpose_quad(x)                                      # [S,I,32,4]
        # the 16 bytes at the lane's quad: 4 parts of W, then 4 of -U
        quad = np.minimum(mq, mpad - 4) // 4                       # [S, 32]
        frag = {}
        for o, kind in enumerate("ab"):
            v = rhs[z, np.minimum(G, R - 1)[None, :], quad, o]      # [S,32,4]
            ok = live & (G < R)[None, :]
            frag[kind] = pack4(np.where(ok[..., None], v, 0))[:, None]
        for b in range(4):
            fields = {"a": swar_a_fields(y[..., b]),
                      "b": swar_b_fields(y[..., b])}
            for h in range(2):
                for o, kind in enumerate("ab"):
                    f, f8 = fields[kind], fields[kind] >> np.uint64(8)
                    a = np.stack([plane_bits(f, 2 * h),
                                  plane_bits(f, 2 * h + 1),
                                  plane_bits(f8, 2 * h),
                                  plane_bits(f8, 2 * h + 1)], -1)
                    out[:, 2 * q + o, :, :, 2 * b + h] = mma_dots(
                        a, np.broadcast_to(frag[kind], a.shape[:-1] + (2,)))
    return out


def emulate_axm_bf16_out(words, rhs, per_part, mma_round=round_nearest,
                         chain=FW_CHAIN):
    """axm_bf16_kernel's partial rows, float32 [P, G, R, 4, 4 Nw] (the
    wrapper's out): per part of the marker steps, the FW_SPLIT warps of a
    group take its steps in turn, each in chains of ``chain`` of its steps
    (the masked last step, if any, in the last, shorter chain), meet in
    shared memory in warp order, and the lanes write their rows."""
    nw, mpad = words.shape
    Gz, R = rhs.shape[:2]
    steps = -(-mpad // FW_STEP)
    parts = _parts(steps, per_part)
    nb = 4 * nw
    out = np.full((len(parts), Gz, R, 4, nb), np.nan, np.float32)
    i0 = np.arange(0, nw, 8)
    for z in range(Gz):
        for pi, (j0, j1) in enumerate(parts):
            dots = fw_dots(words, rhs, z, j0, j1)
            chains = []
            for sub in range(FW_SPLIT):
                own = [s - j0 for s in range(j0 + sub, j1, FW_SPLIT)]
                chains += [(sub, own[c:c + chain])
                           for c in range(0, len(own), chain)]
            acc = accumulate(dots, chains, FW_SPLIT, mma_round)
            # shared memory: warp order; slot 2 half + cc of tile 2b + h is
            # planar row (2h + half, 4i + b), n = 2t + cc
            v = acc[0]
            for w in range(1, FW_SPLIT):
                v = (v.astype(np.float64) + acc[w]).astype(np.float32)
            for tile in range(8):
                b, h = divmod(tile, 2)
                for slot in range(4):
                    half, cc = divmod(slot, 2)
                    n = 2 * T + cc                                  # [32]
                    i = i0[:, None] + G[None, :]                    # [I, 32]
                    ok = (i < nw) & (n < R)[None, :]
                    nn = np.broadcast_to(n, i.shape)
                    # the rows of plane 2h + half carry 4^(2h + half)
                    out[pi, z, nn[ok], 2 * h + half, 4 * i[ok] + b] = \
                        v[:, :, tile, slot][ok] * np.float32(
                            4.0 ** -(2 * h + half))
    assert not np.isnan(out).any()
    return out


def emulated_axm_bf16(words, W, U, per_part=None, mma_round=round_nearest,
                      chain=FW_CHAIN):
    """The axm_bf16 wrapper with the emulated kernel: chunks of _BMAX_BF16
    columns, the operand of axm_bf16_operands, the fold of bf16_fold_z.
    ``per_part`` defaults to the longest part the kernel takes."""
    B = W.shape[1]
    if B > tmv._BMAX_BF16:
        return torch.cat([emulated_axm_bf16(words, W[:, lo:lo + tmv._BMAX_BF16],
                                            U[:, lo:lo + tmv._BMAX_BF16],
                                            per_part, mma_round, chain)
                          for lo in range(0, B, tmv._BMAX_BF16)], dim=2)
    cg = tmv.bf16_group(B)
    rhs, E = tmv.axm_bf16_operands(W, U, cg)
    rhs = _bits(rhs)
    if per_part is None:
        per_part = MAX_CHAINS * FW_CHAIN * FW_SPLIT
    wn = words.numpy().view(np.uint32)
    out = emulate_axm_bf16_out(wn, rhs, per_part, mma_round, chain)
    G_ = rhs.shape[0]
    return tmv.bf16_fold_z(torch.from_numpy(out).reshape(
        out.shape[0], G_, 3, cg, *out.shape[3:]), B, E)


# --------------------------------------------------------------------------
# atxm_bf16_kernel
# --------------------------------------------------------------------------


def tx_dots(words, v2, z, s_lo, s_hi):
    """The mma dots of word-row steps s_lo..s_hi-1 of column group z, for
    every warp's 64 markers: float64 [S, 8, Wp, 32, 2, 4, 4] (step; mma
    order 4r + k, row set r then plane k; warp; lane; plane type a / b;
    tile 2l+h; C slot)."""
    nw, mpad = words.shape
    R = v2.shape[1]
    m0 = np.arange(0, mpad, TX_WARP_MARKERS)
    st = np.arange(s_lo, s_hi)
    out = np.zeros((len(st), 8, len(m0), 32, 2, 4, 4))
    # the lane's markers m0 + 32l + 4g + q, past Mpad the last valid quad
    mk = np.minimum(m0[:, None, None] + 32 * np.arange(TX_LOADS)[None, :, None]
                    + 4 * G[None, None, :], mpad - 4)       # [Wp, L, 32]
    for r in range(2):
        ir = 8 * st[:, None] + T[None, :] + 4 * r          # [S, 32]
        live = ir < nw
        irc = np.minimum(ir, nw - 1)
        x = words[irc[:, None, None, :, None],
                  mk[None, :, :, :, None] + np.arange(4)]   # [S,Wp,L,32,4]
        x = np.where(live[:, None, None, :, None], x, 0).astype(np.uint64)
        for k in range(4):
            # the person quad of row ir: its 4 planes' 16 bf16, plane k's
            v = v2[z, np.minimum(G, R - 1)[None, :], irc, k]    # [S, 32, 4]
            ok = live & (G < R)[None, :]
            f = pack4(np.where(ok[..., None], v, 0))[:, None]   # [S,1,32,2]
            for ti, fields in enumerate((swar_a_fields, swar_b_fields)):
                for l in range(TX_LOADS):
                    for h in range(2):
                        f0 = fields(x[:, :, l, :, 2 * h])
                        f1 = fields(x[:, :, l, :, 2 * h + 1])
                        e = np.uint64(8)
                        a = np.stack([plane_bits(f0, k),
                                      plane_bits(f1, k),
                                      plane_bits(f0 >> e, k),
                                      plane_bits(f1 >> e, k)], -1)
                        out[:, 4 * r + k, :, :, ti, 2 * l + h] = mma_dots(
                            a, np.broadcast_to(f, a.shape[:-1] + (2,)))
    return out


def emulate_atxm_bf16_out(words, v2, per_part, mma_round=round_nearest,
                          chain=TX_CHAIN):
    """atxm_bf16_kernel's partial rows, float32 [2, P, G, R, Mpad]: per
    part of the word-row steps, chains of ``chain`` steps (the masked last
    step, if any, in the last, shorter chain) into one running sum per
    output, each warp writing its markers."""
    nw, mpad = words.shape
    Gz, R = v2.shape[:2]
    steps = -(-nw // 8)
    parts = _parts(steps, per_part)
    out = np.full((2, len(parts), Gz, R, mpad), np.nan, np.float32)
    m0 = np.arange(0, mpad, TX_WARP_MARKERS)
    for z in range(Gz):
        for pi, (i_lo, i_hi) in enumerate(parts):
            dots = tx_dots(words, v2, z, i_lo, i_hi)
            own = list(range(i_hi - i_lo))
            chains = [(0, own[c:c + chain]) for c in range(0, len(own), chain)]
            acc = accumulate(dots, chains, 1, mma_round)[0]  # [Wp,32,2,4,4]
            # slot 2 half + cc of tile 2l + h is marker m0 + 32l + 4g + 2h
            # + half, n = 2t + cc
            for lh in range(4):
                l, h = divmod(lh, 2)
                for slot in range(4):
                    half, cc = divmod(slot, 2)
                    m = (m0[:, None] + 32 * l + 4 * G[None, :] + 2 * h
                         + half)                                # [Wp, 32]
                    n = np.broadcast_to(2 * T + cc, m.shape)
                    ok = (m < mpad) & (n < R)
                    for p in range(2):
                        out[p, pi, z, n[ok], m[ok]] = acc[:, :, p, lh, slot][ok]
    assert not np.isnan(out).any()
    return out


def emulated_atxm_bf16(words, V, per_part=None, mma_round=round_nearest,
                       chain=TX_CHAIN):
    """The atxm_bf16 wrapper with the emulated kernel (atxm_bf16_operands,
    bf16_fold_v, chunks of _BMAX_BF16)."""
    B = V.shape[2]
    if B > tmv._BMAX_BF16:
        outs = [emulated_atxm_bf16(words, V[:, :, lo:lo + tmv._BMAX_BF16],
                                   per_part, mma_round, chain)
                for lo in range(0, B, tmv._BMAX_BF16)]
        return tuple(torch.cat(o, dim=1) for o in zip(*outs))
    cg = tmv.bf16_group(B)
    v2, E = tmv.atxm_bf16_operands(V, cg)
    v2 = _bits(v2)
    if per_part is None:
        per_part = MAX_CHAINS * TX_CHAIN
    wn = words.numpy().view(np.uint32)
    out = emulate_atxm_bf16_out(wn, v2, per_part, mma_round, chain)
    G_ = v2.shape[0]
    return tmv.bf16_fold_v(torch.from_numpy(out).reshape(
        2, out.shape[1], G_, 3, cg, out.shape[-1]), B, E)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------


def _words(rng, nw, m):
    w = rng.integers(0, 2**32, size=(nw, m), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(w.view(np.int32).copy())


def _dyadic(rng, *shape):
    return torch.from_numpy((rng.integers(0, 9, shape) / 8).astype(np.float32))


def _gauss(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32))


def _rel(got, want):
    return float((got.double() - want).abs().max() / want.abs().max())


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", range(4))
@pytest.mark.parametrize("pos", [0, 1])
def test_plane_bits_are_the_values_of_every_code(k, pos):
    """For every pair of codes of plane k in bytes pos and pos+2 of a word
    (pos 1: the fields shifted by 8, as the kernels take bytes 1 and 3),
    whatever the other planes' codes and bytes, the decoded fields masked
    to plane k are two bf16 values a 4^k 2^-133 and b 4^k 2^-133 (a =
    {2,0,1,0}[code], b = {1,0,1,1}[code]), byte pos's in the low half."""
    rng = np.random.default_rng(10 + 4 * k + pos)
    want = {"a": np.array([2.0, 0.0, 1.0, 0.0]),
            "b": np.array([1.0, 0.0, 1.0, 1.0])}
    c0, c1 = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    c0, c1 = c0.ravel().astype(np.uint64), c1.ravel().astype(np.uint64)
    sh = np.uint64(8 * pos)
    for _ in range(8):
        fill = rng.integers(0, 2**32, size=c0.shape, dtype=np.uint64)
        mask = np.uint64((3 << (2 * k)) * (0x10001 << (8 * pos)))
        x = (fill & ~mask & np.uint64(U32)) \
            | (c0 << (sh + np.uint64(2 * k))) \
            | (c1 << (sh + np.uint64(16 + 2 * k)))
        for kind, fields in (("a", swar_a_fields), ("b", swar_b_fields)):
            v = halves(plane_bits(fields(x) >> sh, k)) * 2.0 ** 133 / 4 ** k
            np.testing.assert_array_equal(v[:, 0], want[kind][c0])
            np.testing.assert_array_equal(v[:, 1], want[kind][c1])


def test_column_scales_are_exact_and_in_range():
    """bf16_exponents and the scaling by 2^(127 - E) put each column's
    largest value in [2^126, 2^127), and scaling back restores every value
    exactly, across magnitudes, signs, zero columns and zeros."""
    rng = np.random.default_rng(12)
    X = _gauss(rng, 64, 6) * 10.0 ** torch.from_numpy(
        rng.integers(-30, 31, (1, 6)).astype(np.float32))
    X[:, 4] = 0.0
    X[::3, 5] = 0.0
    E = tmv.bf16_exponents(X)
    Y = tmv._times_pow2(X, 127 - E)
    big = Y.abs().amax(0)
    assert bool(((big >= 2.0 ** 126) & (big < 2.0 ** 127))[:4].all())
    assert bool((big[4] == 0) & (big[5] >= 2.0 ** 126))
    assert torch.equal(tmv._times_pow2(Y, E - 127), X)


def test_kernels_field_decode_is_swar():
    """The kernels' five-operation decode (bf16_split.cu, decode_fields):
    a = ~lo + (~lo & ~hi) and b = ~lo | hi per 2-bit field equal swar.cuh's
    swar_a_fields / swar_b_fields on every code at every field."""
    rng = np.random.default_rng(9)
    w = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64),
                        np.uint64(0x1B1B1B1B) * np.arange(4, dtype=np.uint64)])
    w &= np.uint64(U32)
    t, m5, full = w >> np.uint64(1), np.uint64(M5), np.uint64(U32)
    fa = ((~w & m5) + (~w & ~t & m5)) & full
    fb = (~w | t) & m5
    np.testing.assert_array_equal(fa, swar_a_fields(w))
    np.testing.assert_array_equal(fb, swar_b_fields(w))


def test_fragment_layout_is_the_product():
    """The emulated mma (A and B fragments by the PTX layout of m16n8k16)
    computes A @ B for random bf16 matrices: the layout tables are right."""
    rng = np.random.default_rng(3)
    A = _gauss(rng, 16, 16).to(torch.bfloat16)
    Bm = _gauss(rng, 16, 8).to(torch.bfloat16)
    a16, b16 = _bits(A).astype(np.uint64), _bits(Bm).astype(np.uint64)
    a = np.zeros((32, 4), np.uint64)
    b = np.zeros((32, 2), np.uint64)
    for r in range(16):
        for c in range(16):
            a[A_LANE[r, c], A_REG[r, c]] |= a16[r, c] << np.uint64(16 * A_HALF[r, c])
    for k in range(16):
        for n in range(8):
            b[B_LANE[k, n], B_REG[k, n]] |= b16[k, n] << np.uint64(16 * B_HALF[k, n])
    d = mma_dots(a, b)
    want = (A.double() @ Bm.double()).numpy()
    np.testing.assert_allclose(d, want[C_ROW, C_COL], rtol=1e-12, atol=0)


@pytest.mark.parametrize("B", [1, 2, 3, 5])
def test_kernel_operands_hold_the_scaled_split_bits(B):
    """axm_bf16_operands and atxm_bf16_operands, plain torch on the CPU:
    the forward operand interleaves per marker quad the parts of W 2^s and
    -U 2^s (s = 127 - E, one per column for both), the transpose operand
    holds per person quad the 4 planes' parts of V_k 2^(s - 2k); scaled
    back, every bf16 part is _split_hi_lo's, bit for bit."""
    rng = np.random.default_rng(20 + B)
    m, nb = 40, 24
    mag = 10.0 ** torch.from_numpy(rng.integers(-8, 9, (1, B)).astype(
        np.float32))
    W, U = _gauss(rng, m, B) * mag, _gauss(rng, m, B) * mag * 3
    V = _gauss(rng, 4, nb, B) * mag
    cg = tmv.bf16_group(B)
    G_ = -(-B // cg)
    rhs, E = tmv.axm_bf16_operands(W, U, cg)
    assert rhs.shape == (G_, 3 * cg, m // 4, 2, 4)
    v2, Ev = tmv.atxm_bf16_operands(V, cg)
    assert v2.shape == (G_, 3 * cg, nb // 4, 4, 4)
    quad = torch.tensor([0, 2, 1, 3])

    def parts(x, dim):
        return tmv._split_hi_lo(x, dim).to(torch.float32)

    want_w, want_u = parts(W, 1), parts(-U, 1)           # [m, 3B]
    want_v = parts(V, 2)                                  # [4, nb, 3B]
    for z in range(G_):
        for p in range(3):
            for c in range(cg):
                col = z * cg + c
                n = p * cg + c
                got = rhs[z, n].to(torch.float32)         # [m/4, 2, 4]
                gv = v2[z, n].to(torch.float32)           # [nb/4, 4, 4]
                if col >= B:
                    assert not got.any() and not gv.any()
                    continue
                sw = tmv._times_pow2(got, E[col] - 127)
                for o, want in ((0, want_w), (1, want_u)):
                    ref = want[:, p * B + col].reshape(-1, 4)[:, quad]
                    assert torch.equal(sw[:, o], ref)
                for k in range(4):
                    ref = want_v[k, :, p * B + col].reshape(-1, 4)[:, quad]
                    assert torch.equal(
                        tmv._times_pow2(gv[:, k], Ev[col] - 127 + 2 * k), ref)


# (Nw, Mpad, B, steps per part): rows past a group of 8 and a block of 16,
# Mpad not a multiple of a step (the masked last step), parts of one chain
# and less, B = 1, 2, 3, 5 (one and three column groups)
FW_CASES = [(8, 128, 1, 16), (7, 200, 2, 5), (20, 1000, 3, 9),
            (16, 64, 5, 1)]
TX_CASES = [(8, 64, 1, 1), (13, 100, 2, 2), (40, 136, 3, 3),
            (24, 64, 5, 100)]


@pytest.mark.parametrize("nw,m,B,per_part", FW_CASES)
def test_axm_bf16_lane_map(nw, m, B, per_part):
    """The emulated forward kernel equals axm_bf16_ref bit for bit on
    dyadic inputs (every partial sum exact, so any order and any chain
    length, truncating or not), and stays within kernel_check.TOL of
    float64 on Gaussian inputs."""
    rng = np.random.default_rng(nw * 31 + m + B)
    words = _words(rng, nw, m)
    W8, U8 = _dyadic(rng, m, B), _dyadic(rng, m, B)
    want = tmv.axm_bf16_ref(words, W8, U8)
    for rnd in (round_nearest, round_toward_zero):
        got = emulated_axm_bf16(words, W8, U8, per_part, rnd)
        assert got.shape == (4, 4 * nw, B)
        assert torch.equal(got, want)
    W, U = _gauss(rng, m, B), _gauss(rng, m, B, scale=0.1)
    got = emulated_axm_bf16(words, W, U, per_part)
    assert _rel(got, tmv.axm_ref(words, W, U, torch.float64)) < TOL


@pytest.mark.parametrize("nw,m,B,per_part", TX_CASES)
def test_atxm_bf16_lane_map(nw, m, B, per_part):
    """The emulated transpose kernel equals atxm_bf16_ref bit for bit on
    dyadic inputs and stays within kernel_check.TOL of float64 on Gaussian
    inputs."""
    rng = np.random.default_rng(nw * 37 + m + B)
    words = _words(rng, nw, m)
    V8 = _dyadic(rng, 4, 4 * nw, B)
    want = tmv.atxm_bf16_ref(words, V8)
    for rnd in (round_nearest, round_toward_zero):
        got = emulated_atxm_bf16(words, V8, per_part, rnd)
        for g_, w_ in zip(got, want):
            assert g_.shape == (m, B)
            assert torch.equal(g_, w_)
    V = _gauss(rng, 4, 4 * nw, B)
    got = emulated_atxm_bf16(words, V, per_part)
    for g_, w_ in zip(got, tmv.atxm_ref(words, V, torch.float64)):
        assert _rel(g_, w_) < TOL


def test_column_chunk_edge():
    """B = 64 is one launch of 32 column pairs, B = 65 two (64 + 1):
    both equal the plain versions bit for bit on dyadic inputs."""
    rng = np.random.default_rng(6)
    nw, m = 8, 64
    words = _words(rng, nw, m)
    for B in (64, 65):
        W8, U8 = _dyadic(rng, m, B), _dyadic(rng, m, B)
        V8 = _dyadic(rng, 4, 4 * nw, B)
        assert torch.equal(emulated_axm_bf16(words, W8, U8),
                           tmv.axm_bf16_ref(words, W8, U8))
        for g_, w_ in zip(emulated_atxm_bf16(words, V8),
                          tmv.atxm_bf16_ref(words, V8)):
            assert torch.equal(g_, w_)


def _long_forward(rng):
    """A forward problem of config B's contraction length (131,072
    markers), 8 word rows (128 outputs), B = 1."""
    words = _words(rng, 8, CFG_B_M)
    W, U = _gauss(rng, CFG_B_M, 1), _gauss(rng, CFG_B_M, 1, scale=0.1)
    return words, W, U, tmv.axm_ref(words, W, U, torch.float64)


def _long_transpose(rng):
    """A transpose problem of config B's contraction length (20,480 word
    rows, 327,680 people), 64 markers, B = 1."""
    words = _words(rng, CFG_B_NW, 64)
    V = _gauss(rng, 4, 4 * CFG_B_NW, 1)
    return words, V, tmv.atxm_ref(words, V, torch.float64)


def test_config_b_lengths_within_tolerance():
    """At config B's contraction lengths the kernels' chains and running
    sums stay within kernel_check.TOL of float64, whether the mma round to
    nearest or truncate."""
    rng = np.random.default_rng(7)
    words, W, U, z64 = _long_forward(rng)
    for rnd in (round_nearest, round_toward_zero):
        assert _rel(emulated_axm_bf16(words, W, U, mma_round=rnd), z64) < TOL
    words, V, ref = _long_transpose(rng)
    for rnd in (round_nearest, round_toward_zero):
        for g_, w_ in zip(emulated_atxm_bf16(words, V, mma_round=rnd), ref):
            assert _rel(g_, w_) < TOL


def test_one_long_chain_would_not():
    """Why the chain length is a constant: with truncating mma, one chain
    over the whole contraction (one part, no flush) errs beyond
    kernel_check.TOL at config B's lengths, while the kernels' chains stay
    within it (test_config_b_lengths_within_tolerance)."""
    rng = np.random.default_rng(7)
    words, W, U, z64 = _long_forward(rng)
    steps = CFG_B_M // FW_STEP
    err = _rel(emulated_axm_bf16(words, W, U, per_part=steps,
                                 mma_round=round_toward_zero, chain=steps),
               z64)
    assert err > TOL
    words, V, ref = _long_transpose(rng)
    steps = CFG_B_NW // 8
    got = emulated_atxm_bf16(words, V, per_part=steps,
                             mma_round=round_toward_zero, chain=steps)
    assert max(_rel(g_, w_) for g_, w_ in zip(got, ref)) > TOL


def test_chip_smoke_names_the_bf16_source(monkeypatch):
    """chip_smoke's no-spill check reads each bf16-split kernel's own entry
    in the ptxas report, not the other's nor a digit product's, and its
    kernels line names csrc/bf16_split.cu for both."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    smoke = importlib.import_module("chip_smoke")
    ns = "_ZN12_GLOBAL__N_1"
    own = {"axm_bf16": f"{ns}15axm_bf16_kernelEPKjPKtS3_Pfllil",
           "atxm_bf16": f"{ns}16atxm_bf16_kernelEPKjPKtPfllil"}
    others = [f"{ns}13axm_i8_kernelILi2EEEvPKjPKhS4_PiS5_llll",
              f"{ns}14atxm_i8_kernelILb1EEEvPKjPKhPiS5_llll"]
    for key, name in own.items():
        entry = smoke.PTXAS_ENTRY.get(key, f"{key}_kernel")
        assert [n for n in [*own.values(), *others]
                if re.search(entry, n)] == [name], key
    assert smoke.BF16_KERNELS == ("axm_bf16", "atxm_bf16")
    assert smoke.BF16_SOURCE == "gvamp_tpu_torch/csrc/bf16_split.cu"
    assert os.path.isfile(os.path.join(repo, smoke.BF16_SOURCE))
