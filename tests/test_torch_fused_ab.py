"""gvamp_tpu_torch/csrc/fused_ab.cu (v6_fused_ab's wgmma kernel) emulated
in numpy: its tiles and word rows, each warp's slot, the lanes' byte
permutes, field decodes and planes where they lie, the m64nNk32 A
fragments, the B operand read from the wrapper's digit layout through the
kernel's descriptor strides, the accumulator layout and the epilogue's
shifts, held bit for bit against axm_i8s's exact integers at every digit
group width.  Words past Nw or Mpad are garbage, as the kernel's shared
memory holds whatever the stage held before: the zero digits must cancel
them.  The kernel itself is held against its plain version on the card
by chip_smoke.py."""

import numpy as np
import pytest
import torch

from gvamp_tpu_torch.ops import matvec, study

U32 = np.uint64(0xFFFFFFFF)
M5 = np.uint64(0x55555555)

# fused_ab.cu's fab_p (planar rows a lane takes) and fab_wgs (consumer
# warpgroups) per digit group width N
CONFIG = {8: (8, 2), 16: (8, 2), 32: (4, 2), 64: (4, 3), 128: (2, 2),
          256: (2, 2)}


def byte_perm(x, y, sel):
    """__byte_perm(x, y, sel) on uint64-held u32 arrays: byte i of the
    result is byte (sel >> 4i) & 7 of [x, y]."""
    src = [(x >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)] + \
          [(y >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint64(8 * i)
    return out


def a_fields(w):
    notlo = ~w & M5
    return ((notlo << np.uint64(1)) - ((w >> np.uint64(1)) & notlo)) & U32


def b_fields(w):
    return (~w | (w >> np.uint64(1))) & M5


def plane_at(f, k):
    return f & (np.uint64(0x03030303) << np.uint64(2 * k))


def as_bytes(reg):
    """u32 registers [...] -> their four bytes [..., 4] (u8 values)."""
    return np.stack([(reg >> np.uint64(8 * e)) & np.uint64(0xFF)
                     for e in range(4)], -1).astype(np.int64)


def emulate(words, w8t, mu8t):
    """The kernel's int32[D, 4, 4 Nw] from words uint32[Nw, Mpad] and the
    digit rows int8[D, Mpad]; every part's scaled sums are checked to fit
    int32 and to be multiples of their plane's 4^k."""
    nw, m = words.shape
    D = w8t.shape[0]
    N = study.fused_ab_n(D)
    kt = study.fused_ab_kt(N)
    kp, wgs = CONFIG[N]
    subsets, tiles_q = 16 // kp, kp // 2
    warps = 4 * wgs
    rows = 8 * warps // subsets
    chunk = min(N, 64)
    dig = study.fused_ab_digits(torch.from_numpy(w8t), torch.from_numpy(mu8t),
                                N, kt).numpy()
    groups, tiles = dig.shape[:2]
    rng = np.random.default_rng(0)
    nwp = -(-nw // rows) * rows
    mp = tiles * kt
    w = rng.integers(0, 2**32, (nwp, mp), dtype=np.uint64)  # stale words
    w[:nw, :m] = words.astype(np.uint64)
    out = np.zeros((D, 4, 4 * nw), np.int64)
    g = np.arange(8)[:, None]
    t = np.arange(4)[None, :]
    for z in range(groups):
        for i0 in range(0, nwp, rows):
            acc = np.zeros((wgs, tiles_q, N // chunk, 64, chunk), np.int64)
            for j in range(tiles):
                flat = dig[z, j].reshape(-1).astype(np.int64)
                for st in range(kt // 32):
                    m0 = j * kt + 32 * st
                    for wg in range(wgs):
                        A = np.zeros((tiles_q, 2, 64, 32), np.int64)
                        for w4 in range(4):
                            v = 4 * wg + w4
                            rg, sub = v // subsets, v % subsets
                            row = i0 + 8 * rg + g           # [8, 1]
                            x0 = [w[row, m0 + 4 * t + q] for q in range(4)]
                            x1 = [w[row, m0 + 16 + 4 * t + q]
                                  for q in range(4)]
                            b0 = sub * tiles_q // 2
                            pair = 0x7362 if b0 >> 1 else 0x5140
                            for q in range(tiles_q):
                                b = b0 + q // 2
                                half = 0x7632 if b & 1 else 0x5410
                                k0 = 2 * (q & 1 if tiles_q > 1 else sub & 1)
                                ys = [byte_perm(byte_perm(x[0], x[1], pair),
                                                byte_perm(x[2], x[3], pair),
                                                half) for x in (x0, x1)]
                                for p, fields in enumerate((a_fields,
                                                            b_fields)):
                                    f0, f1 = (fields(y) for y in ys)
                                    regs = (plane_at(f0, k0),
                                            plane_at(f0, k0 + 1),
                                            plane_at(f1, k0),
                                            plane_at(f1, k0 + 1))
                                    r0 = 16 * w4
                                    for r, (dr, dk) in enumerate(
                                            ((0, 0), (8, 0), (0, 16),
                                             (8, 16))):
                                        blk = as_bytes(regs[r])  # [8,4,4]
                                        for tt in range(4):
                                            A[q, p, r0 + dr:r0 + dr + 8,
                                              dk + 4 * tt:dk + 4 * tt + 4] = \
                                                blk[:, tt, :]
                        for c in range(N // chunk):
                            for p in range(2):
                                # the descriptor's walk: LBO 16 N bytes
                                # between the 16-marker halves, SBO 128
                                # between groups of 8 digit rows
                                start = p * kt * N + 32 * st * N + \
                                    16 * chunk * c
                                k = np.arange(32)[:, None]
                                n = np.arange(chunk)[None, :]
                                Bm = flat[start + (k // 16) * 16 * N +
                                          (n // 8) * 128 + (n % 8) * 16 +
                                          k % 16]
                                for q in range(tiles_q):
                                    acc[wg, q, c] += A[q, p] @ Bm
            assert np.abs(acc).max() < 2**31
            for wg in range(wgs):
                for w4 in range(4):
                    v = 4 * wg + w4
                    rg, sub = v // subsets, v % subsets
                    b0 = sub * tiles_q // 2
                    for q in range(tiles_q):
                        b = b0 + q // 2
                        hq = q & 1 if tiles_q > 1 else sub & 1
                        for c in range(N // chunk):
                            for e in range(chunk // 2):
                                jj, r = e >> 2, e & 3
                                kpl = 2 * hq + (r >> 1)
                                col = 8 * jj + 2 * t + (r & 1)   # [1, 4]
                                val = acc[wg, q, c, 16 * w4 + g + 8 * (r >> 1),
                                          col]                    # [8, 4]
                                assert not (val % 4 ** kpl).any()
                                i = i0 + 8 * rg + g
                                d = z * N + c * chunk + col
                                ok = (i < nw) & (d < D)
                                ii, dd = np.broadcast_arrays(i, d)
                                np.add.at(out, (dd[ok], kpl, 4 * ii[ok] + b),
                                          (val >> (2 * kpl))[ok])
    return out


@pytest.mark.parametrize("nw,m,B", [(40, 300, 2), (7, 8, 1), (40, 300, 5),
                                    (50, 600, 16), (9, 300, 17),
                                    (17, 200, 64), (9, 100, 70)])
def test_kernel_lane_map_equals_the_exact_sums(nw, m, B):
    """The emulated kernel equals axm_i8s's integers (a-plane against W's
    digits plus b-plane against -U's, one joint scale) at every group width
    N (8 to 256, and two groups at B = 70), with a part tile of rows and
    of markers."""
    rng = np.random.default_rng(nw * 1000 + m + B)
    words = rng.integers(0, 2**32, (nw, m), dtype=np.uint64).astype(np.uint32)
    W = torch.from_numpy(rng.standard_normal((m, B)).astype(np.float32))
    U = torch.from_numpy((rng.standard_normal((m, B)) * 3).astype(np.float32))
    w8t, mu8t, _ = matvec._quant_digits_pair(W, U)
    want = matvec.axm_i8s_int_ref(
        torch.from_numpy(words.view(np.int32).copy()), w8t, mu8t).numpy()
    got = emulate(words, w8t.numpy(), mu8t.numpy())
    np.testing.assert_array_equal(got, want)
