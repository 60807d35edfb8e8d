"""The fused primal Grams' kernel (gvamp_tpu_torch/csrc/gram_prim.cu),
checked on the CPU, where it cannot run.

A numpy emulator follows gram_prim_kernel<kGeneral> as the source writes
it: the blocks' quad ranges (rq quads each, the last one short), each
block's ring of band tiles in shared memory (GRAM_RING slots of
GRAM_BAND_NW rows, each row copied whole at a pitch of 128 bytes and
shifted by swz(r) chunks; the rest of shared memory holds garbage, which
the forward side reads past a block's markers against zero digits), the
forward digit tile (W's digits, and -U's under the shared scale, zero past
the digit rows and the block's markers), the forward lane map (axm_i8's,
the A fragments from the SWAR decode, plane64, the mma.sync m16n8k32 u8 x
s8 -> s32 semantics, both planes into one accumulator), each warp's sums
checked inside int32 and shifted back before the shared atomics on the
swizzled forward tile and the global atomics into the band's slot of the
partial ring (whose reuse asserts the designated block's zeroing); the
fold, the band's max and the requantisation in float32 with the kernel's
order of roundings (a zero residual's divisions skipped); the transpose
lane map (atxm_i8's, the 64-marker groups 0-7 on the transpose warps and
8-15 on the forward warps, each plane type in turn), the exchange of
digits between lanes t and t^1, the fold and the running sums, kept per
lane from band to band for one digit group and read from and written to
av beyond.  The wrapper's steps around the
launch are the port's own (``matvec.gram_launch``'s digit rows 4b + d,
sv = colsum(z)).  The result must equal the plain versions ``gram_i8a_ref``
/ ``gram_i8_ref`` bit for bit at the edges chip_smoke.py's GRAM_PRIM_SHAPES
name (one band, fewer bands than the ring, a short last block, several
digit groups, odd and even B) with padding samples; at the route's edge
(Mpad 135,168 on 132 SMs) the largest sums (every call a = 2, every digit
127) stay exact.  The shifted rows, the digit tiles and the swizzled
forward tile are checked free of bank conflicts, and the plain versions
against the JAX kernels in interpret mode at a band height that is not
the JAX package's."""

import importlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from test_torch_fragments import (G, SCALE_SHIFT, T, mma, plane64,
                                  swar_a_fields, swar_b_fields,
                                  transpose_quad, wrap32)
from test_torch_gram_aat import F32, LANE, ODD, fold4, swz, u32
from test_torch_matvec import _gram_words, _t

# the kernel's constants (gram_prim.cu)
BAND = tmv.GRAM_BAND_NW          # kT
RING = tmv.GRAM_RING             # kRing
ZRING = 8                        # kZRing
GROUP_WARPS = 8                  # warps per group (forward, transpose)
MAX_MG = 2                       # kMaxMarkerGroups
DIG_PITCH = 80                   # kDigPitch
H100_SMS = tmv.GRAM_BLOCKS_H100
EDGE_MPAD = 135_168


def tile_pitch(rq):
    return -(-(4 * rq + 24) // 32) * 32


def dig_pitch(rq):
    return -(-(4 * rq) // 128) * 128 + 16


def ftile_at(n, k, p):
    return (n * 4 + k) * 4 * BAND + (p ^ ((n >> 1) & 3))


def row_base(r, pitch):
    """Word offset of tile row r in its ring slot: the pitch, then the
    shift of swz(r) 16-byte chunks."""
    return r * pitch + 4 * swz(r)


def forward(ring, slot, pitch, rlen, fdig, dp, general):
    """The forward group's contraction of one band and digit group from
    ring slot ``slot``: int64 sums [8 forward warps, 8 m tiles, 32 lanes,
    4] (64 times the true ones), each warp's inside int32.  ``fdig`` is the
    digit tile [2, 8, dp] int8."""
    steps = [(w, m) for w in range(GROUP_WARPS)
             for m in range(32 * (w >> 1), rlen, 32 * GROUP_WARPS // 2)]
    ws = np.array([w for w, _ in steps])
    ms = np.array([m for _, m in steps])
    r = 8 * (ws[:, None] & 1) + G[None, :]                    # [S, 32]
    base = slot * BAND * pitch + row_base(r, pitch) + 4 * T + ms[:, None]
    x0 = ring[base[..., None] + np.arange(4)]
    x1 = ring[base[..., None] + 16 + np.arange(4)]
    d8 = fdig.view(np.uint8).reshape(2, -1)
    off = G * dp + 4 * T + ms[:, None]                        # [S, 32]
    digs = [np.stack([u32(d8[p], off), u32(d8[p], off + 16)], axis=-1)
            for p in range(1 + general)]                      # [S, 32, 2]
    decs = [swar_a_fields] + [swar_b_fields] * general
    y0, y1 = transpose_quad(x0), transpose_quad(x1)
    acc = np.zeros((len(steps), 8, 32, 4), np.int64)
    for b in range(4):
        for p, dec in enumerate(decs):
            f0, f1 = dec(y0[..., b]), dec(y1[..., b])
            for h in range(2):
                a = np.stack([plane64(f0, 2 * h), plane64(f0, 2 * h + 1),
                              plane64(f1, 2 * h), plane64(f1, 2 * h + 1)],
                             axis=-1)
                acc[:, 2 * b + h] = mma(acc[:, 2 * b + h], a, digs[p])
    warps = np.zeros((GROUP_WARPS, 8, 32, 4), np.int64)
    np.add.at(warps, ws, acc)
    assert (wrap32(warps) == warps).all(), "a warp's forward sum left int32"
    assert (warps % (1 << SCALE_SHIFT) == 0).all()
    return warps


def forward_tile(warps):
    """The shared atomics of the forward warps' sums, shifted back, on the
    swizzled forward tile [8 digit rows x 4 planes x 64 rows]."""
    ftile = np.zeros(8 * 4 * 4 * BAND, np.int64)
    r = 8 * (np.arange(GROUP_WARPS)[:, None] & 1) + G[None, :]   # [w, 32]
    for b in range(4):
        for h in range(2):
            for half in range(2):
                for c in range(2):
                    at = ftile_at(2 * T + c, 2 * h + half, 4 * r + b)
                    np.add.at(ftile, at, warps[:, 2 * b + h, :, 2 * half + c]
                              >> SCALE_SHIFT)
    return ftile


def transpose(ring, slot, pitch, rlen, zd8, scs, general):
    """The transpose side of one band and digit group, the exchange and the
    fold: (folds f32 [types, 8 warps, MAX_MG, 4 lh, 32 lanes], live [8,
    MAX_MG] marker groups).  Marker group w + 8k is warp w's of the
    transpose group (k = 0) or of the forward group (k = 1), each plane
    type in turn."""
    pairs = [(w, k) for w in range(GROUP_WARPS) for k in range(MAX_MG)
             if 64 * (w + GROUP_WARPS * k) < rlen]
    mg = np.array([w + GROUP_WARPS * k for w, k in pairs])
    decs = [swar_a_fields] + [swar_b_fields] * general
    acc = np.zeros((len(decs), len(pairs), 4, 32, 4), np.int64)
    zb = zd8.view(np.uint8).ravel()
    for st in range(2):
        ia = 8 * st + T
        ib = ia + 4
        for l in range(2):
            q = np.minimum(16 * mg[:, None] + 8 * l + G[None, :],
                           rlen // 4 - 1)                      # [P, 32]
            xs = [ring[(slot * BAND * pitch + row_base(rr, pitch) + 4 * q)
                       [..., None] + np.arange(4)] for rr in (ia, ib)]
            for kk in range(4):
                bb = np.stack([u32(zb, (kk * 8 + G) * DIG_PITCH + 4 * ia),
                               u32(zb, (kk * 8 + G) * DIG_PITCH + 4 * ib)],
                              axis=-1)                         # [32, 2]
                for p, dec in enumerate(decs):
                    fa, fb = dec(xs[0]), dec(xs[1])
                    for h in range(2):
                        a = np.stack([plane64(fa[..., 2 * h], kk),
                                      plane64(fa[..., 2 * h + 1], kk),
                                      plane64(fb[..., 2 * h], kk),
                                      plane64(fb[..., 2 * h + 1], kk)],
                                     axis=-1)
                        acc[p, :, 2 * l + h] = mma(acc[p, :, 2 * l + h], a,
                                                   bb)
    assert (wrap32(acc) == acc).all(), "a warp's transpose sum left int32"
    a = acc >> SCALE_SHIFT
    odd = ODD[:, None]
    send = np.where(odd, a[..., 0:2], a[..., 2:4])
    recv = send[..., LANE ^ 1, :]
    own = np.where(odd, a[..., 2:4], a[..., 0:2])
    td = np.where(odd, np.concatenate([recv, own], -1),
                  np.concatenate([own, recv], -1))
    s = scs.reshape(2, 4)[T >> 1].T                            # [4, 32]
    folds = np.zeros((len(decs), GROUP_WARPS, MAX_MG, 4, 32), F32)
    live = np.zeros((GROUP_WARPS, MAX_MG), bool)
    v = fold4(np.moveaxis(td, -1, 0), s[:, None, None, None, :])
    for i, (w, k) in enumerate(pairs):
        folds[:, w, k] = v[:, i]
        live[w, k] = True
    return folds, live


def markers():
    """Marker of sum [w, k, lh, lane] within the block's range."""
    w = np.arange(GROUP_WARPS)[:, None, None, None]
    k = np.arange(MAX_MG)[None, :, None, None]
    lh = np.arange(4)[None, None, :, None]
    return (64 * (w + GROUP_WARPS * k) + 32 * (lh // 2) + 4 * G + 2 * (lh % 2)
            + (T & 1))


def emulate_gram_prim(words, W, na_planar, other, general, nblocks=H100_SMS,
                      seed=0):
    """gram_prim_kernel<general>'s outputs (av, bv f32[B, Mpad], zout
    f32[4, Nb, B]) from the wrapper's operands, on a grid of
    ceil(nq / rq) blocks of rq = ceil(nq / nblocks) quads."""
    nw, mpad = words.shape
    B = W.shape[1]
    nb, D, groups = 4 * nw, 4 * B, (B + 1) // 2
    nbands = nw // BAND
    tW = torch.from_numpy(W)

    def rows(d8):
        return d8.reshape(4, B, mpad).transpose(0, 1).reshape(D, mpad) \
            .contiguous().numpy()

    if general:
        w8t, mu8t, ws = tmv._quant_digits_pair(tW, torch.from_numpy(other))
        digits = [rows(w8t), rows(mu8t)]
    else:
        w8t, ws = tmv._quant_rows(tW)
        digits = [rows(w8t)]
        cu = np.asarray(other, F32)
    wsc = tmv._digit_scales(ws).numpy()
    na = tmv._mask_cols(torch.from_numpy(na_planar), B).numpy()
    rng = np.random.default_rng(seed)
    wd = words.astype(np.int64)
    nq = mpad // 4
    rq = -(-nq // nblocks)
    grid = -(-nq // rq)
    assert 4 * rq <= MAX_MG * GROUP_WARPS * 64, "beyond the kernel's blocks"
    pitch, dp = tile_pitch(rq), dig_pitch(rq)
    zacc = np.zeros((ZRING, D * 4 * 4 * BAND), np.int64)
    out = np.zeros((1 + general, B, mpad), F32)
    zout = np.full((4, nb, B), np.nan, F32)
    blocks = []
    for j in range(grid):
        q0 = j * rq
        rlen = 4 * min(rq, nq - q0)
        # shared memory: the ring, then garbage (the forward tile's words)
        ring = rng.integers(0, 2**32, RING * BAND * pitch + 64)
        blocks.append(dict(j=j, m0=4 * q0, rlen=rlen, ring=ring, sums=np.zeros(
            (1 + general, GROUP_WARPS, MAX_MG, 4, 32), F32)))

    def digit_tile(blk, dg):
        fdig = np.zeros((2, 8, dp), np.int8)
        for p, d8 in enumerate(digits):
            n = min(8, D - 8 * dg)
            fdig[p, :n, :blk["rlen"]] = d8[8 * dg:8 * dg + n,
                                           blk["m0"]:blk["m0"] + blk["rlen"]]
        return fdig

    for i in range(nbands):
        zs, slot = i % ZRING, i % RING
        zslot = zacc[zs]
        # the slot's earlier band was zeroed by its designated block
        assert not zslot.any()
        for blk in blocks:
            ring, rlen, m0 = blk["ring"], blk["rlen"], blk["m0"]
            for r in range(BAND):
                at = slot * BAND * pitch + row_base(r, pitch)
                ring[at:at + rlen] = wd[i * BAND + r, m0:m0 + rlen]
            for dg in range(groups):
                ftile = forward_tile(forward(ring, slot, pitch, rlen,
                                             digit_tile(blk, dg), dp,
                                             general))
                nn, k, p = np.meshgrid(np.arange(8), np.arange(4),
                                       np.arange(4 * BAND), indexing="ij")
                ok = 8 * dg + nn < D
                np.add.at(zslot, (((8 * dg + nn) * 4 + k) * 4 * BAND + p)[ok],
                          ftile[ftile_at(nn, k, p)][ok])
        # every block has arrived at band i: block (i - RING) mod grid
        # zeroes band i - RING's slot
        iz = i - RING
        if iz >= 0 and iz + ZRING < nbands:
            zacc[iz % ZRING] = 0
        u = np.arange(4 * 4 * BAND)
        fk, fp = u >> 6, u & 63
        for dg in range(groups):
            # the fold, identical in every block; block 0 writes z
            z = np.zeros((2, 4 * 4 * BAND), F32)
            for c in range(2):
                b = min(2 * dg + c, B - 1)
                tt = np.stack([zslot[((4 * b + d) * 4 + fk) * 4 * BAND + fp]
                               for d in range(4)])
                f = fold4(tt, wsc[:, b][:, None])
                mk = na[fk, 4 * BAND * i + fp, b]
                if 2 * dg + c < B:
                    z[c] = f * mk if general else (f - cu[b]) * mk
                    zout[fk, 4 * BAND * i + fp, b] = z[c]
            zd8 = np.zeros((4, 8, DIG_PITCH), np.int8)
            scs = np.zeros((2, 4), F32)
            for c in range(2):
                mx = np.abs(z[c]).max()
                sc = [(F32(1) if mx == 0 else mx) / F32(127)]
                for _ in range(3):
                    sc.append(sc[-1] / F32(127))
                scs[c] = sc
                rr = z[c]
                for d in range(4):
                    # a zero residual gives a zero digit and stays zero
                    live = rr != 0
                    dz = np.where(live, np.rint(rr / sc[d]), F32(0))
                    zd8[fk, 4 * c + d, fp] = dz.astype(np.int8)
                    rr = np.where(live, rr - dz * sc[d], rr)
            for blk in blocks:
                folds, live = transpose(blk["ring"], slot, pitch, blk["rlen"],
                                        zd8, scs, general)
                mm = markers()
                b = 2 * dg + (T >> 1)
                ok = (mm < blk["rlen"]) & (b < B) & live[:, :, None, None]
                idx = (np.broadcast_to(b, mm.shape)[ok], blk["m0"] + mm[ok])
                for p in range(1 + general):
                    if groups == 1:
                        s = blk["sums"][p]
                        s[live] = s[live] + folds[p][live]
                    else:
                        out[p][idx] = out[p][idx] + folds[p][ok]
    if groups == 1:
        mm = markers()
        b = np.broadcast_to(T >> 1, mm.shape)
        for blk in blocks:
            ok = (mm < blk["rlen"]) & (b < B)
            for p in range(1 + general):
                out[p][b[ok], blk["m0"] + mm[ok]] = blk["sums"][p][ok]
    return out, zout


def emulated(words, W, na, other, general, nblocks=H100_SMS):
    """The wrapper's result around the emulated kernel."""
    out, zout = emulate_gram_prim(words, W, na, other, general, nblocks)
    av = torch.from_numpy(out[0]).T
    if general:
        return av, torch.from_numpy(out[1]).T
    return av, torch.from_numpy(zout).sum(dim=(0, 1))


def _inputs(rng, nw, m, B, per_col, general, pad):
    words = _gram_words(rng, nw, m, complete=not general, n_pad=pad)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 0.5).astype(np.float32)
    na = (rng.random((4, 4 * nw, B) if per_col else (4, 4 * nw))
          > 0.1).astype(np.float32)
    cu = rng.standard_normal(B).astype(np.float32)
    return words, W, na, U if general else cu


# (Nw, Mpad, B, SMs, per-column mask, padding samples): one band (16), two
# (fewer than the ring's three), three, and ten (160 rows: the ring of 8
# partial slots reused twice); on 132 SMs Mpad 512 (128 blocks of one
# quad), 1,004 (a last block of one quad of two) and 4,204 (a last block
# of 3 quads of 8), on 3 SMs 1,000 (84, 84 and 82 quads), on 2 SMs 2,040
# (1,020 words per row: two 64-marker groups on every transpose warp);
# B = 1, 2 (one digit group, the sums kept in registers), 3 and 5 (two
# and three groups, av read and written per band)
CASES = [(16, 512, 1, H100_SMS, False, 3), (32, 1004, 2, H100_SMS, True, 0),
         (48, 4204, 3, H100_SMS, False, 5), (160, 1000, 2, 3, True, 7),
         (32, 2040, 5, 2, True, 1)]


@pytest.mark.parametrize("nw,m,B,nblocks,per_col,pad", CASES)
@pytest.mark.parametrize("general", [False, True])
def test_emulated_kernel_equals_plain_version(nw, m, B, nblocks, per_col, pad,
                                              general):
    """gram_prim_kernel<general>, emulated, equals gram_i8_ref (both planes,
    on words with missing calls) or gram_i8a_ref (the a-plane, on complete
    words) bit for bit."""
    rng = np.random.default_rng(nw + m + B + nblocks + pad + general)
    words, W, na, other = _inputs(rng, nw, m, B, per_col, general, pad)
    t = torch.from_numpy
    want = (tmv.gram_i8_ref(_t(words), t(W), t(other), t(na)) if general
            else tmv.gram_i8a_ref(_t(words), t(W), t(na), t(other)))
    got = emulated(words, W, na, other, general, nblocks)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("general", [False, True])
def test_largest_sums_at_the_route_edge(general):
    """Mpad = 135,168 on 132 SMs (256 quads per block, GRAM_MAX_QUADS),
    every call a = 2 (code 00) and every digit
    127: each warp's 64-fold forward sum stays inside int32, and the
    blocks' partials, shifted back and added, equal the plain integer
    products (381 Mpad with both planes, 254 Mpad with the a-plane).  With
    W of equal entries (first digits 127) the emulated kernel equals the
    plain version there."""
    nw, m = BAND, EDGE_MPAD
    def fits(mm):
        return tmv.gram_fits(torch.empty((nw, mm), dtype=torch.int32,
                                         device="meta"))
    assert fits(m) and not fits(m + 4)
    nq = m // 4
    rq = -(-nq // H100_SMS)
    assert rq == tmv.GRAM_MAX_QUADS and rq * H100_SMS == nq
    pitch, dp = tile_pitch(rq), dig_pitch(rq)
    ring = np.zeros(RING * BAND * pitch + 64, np.int64)
    fdig = np.full((2, 8, dp), 127, np.int8)
    fdig[:, :, 4 * rq:] = 0                      # zero past the block's markers
    ftile = forward_tile(forward(ring, 0, pitch, 4 * rq, fdig, dp, general))
    total = ftile * H100_SMS                     # every block the same
    want = (2 + general) * 127 * m
    assert int(total.max()) == int(total.min()) == want < 2**31
    rng = np.random.default_rng(136)
    words = np.zeros((nw, m), np.uint32)
    W = np.ones((m, 2), np.float32)
    na = (rng.random((4, 4 * nw)) > 0.1).astype(np.float32)
    other = W * 0.5 if general else np.zeros(2, np.float32)
    t = torch.from_numpy
    want_t = (tmv.gram_i8_ref(_t(words), t(W), t(other), t(na)) if general
              else tmv.gram_i8a_ref(_t(words), t(W), t(na), t(other)))
    for g_, w_ in zip(emulated(words, W, na, other, general), want_t):
        assert torch.equal(g_, w_)


def test_shared_memory_access_is_conflict_free():
    """The shifted tile rows serve both sides' quarter warps on 8 distinct
    16-byte positions mod 8 (the forward side's rows 2p, 2p+1 at chunks
    c..c+3, the transpose side's rows t = 0..3 at chunks c + g); the
    forward digit tile's and the band digits' u32 B fragments, and the
    forward tile's atomics, fall on 32 distinct banks per warp."""
    for rq in (1, 249, 258):
        pitch, dp = tile_pitch(rq), dig_pitch(rq)
        assert pitch % 32 == 0 and pitch >= 4 * rq + 24
        for qw in range(4):
            lanes = LANE[8 * qw:8 * qw + 8]
            g, t = lanes // 4, lanes % 4
            for rg in range(2):
                for m in (0, 32, 96):
                    for off in (0, 16):
                        at = row_base(8 * rg + g, pitch) + m + off + 4 * t
                        assert len(set(at // 4 % 8)) == 8
            for st in range(2):
                for l in range(2):
                    for rows in (8 * st + t, 8 * st + t + 4):
                        at = row_base(rows, pitch) + 4 * (16 * 3 + 8 * l + g)
                        assert len(set(at // 4 % 8)) == 8
        for m in (0, 32):
            assert len(set((G * dp + m + 4 * T) // 4 % 32)) == 32
    for st in range(2):
        for kk in range(4):
            at = (kk * 8 + G) * DIG_PITCH + 4 * (8 * st + T)
            assert len(set(at // 4 % 32)) == 32
    for rg in range(2):
        for b in range(4):
            for k in range(4):
                for c in range(2):
                    at = ftile_at(2 * T + c, k, 4 * (8 * rg + G) + b)
                    assert len(set(at % 32)) == 32
    n, k, p = np.meshgrid(np.arange(8), np.arange(4), np.arange(4 * BAND),
                          indexing="ij")
    assert len(set(ftile_at(n, k, p).ravel())) == 8 * 4 * 4 * BAND


@pytest.mark.parametrize("general", [False, True])
def test_plain_versions_match_pallas_at_the_band(general):
    """gram_i8[a]_ref at GRAM_BAND_NW = 16 rows against gram_i8[a]_pallas
    (tnw=16) in interpret mode, with a per-column mask, three bands and
    padding samples, within tests/test_torch_gram.py's PALLAS_TOL."""
    from test_torch_gram import PALLAS_TOL, _close
    rng = np.random.default_rng(16 + general)
    words, W, na, other = _inputs(rng, 48, 512, 2, True, general, 9)
    t = torch.from_numpy
    if general:
        got = tmv.gram_i8(_t(words), t(W), t(other), t(na))
        want = jmv.gram_i8_pallas(jnp.asarray(words), jnp.asarray(W),
                                  jnp.asarray(other), jnp.asarray(na),
                                  tnw=BAND)
    else:
        got = tmv.gram_i8a(_t(words), t(W), t(na), t(other))
        want = jmv.gram_i8a_pallas(jnp.asarray(words), jnp.asarray(W),
                                   jnp.asarray(na), jnp.asarray(other),
                                   tnw=BAND)
    for g_, w_ in zip(got, want):
        _close(g_, w_, PALLAS_TOL)


def test_chip_smoke_ptxas_entries_name_the_primal_grams(monkeypatch):
    """chip_smoke's no-spill check reads each primal Gram's own
    instantiation of gram_prim_kernel<kGeneral> in csrc/gram_prim.cu, and
    its kernels line names that source for both; GRAM_PRIM_SHAPES hold
    whole bands and reach the route's edge."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    smoke = importlib.import_module("chip_smoke")
    ns = "_ZN45_GLOBAL__N__d83d7be4_12_gram_prim_cu_b5416be8"

    def mangled(general):
        return (f"{ns}16gram_prim_kernelILb{int(general)}EEEvPKjPKhS4_PKfS6_"
                f"S6_PiPfS8_S8_llll")

    own = {"gram_i8a": mangled(False), "gram_i8": mangled(True)}
    others = ["_ZN44_GLOBAL__N__b15c4a55_11_gram_aat_cu_4b4b5a4f15gram_aat_"
              "kernelILb0EEEvPKjPKhPKfS6_S6_S6_PfS7_lll"]
    for key, name in own.items():
        hits = [n for n in [*own.values(), *others]
                if re.search(smoke.PTXAS_ENTRY[key], n)]
        assert hits == [name], key
    assert smoke.GRAM_PRIM_SOURCE == "gvamp_tpu_torch/csrc/gram_prim.cu"
    assert os.path.isfile(os.path.join(repo, smoke.GRAM_PRIM_SOURCE))
    assert all(nw % BAND == 0 for nw, _, _ in smoke.GRAM_PRIM_SHAPES)
    assert max(m for _, m, _ in smoke.GRAM_PRIM_SHAPES) == EDGE_MPAD
    assert {B for _, _, B in smoke.GRAM_PRIM_SHAPES} >= {1, 2, 3, 4, 5, 70}
