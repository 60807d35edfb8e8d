"""The fused dual Grams' kernel (gvamp_tpu_torch/csrc/gram_aat.cu), checked
on the CPU, where it cannot run.

A numpy emulator follows gram_aat_kernel<kBoth> as the source writes it,
block by block and stripe by stripe: the transpose side's lane loads (from
the words in the first digit group, storing them into the swizzled stripe
cache; from the cache after it), the A fragments from the SWAR decode
(plane64), the mma.sync m16n8k32 u8 x s8 -> s32 semantics, each warp's
sums shifted back and added by shared-memory atomics into the swizzled
[8 x 64] tiles; the fold, W, the stripe's max and the requantisation in
float32 with the kernel's order of roundings; the forward side's lane
loads from the cache, the byte transpose, the exchange of digits between
lanes t and t^1 and the fold; the group sums (the first stripe of a block
stores, the others add).  The wrapper's steps around the launch are the
port's own (``matvec.gram_aat_launch``'s digit layout, the sum over the
groups, colsum(mave W)).  The result must equal the plain versions
``gram_aat_i8a_ref`` / ``gram_aat_i8_ref`` bit for bit, at Nw not a
multiple of 8, Mpad of one stripe, a short last group and several groups,
odd and even B (one, two and three digit groups) and padding samples; the
largest sums (every call a = 2, every digit 127) at Nw = 822, the route's
edge, stay exact.  The plain versions are held against the JAX kernels in
interpret mode at a short last group too."""

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
from test_torch_matvec import (GRAM_TOL, _close, _gram_inputs, _gram_words,
                               _t)

# the kernel's constants (gram_aat.cu)
S = tmv.GRAM_AAT_STRIPE
GROUP = tmv.GRAM_AAT_GROUP
WARPS = 8
TX_LOADS = S // 32
F32 = np.float32
LANE = np.arange(32)
ODD = (T & 1).astype(bool)


def swz(r):
    return ((r & 1) << 2) | (r & 2)


def chunk(r, q):
    """Word offsets [..., 4] of chunk q of cache row r (the swizzle)."""
    return (r * S + 4 * (q ^ swz(r)))[..., None] + np.arange(4)


def tile_at(n, m):
    return n * S + (m ^ ((n >> 1) & 3))


def fold4(t, s):
    """fold4 in float32: t [4, ...] int sums, s [4, ...] scales."""
    acc = F32(t[0]) * s[0]
    for d in range(1, 4):
        acc = acc + F32(t[d]) * s[d]
    return acc


def u32(b8, off):
    """The little-endian u32 at byte offsets ``off`` of the uint8 array b8."""
    return sum(b8[off + j].astype(np.int64) << (8 * j) for j in range(4))


def tx_side(words, cache, m0, vflat, rows, D, nw, load, both):
    """The transpose side of one stripe and digit group: int64 tile sums
    [types, 8 * S] in the kernel's swizzled layout.  ``vflat`` is V's
    digits int8[4, D, Nb] as bytes, ``rows`` [32] each lane's digit row.
    With ``load`` the words come from HBM and go into ``cache``; else
    from the cache, which must hold them."""
    decs = [swar_a_fields] + [swar_b_fields] * both
    nb = 4 * nw
    steps = -(-nw // 8)
    st = np.arange(steps)[:, None]                           # [st, 1]
    ia, ib = 8 * st + T, 8 * st + T + 4                      # [st, 32]
    la, lb = ia < nw, ib < nw
    x = {}
    for name, r, live in (("a", ia, la), ("b", ib, lb)):
        rc = np.minimum(r, nw - 1)
        for l in range(TX_LOADS):
            q = 8 * l + G                                    # [32]
            if load:
                v = words[rc[..., None], m0 + 4 * q[:, None] + np.arange(4)]
                v = np.where(live[..., None], v, 0)
                cache[chunk(r[live], np.broadcast_to(q, r.shape)[live])] = \
                    v[live]
            else:
                v = cache[chunk(rc, np.broadcast_to(q, r.shape))]
                v = np.where(live[..., None], v, 0)
                assert (v >= 0).all(), "read a cache row never stored"
            x[name, l] = v                                   # [st, 32, 4]
    accs = np.zeros((len(decs), steps, 2 * TX_LOADS, 32, 4), np.int64)
    for k in range(4):
        base = (k * D + rows) * nb                           # [32]
        b0 = np.where(la, u32(vflat, base + 4 * np.minimum(ia, nw - 1)), 0)
        b1 = np.where(lb, u32(vflat, base + 4 * np.minimum(ib, nw - 1)), 0)
        bb = np.stack([b0, b1], axis=-1)                     # [st, 32, 2]
        for l in range(TX_LOADS):
            for h in range(2):
                for p, dec in enumerate(decs):
                    xa, xb = x["a", l], x["b", l]
                    a = np.stack([plane64(dec(xa[..., 2 * h]), k),
                                  plane64(dec(xa[..., 2 * h + 1]), k),
                                  plane64(dec(xb[..., 2 * h]), k),
                                  plane64(dec(xb[..., 2 * h + 1]), k)],
                                 axis=-1)
                    accs[p, :, 2 * l + h] = mma(accs[p, :, 2 * l + h], a, bb)
    tsum = np.zeros((len(decs), 8 * S), np.int64)
    for w in range(WARPS):
        part = accs[:, w::WARPS].sum(axis=1)                 # [p, 4, 32, 4]
        assert (wrap32(part) == part).all(), "a warp's sum left int32"
        part = part >> SCALE_SHIFT
        for lh in range(2 * TX_LOADS):
            for half in range(2):
                for c in range(2):
                    m = 32 * (lh // 2) + 4 * G + 2 * (lh % 2) + half
                    at = tile_at(2 * T + c, m)
                    assert len(set(at % 32)) == 32, "bank conflict"
                    np.add.at(tsum, (slice(None), at),
                              part[:, lh, :, 2 * half + c])
    return tsum


def fw_ints(cache, dig8, nw, both):
    """The forward side's int32 C fragments [groups, 8 tiles, 32, 4] from
    the cache against the digit tiles dig8 [types, 8, S] int8 (64 times
    the true sums, plane64's factor)."""
    steps = -(-nw // 8)
    d8 = dig8.view(np.uint8).reshape(len(dig8), -1)
    dig = [[np.stack([u32(d8[p], G * S + 32 * ks + 16 * u + 4 * T)
                      for u in range(2)], axis=-1) for ks in range(2)]
           for p in range(1 + both)]                         # [32, 2]
    decs = [swar_a_fields] + [swar_b_fields] * both
    r = np.minimum(8 * np.arange(steps)[:, None] + G, nw - 1)  # [grp, 32]
    acc = np.zeros((steps, 8, 32, 4), np.int64)
    for ks in range(2):
        y0 = transpose_quad(cache[chunk(r, 8 * ks + T)])
        y1 = transpose_quad(cache[chunk(r, 8 * ks + 4 + T)])
        for b in range(4):
            for h in range(2):
                for p, dec in enumerate(decs):
                    f0, f1 = dec(y0[..., b]), dec(y1[..., b])
                    a = np.stack([plane64(f0, 2 * h), plane64(f0, 2 * h + 1),
                                  plane64(f1, 2 * h), plane64(f1, 2 * h + 1)],
                                 axis=-1)
                    acc[:, 2 * b + h] = mma(acc[:, 2 * b + h], a, dig[p][ks])
    assert (wrap32(acc) == acc).all()
    return acc


def emulate_gram_aat(words, V, mave, msig2, both):
    """gram_aat_kernel<both>'s outputs: the group sums f32[nJ/G, B, 4, Nb]
    and (a-only) W f32[B, Mpad], from the wrapper's operands."""
    nw, mpad = words.shape
    B = V.shape[2]
    nb, D = 4 * nw, 4 * B
    w = words.astype(np.int64)
    v8, vs = tmv._quant_digits_t(torch.from_numpy(V))
    vflat = v8.reshape(4, 4, B, nb).transpose(1, 2).contiguous().numpy() \
        .view(np.uint8).ravel()
    vsc = tmv._digit_scales(vs).numpy()
    sv = torch.from_numpy(V).sum(dim=(0, 1)).numpy()
    nj = mpad // S
    zpart = np.full((-(-nj // GROUP), B, 4, nb), np.nan, F32)
    wout = np.full((B, mpad), np.nan, F32)
    steps = -(-nw // 8)
    for jg in range(zpart.shape[0]):
        cache = np.full(nw * S, -1, np.int64)
        for j in range(jg * GROUP, min(nj, jg * GROUP + GROUP)):
            m0 = j * S
            for dg in range(-(-B // 2)):
                rows = np.minimum(8 * dg + G, D - 1)
                tsum = tx_side(w, cache, m0, vflat, rows, D, nw, dg == 0,
                               both)
                # 2. warp c: column 2dg + c, markers lane and lane + 32
                dig8 = np.zeros((2, 8, S), np.int8)
                scs = np.zeros((2, 4), F32)
                for c in range(2):
                    b = 2 * dg + c
                    bc = min(b, B - 1)
                    s = vsc[:, bc]
                    mm = np.stack([LANE, LANE + 32])         # [e, 32]
                    m = m0 + mm
                    at = tile_at(4 * c + np.arange(4)[:, None, None], mm)
                    av = fold4(tsum[0][at], s[:, None, None])
                    if both:
                        bv = fold4(tsum[1][at], s[:, None, None])
                        wv = msig2[m] * (av - mave[m] * bv)
                        uv = (-mave[m]) * wv
                    else:
                        wv = msig2[m] * (av - sv[bc] * mave[m])
                        uv = np.zeros_like(wv)
                        if b < B:
                            wout[b, m] = wv
                    mx = np.maximum(np.abs(wv), np.abs(uv)).max()
                    sc = [(F32(1) if mx == 0 else mx) / F32(127)]
                    for _ in range(3):
                        sc.append(sc[-1] / F32(127))
                    scs[c] = sc
                    r, ru = wv, uv
                    for d in range(4):
                        dw = np.rint(r / sc[d])
                        dig8[0, 4 * c + d, mm] = dw.astype(np.int8)
                        r = r - dw * sc[d]
                        du = np.rint(ru / sc[d])
                        dig8[1, 4 * c + d, mm] = du.astype(np.int8)
                        ru = ru - du * sc[d]
                # 3. forward side, then the exchange and the fold
                acc = fw_ints(cache, dig8[:1 + both], nw, both)
                s = scs[T >> 1].T                            # [4, 32]
                b = 2 * dg + (T >> 1)
                for bb in range(4):
                    for h in range(2):
                        a = acc[:, 2 * bb + h] >> SCALE_SHIFT  # [grp, 32, 4]
                        send = np.where(ODD[:, None], a[..., 0:2], a[..., 2:4])
                        recv = send[:, LANE ^ 1]
                        own = np.where(ODD[:, None], a[..., 2:4], a[..., 0:2])
                        td = np.where(ODD[:, None],
                                      np.concatenate([recv, own], -1),
                                      np.concatenate([own, recv], -1))
                        z = fold4(np.moveaxis(td, -1, 0), s[:, None, :])
                        for grp in range(steps):
                            i = 8 * grp + G
                            ok = (i < nw) & (b < B)
                            k = 2 * h + (T & 1)
                            idx = (jg, b[ok], k[ok], 4 * i[ok] + bb)
                            zpart[idx] = (z[grp, ok] if j == jg * GROUP
                                          else zpart[idx] + z[grp, ok])
    return zpart, wout


def emulated(words, V, mave, msig2, both):
    """The wrapper's result around the emulated kernel."""
    zpart, wout = emulate_gram_aat(words, V, mave, msig2, both)
    z = tmv._gram_group_sum(torch.from_numpy(zpart))
    if both:
        return z
    W = torch.from_numpy(wout)
    return z - (W * torch.from_numpy(mave)[None, :]).sum(dim=1)[None, None, :]


# (Nw, Mpad, B, padding samples): Nw = 7 (one masked step, one warp), 40
# (five steps), 300 (38 steps, not a multiple of 8 or of the warps); Mpad
# of one stripe (64), a short last group (576: 8 + 1 stripes; 704: 8 + 3)
# and several groups (1,216: 8 + 8 + 3); B = 1 (half a digit group), 2, 3
# and 5 (two and three digit groups, the last half empty)
CASES = [(7, 64, 1, 3), (40, 704, 2, 0), (40, 576, 3, 5), (300, 1216, 5, 11)]


@pytest.mark.parametrize("nw,m,B,pad", CASES)
@pytest.mark.parametrize("both", [False, True])
def test_emulated_kernel_equals_plain_version(nw, m, B, pad, both):
    """gram_aat_kernel<both>, emulated, equals gram_aat_i8_ref (both planes,
    on words with missing calls) or gram_aat_i8a_ref (the a-plane, on
    complete words) bit for bit."""
    rng = np.random.default_rng(nw * 5 + m + B + pad + both)
    words = _gram_words(rng, nw, m, complete=not both, n_pad=pad)
    V, mave, msig2 = _gram_inputs(rng, nw, m, B)
    ref = tmv.gram_aat_i8_ref if both else tmv.gram_aat_i8a_ref
    t = torch.from_numpy
    want = ref(_t(words), t(V), t(mave), t(msig2))
    got = emulated(words, V, mave, msig2, both)
    assert got.shape == want.shape == (4, 4 * nw, B)
    assert torch.equal(got, want)


@pytest.mark.parametrize("both", [False, True])
def test_largest_sums_at_the_route_edge(both):
    """Nw = 822, every call a = 2 (code 00): with every digit of V 127 the
    transpose side's tile sums, and with every W (and -mave W) digit 127
    the forward side's sums, equal the plain integer products; no warp's
    64-fold sum leaves int32.  With V of equal entries (first digits 127)
    the emulated kernel equals the plain version there."""
    nw, m, B = tmv.GRAM_AAT_MAX_NW, S, 2
    words = np.zeros((nw, m), np.int64)
    v8 = np.full((4, 4 * B, 4 * nw), 127, np.int8)
    cache = np.full(nw * S, -1, np.int64)
    rows = np.minimum(G, 4 * B - 1)
    tsum = tx_side(words, cache, 0, v8.view(np.uint8).ravel(), rows, 4 * B,
                   nw, True, both)
    d8 = torch.from_numpy(v8)
    wt = _t(words.astype(np.uint32))
    want = (tmv.atxm_i8_int_ref(wt, d8) if both
            else (tmv.atxm_i8a_int_ref(wt, d8),))
    n, mm = np.meshgrid(np.arange(8), np.arange(S), indexing="ij")
    for p, wp in enumerate(want):
        np.testing.assert_array_equal(tsum[p][tile_at(n, mm)],
                                      wp.numpy()[:8])
    assert int(want[0].max()) == 2 * 127 * 16 * nw
    dig8 = np.full((1 + both, 8, S), 127, np.int8)
    acc = fw_ints(cache, dig8, nw, both)
    w8 = torch.full((8, m), 127, dtype=torch.int8)
    za = tmv.axm_i8a_int_ref(wt, w8)
    zb = tmv.axm_i8_int_ref(wt, w8, w8)[1] if both else 0 * za
    z = (za + zb).numpy()                                    # [8, 4, Nb]
    # acc[grp, 2b + h, lane, 2*half + c]: planar row (2h + half, 4i + b),
    # digit row 2t + c, i = 8 grp + g
    grp, j, lane, slot = np.meshgrid(np.arange(acc.shape[0]), np.arange(8),
                                     LANE, np.arange(4), indexing="ij")
    i = 8 * grp + lane // 4
    ok = i < nw
    k = 2 * (j % 2) + slot // 2
    d = 2 * (lane % 4) + slot % 2
    np.testing.assert_array_equal(
        acc[ok] >> SCALE_SHIFT, z[d[ok], k[ok], 4 * i[ok] + j[ok] // 2])
    rng = np.random.default_rng(822)
    V = np.ones((4, 4 * nw, B), np.float32)
    mave = rng.uniform(0, 2, m).astype(np.float32)
    msig2 = rng.uniform(0.5, 2, m).astype(np.float32)
    ref = tmv.gram_aat_i8_ref if both else tmv.gram_aat_i8a_ref
    t = torch.from_numpy
    assert torch.equal(emulated(words.astype(np.uint32), V, mave, msig2, both),
                       ref(wt, t(V), t(mave), t(msig2)))


def test_cache_swizzle_is_conflict_free_on_both_sides():
    """Every 16-byte access of the cache maps each row's chunks one to one,
    and each quarter warp (8 lanes) of either side touches 8 distinct
    positions mod 8 (the 32 banks): the transpose side's chunks 8l+g of rows
    8s+t and 8s+t+4, the forward side's chunks 8ks+4u+t of rows 8s+g."""
    for r in range(8):
        assert sorted(q ^ swz(r) for q in range(S // 4)) == list(range(S // 4))
    for p in range(4):
        lanes = LANE[8 * p:8 * p + 8]
        g, t = lanes // 4, lanes % 4
        for s in range(3):
            for l in range(TX_LOADS):
                for off in (0, 4):
                    pos = chunk(8 * s + t + off, 8 * l + g)[:, 0] // 4 % 8
                    assert len(set(pos)) == 8
            for ks in range(2):
                for u in range(2):
                    pos = chunk(8 * s + g, 8 * ks + 4 * u + t)[:, 0] // 4 % 8
                    assert len(set(pos)) == 8


# a short last group (11 stripes: 8 + 3) at Nw = 7 and 40, with padding
@pytest.mark.parametrize("nw,m,B,pad", [(7, 704, 1, 2), (40, 704, 3, 9)])
@pytest.mark.parametrize("general", [False, True])
def test_plain_versions_match_pallas_at_a_short_group(nw, m, B, pad, general):
    """gram_aat_i8[a]_ref, whose group sums end in a short last group,
    against gram_aat_i8[a]_pallas(tm=S) in interpret mode within GRAM_TOL."""
    rng = np.random.default_rng(nw * 3 + m + B + pad)
    words = _gram_words(rng, nw, m, complete=not general, n_pad=pad)
    V, mave, msig2 = _gram_inputs(rng, nw, m, B)
    t = torch.from_numpy
    ours = tmv.gram_aat_i8 if general else tmv.gram_aat_i8a
    theirs = jmv.gram_aat_i8_pallas if general else jmv.gram_aat_i8a_pallas
    got = ours(_t(words), t(V), t(mave), t(msig2))
    want = theirs(jnp.asarray(words), jnp.asarray(V), jnp.asarray(mave),
                  jnp.asarray(msig2), tm=S)
    _close(got, want, GRAM_TOL)


def test_chip_smoke_ptxas_entries_name_the_dual_grams(monkeypatch):
    """chip_smoke's no-spill check reads each dual Gram's own instantiation
    of gram_aat_kernel<kBoth> in csrc/gram_aat.cu, and its kernels line
    names that source for both."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(repo)
    smoke = importlib.import_module("chip_smoke")
    ns = "_ZN45_GLOBAL__N__0c1d2e3f_11_gram_aat_cu_4a5b6c7d"

    def mangled(both):
        return (f"{ns}15gram_aat_kernelILb{int(both)}EEEvPKjPKhPKfS7_S7_S7_"
                f"PfS8_lll")

    own = {"gram_aat_i8a": mangled(False), "gram_aat_i8": mangled(True)}
    others = ["_ZN12_GLOBAL__N_116gram_prim_kernelILb0EEEvPKjPKiS3_PKfS5_S5_"
              "PiPfS6_S6_llll"]
    for key, name in own.items():
        hits = [n for n in [*own.values(), *others]
                if re.search(smoke.PTXAS_ENTRY[key], n)]
        assert hits == [name], key
    assert smoke.GRAM_AAT_SOURCE == "gvamp_tpu_torch/csrc/gram_aat.cu"
    assert os.path.isfile(os.path.join(repo, smoke.GRAM_AAT_SOURCE))
