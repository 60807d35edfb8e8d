"""The two-plane table kernel of atx (gvamp_tpu_torch/csrc/matvec.cu,
atx_kernel<true>), checked on the CPU, where the kernel cannot run.

atx is the two-plane instance of atx_a's template: the a-side is atx_a's
pair tables (emulated by tests/test_torch_atx_a.py, whose helpers this file
reuses), and the b-side adds per word row the tables
Tb[b][c] = (c0 v[0][4i+b] + c1 v[1][4i+b]) + (c2 v[2][4i+b] + c3 v[3][4i+b])
over the 16 values c of the non-missing bits of person 4i+b's four codes.
The emulator below follows the source: the bits gathered from
swar_b_fields(w) into the index times 4 by two shifts and masks, the 4
lookups per word in the fixed f32 tree (Tb0 + Tb1) + (Tb2 + Tb3), the double
sum of the word rows per marker, one f32 partial row per band of atx_a's
band layout and the wrapper's sum of the partials.  It must equal the plain
version atx_ref bit for bit on dyadic v, count the non-missing calls
exactly on v = 1, and stay within the kernel check's 5e-7 of float64 on
Gaussian v; the port's atx must match atx_pallas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.tools.kernel_check import TOL
from helpers import CODE_B
from test_torch_atx_a import (_dyadic, emulate_atx_a, pair_tables,
                              rows_per_band, word_sums)
from test_torch_matvec import FOLD_TOL, _close, _t, _words

M5 = 0x55555555
INDEX_MASK = 0x3C3C3C3C


def b_index4(words):
    """4 x the index of each byte's non-missing bits, in the byte: the
    kernel's atx_b_word decode."""
    w = words.astype(np.int64)
    x = (~w | (w >> 1)) & M5          # swar_b_fields: c_k at bit 2k
    x = (x | (x >> 1)) & 0x33333333   # c_0, c_1 at bits 0, 1; c_2, c_3 at 4, 5
    return ((x << 2) | x) & INDEX_MASK


def b_tables(v):
    """f32[4, 4*Nw] -> Tb f32[Nw, 4, 16]: entry (i, b, c) sums v[k][4i+b]
    over the set bits k of c as (c0 v0 + c1 v1) + (c2 v2 + c3 v3) in f32."""
    nw = v.shape[1] // 4
    vv = v.astype(np.float32).reshape(4, nw, 4)                    # [k, i, b]
    c = np.arange(16)
    bit = [((c >> k) & 1).astype(bool) for k in range(4)]
    term = [np.where(bit[k], vv[k][..., None], np.float32(0))
            for k in range(4)]                                      # [i, b, c]
    return (term[0] + term[1]) + (term[2] + term[3])


def b_word_sums(words, tables):
    """The f32 b-side product of every word: the 4 bytes' entries of its
    row's tables, (Tb0 + Tb1) + (Tb2 + Tb3)."""
    x = b_index4(words)
    rows = np.arange(words.shape[0])[:, None]
    t = [tables[rows, b, ((x >> (8 * b)) & 0xFF) // 4] for b in range(4)]
    return (t[0] + t[1]) + (t[2] + t[3])                           # f32


def emulate_atx(words, v):
    """atx_kernel<true> and its wrapper: each side's word sums added in
    double per marker over each row band of the kernel's layout, rounded to
    an f32 partial row per band, the partials summed as the wrapper sums
    them."""
    nw, mpad = words.shape
    band = rows_per_band(nw, mpad)
    bv_words = b_word_sums(words, b_tables(v)).astype(np.float64)
    parts = np.stack([bv_words[lo:lo + band].sum(axis=0)
                      for lo in range(0, nw, band)]).astype(np.float32)
    return emulate_atx_a(words, v), torch.from_numpy(parts).sum(dim=0)


def test_b_index_decodes_every_byte():
    """Every byte value at every byte position: the gathered index is
    sum_k {1, 0, 1, 1}[code_k] 2^k, and the word's b-side lookup equals its
    plain b-side product (exact on dyadic v); the a-side lookups of the
    same words are atx_a's."""
    x = np.arange(256, dtype=np.uint32)
    words = np.stack([x << (8 * b) for b in range(4)]
                     + [x * 0x01010101]).astype(np.uint32)        # [5, 256]
    got = b_index4(words)
    codes = (words[..., None].astype(np.int64)
             >> (2 * np.arange(16))) & 3                           # [i, m, 16]
    nm = CODE_B[codes].reshape(*words.shape, 4, 4)                 # [.., b, k]
    want = (nm * (1 << np.arange(4))).sum(-1).astype(np.int64)     # [i, m, b]
    for b in range(4):
        np.testing.assert_array_equal((got >> (8 * b)) & 0xFF,
                                      4 * want[..., b])
    v = _dyadic(np.random.default_rng(1), words.shape[0])
    a, bp = tmv.decode_planar_dense(_t(words), torch.float64)
    per_person = [np.einsum("kpm,kp->pm", s.numpy(), v.astype(np.float64))
                  .reshape(-1, 4, 256).sum(1) for s in (a, bp)]
    np.testing.assert_array_equal(word_sums(words, pair_tables(v)),
                                  per_person[0])
    np.testing.assert_array_equal(b_word_sums(words, b_tables(v)),
                                  per_person[1])


# (Nw, Mpad): one partial tile (7), bands of whole tiles with a short last
# one (300 word rows over 10 bands of 32), Mpad below a block and not a
# multiple of one (1,000, 2,052)
@pytest.mark.parametrize("nw,m", [(7, 8), (300, 1000), (100, 2052)])
def test_emulation_equals_plain_version_on_dyadic_v(nw, m):
    """Dyadic v (multiples of 1/8 in [0, 1]): every table entry, word sum,
    double row sum and f32 partial is exact on both sides, so the emulated
    kernel equals atx_ref bit for bit."""
    rng = np.random.default_rng(nw * 37 + m)
    words = _words(rng, nw, m)
    v = _dyadic(rng, nw)
    av, bv = emulate_atx(words, v)
    want = tmv.atx_ref(_t(words), torch.from_numpy(v))
    assert torch.equal(av, want[0]) and torch.equal(bv, want[1])


def test_bv_counts_the_non_missing_calls():
    """v = 1 on the real samples (the completeness check's vector): every
    b-table entry is a count of set bits, so the emulated bv is each
    marker's count of non-missing real calls, exactly."""
    rng = np.random.default_rng(5)
    nw, m, n_real = 300, 1000, 4 * 300 * 4 - 37
    words = _words(rng, nw, m)
    v = np.zeros(16 * nw, np.float32)
    v[:n_real] = 1
    v = v.reshape(nw, 4, 4).transpose(2, 0, 1).reshape(4, 4 * nw)  # planar
    codes = (words[..., None].astype(np.int64) >> (2 * np.arange(16))) & 3
    nm = CODE_B[codes].reshape(nw, m, 4, 4)                        # [i, m, b, k]
    real = v.reshape(4, nw, 4).transpose(1, 2, 0)                  # [i, b, k]
    count = np.einsum("imbk,ibk->m", nm, real)
    bv = emulate_atx(words, v)[1]
    np.testing.assert_array_equal(bv.numpy(), count.astype(np.float32))
    assert torch.equal(bv, tmv.atx(_t(words), torch.from_numpy(v))[1])


def test_emulation_within_kernel_check_tol_of_float64():
    """Gaussian v: both sides of the emulated kernel stay within the kernel
    check's TOL (5e-7 of the largest entry) of float64, over bands of up to
    32 tiles of 32 word rows (Nw = 1,024 at Mpad = 64: one band)."""
    for nw, m in ((300, 1000), (1024, 64)):
        rng = np.random.default_rng(nw + 3 * m)
        words = _words(rng, nw, m)
        v = rng.standard_normal((4, 4 * nw)).astype(np.float32)
        want = tmv.atx_ref(_t(words), torch.from_numpy(v), torch.float64)
        for got, w in zip(emulate_atx(words, v), want):
            rel = float((got.double() - w).abs().max() / w.abs().max())
            assert rel <= TOL, (nw, m, rel)


def test_atx_matches_pallas_at_more_shapes():
    """The port's atx (its plain version on the CPU) against atx_pallas at
    shapes beyond test_atx_matches_pallas's: equal on dyadic v, within
    FOLD_TOL on Gaussian v; the emulated kernel too."""
    rng = np.random.default_rng(41)
    nw, m = 300, 1000
    words = _words(rng, nw, m)
    jw = jnp.asarray(words)
    vd = _dyadic(rng, nw)
    jax_d = [np.asarray(x) for x in jmv.atx_pallas(jw, vd)]
    for got in (tmv.atx(_t(words), torch.from_numpy(vd)),
                emulate_atx(words, vd)):
        for g, j in zip(got, jax_d):
            np.testing.assert_array_equal(g.numpy(), j)
    vg = rng.standard_normal((4, 4 * nw)).astype(np.float32)
    jax_g = jmv.atx_pallas(jw, vg)
    for got in (tmv.atx(_t(words), torch.from_numpy(vg)),
                emulate_atx(words, vg)):
        for g, j in zip(got, jax_g):
            _close(g, j, FOLD_TOL)
