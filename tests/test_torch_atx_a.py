"""The pair-table kernel of atx_a (gvamp_tpu_torch/csrc/matvec.cu), checked on
the CPU, where the kernel cannot run.

A numpy emulator follows the kernel as the source writes it: for every
word row the block's pair table T[2b + h][c] = dose(c & 3) v[2h][4i+b] +
dose(c >> 2) v[2h+1][4i+b] over the 16 nibbles c (one f32 rounding), the
lookup of each word's 8 nibbles through the bytes of (w << 2) & 0x3C3C3C3C
and (w >> 2) & 0x3C3C3C3C, the fixed f32 tree of the 8 entries, the double
sum of the word rows per marker, one f32 partial row per band of the
kernel's grid and the wrapper's sum of the partials.  It must equal the
plain version atx_a_ref bit for bit on dyadic v and stay within the kernel
check's 5e-7 of float64 on Gaussian v, also over row bands much longer
than 64 word rows; the port's atx_a must match atx_a_pallas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.tools.kernel_check import TOL
from test_torch_matvec import FOLD_TOL, _close, _t, _words

# the kernel's constants (matvec.cu)
THREADS = 256
ATX_ROWS = 32                # word rows per table tile, a band's unit
ATX_MARKERS = 4 * THREADS    # markers per block
TARGET_BLOCKS = 132 * 8 * 4  # kTargetBlocks
NIBBLE_MASK = 0x3C3C3C3C
DOSE = np.array([2, 0, 1, 0], np.float32)  # {2, 0, 1, 0}[code]


def rows_per_band(nw, mpad):
    """atx_a_rows_per_band: band_length(Nw, blocks along M, ATX_ROWS)."""
    other = -(-mpad // ATX_MARKERS)
    bands = min(max(-(-TARGET_BLOCKS // other), 1), -(-nw // ATX_ROWS))
    return -(-(-(-nw // bands)) // ATX_ROWS) * ATX_ROWS


def pair_tables(v):
    """f32[4, 4*Nw] -> the tables T f32[Nw, 8, 16]: entry (i, 2b + h, c)
    is dose(c & 3) v[2h][4i+b] + dose(c >> 2) v[2h+1][4i+b], the two exact
    products added in f32."""
    nw = v.shape[1] // 4
    vv = v.astype(np.float32).reshape(4, nw, 4)                    # [k, i, b]
    c = np.arange(16)
    d0, d1 = DOSE[c & 3], DOSE[c >> 2]
    t = np.empty((nw, 4, 2, 16), np.float32)
    for h in range(2):
        t[:, :, h] = (d0 * vv[2 * h][..., None]
                      + d1 * vv[2 * h + 1][..., None])
    return t.reshape(nw, 8, 16)


def word_sums(words, tables):
    """The f32 a-side product of every word against its row's tables:
    nibble h of byte b (times 4) is byte b of (w << 2) & NIBBLE_MASK (h =
    0) or (w >> 2) & NIBBLE_MASK (h = 1); the 8 entries add as ((T00 + T01)
    + (T10 + T11)) + ((T20 + T21) + (T30 + T31))."""
    w = words.astype(np.int64)
    lo = (w << 2) & NIBBLE_MASK
    hi = (w >> 2) & NIBBLE_MASK
    rows = np.arange(w.shape[0])[:, None]
    t = []
    for b in range(4):
        i_lo = ((lo >> (8 * b)) & 0xFF) // 4
        i_hi = ((hi >> (8 * b)) & 0xFF) // 4
        t.append(tables[rows, 2 * b, i_lo] + tables[rows, 2 * b + 1, i_hi])
    return (t[0] + t[1]) + (t[2] + t[3])                          # f32


def emulate_atx_a(words, v, band=None):
    """atx_a_kernel and its wrapper: the word sums added in double per
    marker over each row band (``band`` word rows, default the kernel's
    rows_per_band), each band rounded to an f32 partial row, the partials
    summed as the wrapper sums them (one torch.sum over the band axis)."""
    nw, mpad = words.shape
    band = band or rows_per_band(nw, mpad)
    s = word_sums(words, pair_tables(v)).astype(np.float64)
    parts = np.stack([s[lo:lo + band].sum(axis=0)
                      for lo in range(0, nw, band)]).astype(np.float32)
    return torch.from_numpy(parts).sum(dim=0)


def _dyadic(rng, nw):
    return (rng.integers(0, 9, (4, 4 * nw)) / 8).astype(np.float32)


def test_pair_tables_decode_every_nibble():
    """Words whose byte b runs over all 256 values in every byte position:
    the lookup picks, for each byte, the two entries whose nibbles are the
    byte's, and each entry is the dose of its two codes times their planes'
    v; so every word's emulated sum equals its plain a-side product (exact
    on dyadic v)."""
    rng = np.random.default_rng(0)
    x = np.arange(256, dtype=np.uint32)
    words = np.stack([x << (8 * b) for b in range(4)]
                     + [x * 0x01010101]).astype(np.uint32)        # [5, 256]
    v = _dyadic(rng, words.shape[0])
    tables = pair_tables(v)
    for c in range(16):
        for j in range(8):
            b, h = divmod(j, 2)
            np.testing.assert_array_equal(
                tables[:, j, c],
                DOSE[c & 3] * v[2 * h, b::4] + DOSE[c >> 2] * v[2 * h + 1,
                                                               b::4])
    got = word_sums(words, tables)
    a = tmv.decode_planar_dense(_t(words), torch.float64)[0].numpy()
    per_person = np.einsum("kpm,kp->pm", a, v.astype(np.float64))
    np.testing.assert_array_equal(got, per_person.reshape(-1, 4, 256).sum(1))


def test_band_layout_takes_whole_tiles():
    """The kernel's row bands: whole tiles of ATX_ROWS rows, enough bands
    that the grid reaches TARGET_BLOCKS where the rows allow (config B:
    128 column blocks x 32 bands of 640 rows), one band where the matrix
    is narrow."""
    assert rows_per_band(20480, 131072) == 640
    assert rows_per_band(300, 1000) == ATX_ROWS
    for nw, m in ((7, 8), (300, 1000), (20480, 131072), (1000, 4 * 10**6)):
        band = rows_per_band(nw, m)
        assert band % ATX_ROWS == 0 and 0 < band <= -(-nw // 32) * 32


# (Nw, Mpad): one partial tile (7), tiles and bands with a short last one
# (Nw 300 and 100), Mpad below a block, not a multiple of one (1,000, 2,052) and
# one marker quad (4)
SHAPES = [(7, 8), (300, 1000), (100, 2052), (33, 4)]


@pytest.mark.parametrize("nw,m", SHAPES)
def test_emulation_equals_plain_version_on_dyadic_v(nw, m):
    """Dyadic v (multiples of 1/8 in [0, 1]): every table entry, word sum,
    double row sum and f32 partial is exact, so the emulated kernel equals
    atx_a_ref bit for bit."""
    rng = np.random.default_rng(nw * 29 + m)
    words = _words(rng, nw, m)
    v = _dyadic(rng, nw)
    want = tmv.atx_a_ref(_t(words), torch.from_numpy(v))
    assert torch.equal(emulate_atx_a(words, v), want)


@pytest.mark.parametrize("nw,m,band", [(300, 1000, None), (320, 64, 320),
                                       (1024, 32, 1024), (100, 2052, None)])
def test_emulation_within_kernel_check_tol_of_float64(nw, m, band):
    """Gaussian v: the emulated kernel, with the kernel's bands and with
    one band of 320 or 1,024 word rows (far beyond the 64 over which one
    f32 running sum already errs 7.6e-7), stays within the kernel check's
    TOL (5e-7 of the largest entry) of float64."""
    rng = np.random.default_rng(nw + m)
    words = _words(rng, nw, m)
    v = rng.standard_normal((4, 4 * nw)).astype(np.float32)
    want = tmv.atx_ref(_t(words), torch.from_numpy(v), torch.float64)[0]
    got = emulate_atx_a(words, v, band).double()
    assert band is None or band > 64
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= TOL, rel


@pytest.mark.parametrize("nw,m", [(300, 1000), (96, 1536)])
def test_atx_a_matches_pallas_at_more_shapes(nw, m):
    """The port's atx_a (its plain version on the CPU) against atx_a_pallas
    at shapes beyond test_atx_a_matches_pallas's: equal on dyadic v, within
    FOLD_TOL on Gaussian v; the emulated kernel too."""
    rng = np.random.default_rng(nw * 31 + m)
    words = _words(rng, nw, m)
    jw = jnp.asarray(words)
    vd = _dyadic(rng, nw)
    got = tmv.atx_a(_t(words), torch.from_numpy(vd))
    jax_d = np.asarray(jmv.atx_a_pallas(jw, vd))
    np.testing.assert_array_equal(got.numpy(), jax_d)
    np.testing.assert_array_equal(emulate_atx_a(words, vd).numpy(), jax_d)
    vg = rng.standard_normal((4, 4 * nw)).astype(np.float32)
    jax_g = jmv.atx_a_pallas(jw, vg)
    _close(tmv.atx_a(_t(words), torch.from_numpy(vg)), jax_g, FOLD_TOL)
    _close(emulate_atx_a(words, vg), jax_g, FOLD_TOL)
