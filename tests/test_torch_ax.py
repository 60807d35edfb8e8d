"""The marker-pair table kernel of ax (gvamp_tpu_torch/csrc/matvec.cu,
ax_kernel), checked on the CPU, where the kernel cannot run.

A numpy emulator follows the kernel as the source writes it: per marker
t_m[code] = {2w - u, 0, w - u, -u}[code] (one f32 rounding), per marker
pair the table T[c] = t_m[c & 3] + t_{m+1}[c >> 2] over the 16 nibbles c,
the nibbles of a pair's two words gathered by masks and shifts, the
blocks' 16 word rows and marker bands, the steps of 32 markers that a
block's 8 warps take in turn, the two lanes of a row (16-byte pieces 2q + h
of a step, so lane h holds the pairs 4q + 2h and 4q + 2h + 1), the fixed f32
tree of a lane's 8 lookups per step and output, the double running sums,
the sum of a row's lanes in (warp, h) order, one f32 partial row per band
and the wrapper's sum of the partials.  It must equal the plain version
ax_ref bit for bit on dyadic inputs, stay within the kernel check's 5e-7 of
float64 on Gaussian inputs and within chip_smoke.py's AX_REAL_TOL of the
plain version on the people statistics' inputs; the port's ax must match
ax_pallas."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.tools.kernel_check import TOL
from helpers import CODE_A, CODE_B
from test_torch_matvec import FOLD_TOL, _t, _words

# the kernel's constants (matvec.cu)
WARPS = 8
ROWS = 16                  # kAxRows: word rows per block, two lanes each
STEP = 32                  # kAxStep: markers per step of a row
RESIDENT = 132 * 2         # kAxResident
MIN_BAND = 4096            # kAxMinBand
MISSING_WORD = 0x55555555  # 16 codes 01
# chip_smoke.py's limit for ax on the statistics' inputs, relative to the
# largest sum of |terms|
AX_REAL_TOL = 1e-6


def markers_per_band(nw, mpad):
    """ax_markers_per_band: one wave of two blocks per SM where the rows
    leave room, bands no shorter than MIN_BAND markers, whole steps."""
    bands = max(min(RESIDENT // -(-nw // ROWS), mpad // MIN_BAND), 1)
    return -(-(-(-mpad // bands)) // STEP) * STEP


def nibbles(a, c):
    """The 4 nibble indices (code_m + 4 code_{m+1}) of planes 0-3 in each
    byte, from the words a (marker m) and c (marker m + 1): [4, ...]."""
    a, c = a.astype(np.int64), c.astype(np.int64)
    g0 = (a & 0x33333333) | ((c << 2) & 0xCCCCCCCC)   # planes 0 (low), 2
    g1 = ((a >> 2) & 0x33333333) | (c & 0xCCCCCCCC)   # planes 1 (low), 3
    idx = [(g0 << 2) & 0x3C3C3C3C, (g1 << 2) & 0x3C3C3C3C,
           (g0 >> 2) & 0x3C3C3C3C, (g1 >> 2) & 0x3C3C3C3C]
    return np.stack([np.stack([((x >> (8 * b)) & 0xFF) >> 2
                               for b in range(4)]) for x in idx])  # [k, b, ..]


def pair_tables(w, u):
    """f32[M] x 2 -> T f32[M/2, 16]: t_m = {2w - u, 0, w - u, -u} and
    T[c] = t_m[c & 3] + t_{m+1}[c >> 2], each one f32 rounding."""
    w, u = w.astype(np.float32), u.astype(np.float32)
    t = np.stack([2 * w - u, np.zeros_like(w), w - u, -u], axis=1)  # [M, 4]
    c = np.arange(16)
    return t[0::2][:, c & 3] + t[1::2][:, c >> 2]


def tree8(f):
    """((f0 + f1) + (f2 + f3)) + ((f4 + f5) + (f6 + f7)) over axis 0, f32."""
    return (((f[0] + f[1]) + (f[2] + f[3]))
            + ((f[4] + f[5]) + (f[6] + f[7])))


def emulate_ax(words, w, u, band=None):
    """ax_kernel and its wrapper on words uint32[Nw, Mpad] and w, u f32[Mpad]
    (``band`` markers per band, default the kernel's)."""
    nw, mpad = words.shape
    band = band or markers_per_band(nw, mpad)
    steps = -(-mpad // STEP)
    pad = steps * STEP - mpad
    wp = np.pad(words, ((0, 0), (0, pad)), constant_values=MISSING_WORD)
    tab = pair_tables(np.pad(w, (0, pad)), np.pad(u, (0, pad)))    # [P, 16]
    idx = nibbles(wp[:, 0::2], wp[:, 1::2])                        # [k, b, i, P]
    look = tab[np.arange(tab.shape[0]), idx]                       # [k, b, i, P]
    # pair 16 s + 4 q + 2 h + e of step s is lane h's lane-local pair 2q + e
    look = look.reshape(4, 4, nw, steps, 4, 2, 2)                  # .., s, q, h, e
    f = look.transpose(5, 4, 6, 0, 1, 2, 3).reshape(2, 8, 4, 4, nw, steps)
    t = tree8(np.moveaxis(f, 1, 0)).astype(np.float64)             # [h, k, b, i, s]
    parts = []
    for lo in range(0, steps, band // STEP):
        acc = np.zeros((WARPS,) + t.shape[:-1])                    # [w, h, k, b, i]
        for s in range(lo, min(lo + band // STEP, steps)):         # in turn
            acc[(s - lo) % WARPS] += t[..., s]
        total = np.zeros(t.shape[1:-1])
        for g in range(WARPS):
            total += acc[g, 0] + acc[g, 1]
        parts.append(total.reshape(4, 4, nw).transpose(0, 2, 1)
                     .reshape(4, 4 * nw).astype(np.float32))
    return torch.from_numpy(np.stack(parts)).sum(dim=0)


def test_pair_nibbles_and_tables_cover_every_code_pair():
    """Every pair of codes (code_m, code_{m+1}) in every plane k and byte b,
    among random codes elsewhere: the gathered nibble is code_m + 4
    code_{m+1}, and the pair's table entry there is a w - b u summed over
    the two markers (exact on dyadic w, u)."""
    rng = np.random.default_rng(0)
    cm, cn = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
    cm, cn = cm.ravel(), cn.ravel()                                # 16 pairs
    a = _words(rng, 16, 16)
    c = _words(rng, 16, 16)
    for f in range(16):                                            # field 4b + k
        mask = np.uint32(~(3 << (2 * f)) & 0xFFFFFFFF)
        a[f] = (a[f] & mask) | (cm << (2 * f)).astype(np.uint32)
        c[f] = (c[f] & mask) | (cn << (2 * f)).astype(np.uint32)
    got = nibbles(a, c)                                            # [k, b, 16, 16]
    for f in range(16):
        b, k = divmod(f, 4)
        np.testing.assert_array_equal(got[k, b, f], cm + 4 * cn)
    w = (rng.integers(0, 9, 32) / 8).astype(np.float32)
    u = (rng.integers(0, 9, 32) / 8).astype(np.float32)
    tab = pair_tables(w, u)
    want = (CODE_A[cm] * w[0::2, None] - CODE_B[cm] * u[0::2, None]
            + CODE_A[cn] * w[1::2, None] - CODE_B[cn] * u[1::2, None])
    np.testing.assert_array_equal(tab[:, cm + 4 * cn], want)


def test_band_sizing():
    """Config X (Nw = 320, Mpad = 524,288): 20 row blocks, 13 bands of
    40,352 markers (260 blocks, one wave of two per SM on 132 SMs), partial
    rows 0.04% of the words' bytes; config B's rows (1,280 blocks) take
    one band; narrow matrices no band shorter than MIN_BAND markers."""
    assert markers_per_band(320, 524_288) == 40_352
    assert -(-524_288 // 40_352) == 13
    assert 16 * 13 / 524_288 < 1e-3
    assert markers_per_band(20_480, 131_072) == 131_072
    for nw, m in ((7, 8), (16, 12_324), (32, 1 << 20), (320, 524_288)):
        band = markers_per_band(nw, m)
        parts = -(-m // band)
        assert band % STEP == 0 and band >= min(m, MIN_BAND)
        assert -(-nw // ROWS) * parts <= max(RESIDENT, -(-nw // ROWS))
        assert 16 * parts / m <= max(16 / MIN_BAND, 16 / m)


def _dyadic(rng, n):
    return (rng.integers(0, 9, n) / 8).astype(np.float32)


# (Nw, Mpad): a part-filled block of rows and a step past Mpad (7 x 8),
# Nw not a multiple of 16 with a part-filled last step (300 x 1,000), three
# bands, the last short, with a part-filled step (40 x 12,324)
@pytest.mark.parametrize("nw,m", [(7, 8), (300, 1000), (40, 12_324)])
def test_emulation_equals_plain_version_on_dyadic_inputs(nw, m):
    """Dyadic w and u (multiples of 1/8 in [0, 1]): every table entry,
    tree, double sum and f32 partial is exact, so the emulated kernel
    equals ax_ref bit for bit."""
    rng = np.random.default_rng(nw * 13 + m)
    words = _words(rng, nw, m)
    w, u = _dyadic(rng, m), _dyadic(rng, m)
    got = emulate_ax(words, w, u)
    assert torch.equal(got, tmv.ax_ref(_t(words), torch.from_numpy(w),
                                       torch.from_numpy(u)))


def test_emulation_within_tolerance():
    """Gaussian w and u: within the kernel check's TOL (5e-7 of the largest
    entry) of float64.  The people statistics' inputs (w = msig, u = mave
    msig, which cancel to a result far below the sum of |terms|): within
    AX_REAL_TOL of the sum of |terms| from the plain version.  Both with
    the kernel's bands and over one band of 16,384 markers (512 steps, 64
    per warp)."""
    rng = np.random.default_rng(7)
    nw, m = 48, 16_384
    words = _words(rng, nw, m)
    tw = _t(words)
    w = rng.standard_normal(m).astype(np.float32)
    u = rng.standard_normal(m).astype(np.float32)
    want = tmv.ax_ref(tw, torch.from_numpy(w), torch.from_numpy(u),
                      torch.float64)
    msig = rng.uniform(0.5, 2.0, m).astype(np.float32)
    mave = rng.uniform(0.0, 2.0, m).astype(np.float32)
    ws, us = msig, (mave * msig).astype(np.float32)
    want_s = tmv.ax_ref(tw, torch.from_numpy(ws), torch.from_numpy(us))
    terms = tmv.ax_ref(tw, torch.from_numpy(ws), -torch.from_numpy(us),
                       torch.float64)
    for band in (None, m):
        got = emulate_ax(words, w, u, band).double()
        assert float((got - want).abs().max() / want.abs().max()) <= TOL
        got = emulate_ax(words, ws, us, band)
        err = float((got - want_s).abs().max() / terms.abs().max())
        assert err <= AX_REAL_TOL, err


def test_ax_matches_pallas_at_more_shapes():
    """The port's ax (its plain version on the CPU) against ax_pallas at a
    shape beyond test_ax_matches_pallas's: equal on dyadic inputs, the
    emulated kernel too, and on the non-missing count (w = 0, u = -1);
    the emulated kernel within FOLD_TOL of the sum of |terms| on Gaussian
    inputs."""
    rng = np.random.default_rng(17)
    nw, m = 96, 1536
    words = _words(rng, nw, m)
    jw = jnp.asarray(words)
    w, u = _dyadic(rng, m), _dyadic(rng, m)
    want = np.asarray(jmv.ax_pallas(jw, jnp.asarray(w), jnp.asarray(u)))
    got = tmv.ax(_t(words), torch.from_numpy(w), torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(emulate_ax(words, w, u).numpy(), want)
    zero, mone = np.zeros(m, np.float32), -np.ones(m, np.float32)
    count = np.asarray(jmv.ax_pallas(jw, jnp.asarray(zero),
                                     jnp.asarray(mone)))
    np.testing.assert_array_equal(emulate_ax(words, zero, mone).numpy(),
                                  count)
    mg = rng.standard_normal(m).astype(np.float32)
    ug = (mg * 0.01).astype(np.float32)
    jax_g = np.asarray(jmv.ax_pallas(jw, jnp.asarray(mg), jnp.asarray(ug)))
    terms = tmv.ax_ref(_t(words), torch.from_numpy(mg), -torch.from_numpy(ug),
                       torch.float64)
    np.testing.assert_allclose(emulate_ax(words, mg, ug).numpy(), jax_g,
                               rtol=0,
                               atol=FOLD_TOL * float(terms.abs().max()))
