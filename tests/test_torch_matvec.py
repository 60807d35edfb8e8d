"""The port's packed products (gvamp_tpu_torch/ops/matvec.py) against the
JAX package's: the Pallas kernels in interpret mode for f32, the XLA
functions for f64.  On the CPU every wrapper runs its plain version; the
CUDA kernels are held against those plain versions on the card by
chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from helpers import CODE_A, CODE_B

torch.set_num_threads(1)

# (Nw, Mpad, B): B=17 takes JAX's wide (D > 64) kernel, B=70 its column
# chunking; the port runs one kernel for every B
CASES = [(32, 512, 1), (64, 1024, 2), (32, 1024, 5), (64, 512, 17),
         (32, 512, 70)]

# Folded f32 outputs: both sides fold the same exact integer products with
# the same scales, in another summation order -> a few f32 ulps of the
# largest entry.
FOLD_TOL = 1e-6
# The fused dual Gram against gram_aat_i8[a]_pallas(tm=S): the same stripes
# and exact integer products, but the port sums the per-stripe f32 partials
# (and colsum(mave W)) with one torch.sum where JAX accumulates them stripe
# after stripe.  The a-only form subtracts colsum(mave W), as large as the
# largest entry, so the cancellation leaves several ulps on each side: at
# these cases each side is within 2.6e-6 of a float64 evaluation of the
# same formula, and they differ by up to 4.3e-6 of the largest entry.
GRAM_TOL = 1e-5
# The fused dual Gram against the two-pass composition axm(atxm(.)): W is
# quantised per stripe in one and over the whole column in the other, and
# both quantisations are ~127^-4 fine (the tolerance of
# tests/test_data_layer.py:435-464).
TWO_PASS_TOL = 5e-6


def _words(rng, nw, m):
    return rng.integers(0, 2**32, size=(nw, m), dtype=np.uint64).astype(np.uint32)


def _t(words_np):
    return torch.from_numpy(words_np.view(np.int32).copy())


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jax_axm_int(words, w8t):
    """JAX's forward digit products: the _axm_i8a_kernel body, interpret
    mode, at the tile sizes its wrapper picks."""
    nw, m = words.shape
    D = w8t.shape[0]
    tnw, tm = jmv._pick_tnw(nw, 256), jmv._pick_tm(m, 4096)
    vmem = pltpu.VMEM
    return pl.pallas_call(
        jmv._axm_i8a_kernel, grid=(nw // tnw, m // tm),
        in_specs=[pl.BlockSpec((tnw, tm), lambda i, j: (i, j), memory_space=vmem),
                  pl.BlockSpec((D, tm), lambda i, j: (0, j), memory_space=vmem)],
        out_specs=pl.BlockSpec((D, 4, 4 * tnw), lambda i, j: (0, 0, i),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((D, 4, 4 * nw), jnp.int32),
        interpret=True)(jnp.asarray(words), jnp.asarray(w8t))


def _jax_atxm_int(words, v8):
    """JAX's transpose digit products: the _atxm_i8a_kernel body."""
    nw, m = words.shape
    D = v8.shape[1]
    tnw, tm = jmv._pick_tnw(nw, 256), jmv._pick_tm(m, 512)
    vmem = pltpu.VMEM
    return pl.pallas_call(
        jmv._atxm_i8a_kernel, grid=(m // tm, nw // tnw),
        in_specs=[pl.BlockSpec((tnw, tm), lambda j, i: (i, j), memory_space=vmem),
                  pl.BlockSpec((4, D, 4 * tnw), lambda j, i: (0, 0, i),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((D, tm), lambda j, i: (0, j), memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((D, m), jnp.int32),
        interpret=True)(jnp.asarray(words), jnp.asarray(v8))


def _jax_axm_i8_int(words, w8t, u8t):
    """JAX's general forward digit products (za, zb): the _axm_i8_kernel
    body, interpret mode."""
    nw, m = words.shape
    D = w8t.shape[0]
    tnw, tm = jmv._pick_tnw(nw, 256), jmv._pick_tm(m, 2048)
    vmem = pltpu.VMEM
    dig = pl.BlockSpec((D, tm), lambda i, j: (0, j), memory_space=vmem)
    out = pl.BlockSpec((D, 4, 4 * tnw), lambda i, j: (0, 0, i),
                       memory_space=vmem)
    shape = jax.ShapeDtypeStruct((D, 4, 4 * nw), jnp.int32)
    return pl.pallas_call(
        jmv._axm_i8_kernel, grid=(nw // tnw, m // tm),
        in_specs=[pl.BlockSpec((tnw, tm), lambda i, j: (i, j), memory_space=vmem),
                  dig, dig],
        out_specs=[out, out], out_shape=[shape, shape],
        interpret=True)(jnp.asarray(words), jnp.asarray(w8t), jnp.asarray(u8t))


def _jax_atxm_i8_int(words, v8):
    """JAX's general transpose digit products (av, bv): the _atxm_i8_kernel
    body, interpret mode."""
    nw, m = words.shape
    D = v8.shape[1]
    tnw, tm = jmv._pick_tnw(nw, 256), jmv._pick_tm(m, 512)
    vmem = pltpu.VMEM
    out = pl.BlockSpec((D, tm), lambda j, i: (0, j), memory_space=vmem)
    shape = jax.ShapeDtypeStruct((D, m), jnp.int32)
    return pl.pallas_call(
        jmv._atxm_i8_kernel, grid=(m // tm, nw // tnw),
        in_specs=[pl.BlockSpec((tnw, tm), lambda j, i: (i, j), memory_space=vmem),
                  pl.BlockSpec((4, D, 4 * tnw), lambda j, i: (0, 0, i),
                               memory_space=vmem)],
        out_specs=[out, out], out_shape=[shape, shape],
        interpret=True)(jnp.asarray(words), jnp.asarray(v8))


def _gram_words(rng, nw, m, complete, n_pad):
    """Random words; ``complete`` remaps every missing code 01 to 11; the
    last ``n_pad`` samples of the layout are padding (code 01)."""
    from gvamp_tpu.ops.layout import PlanarLayout
    words = _words(rng, nw, m)
    if complete:
        lo = words & 0x55555555
        hi = (words >> 1) & 0x55555555
        words = (words | ((lo & ~hi) << 1)).astype(np.uint32)
    if n_pad:
        orig = PlanarLayout(N=16 * nw - n_pad, n_words=nw).planar_to_orig()
        by = words.view(np.uint8).reshape(nw, m, 4)
        for k, p in zip(*np.nonzero(orig < 0)):
            i, b = divmod(int(p), 4)
            by[i, :, b] = (by[i, :, b] & np.uint8(~(3 << (2 * k)) & 0xFF)) \
                | np.uint8(1 << (2 * k))
    return words


def _gram_inputs(rng, nw, m, B):
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    mave = rng.uniform(0, 2, m).astype(np.float32)
    msig2 = rng.uniform(0.5, 2, m).astype(np.float32)
    return V, mave, msig2


# (Nw, Mpad, B, padding samples): 8 to 32 stripes, odd B, N = 16 Nw - pad
GRAM_CASES = [(32, 512, 1, 0), (32, 1024, 3, 5), (64, 512, 2, 11),
              (32, 2048, 5, 0)]


@pytest.mark.parametrize("nw,m,B,pad", GRAM_CASES)
@pytest.mark.parametrize("general", [False, True])
def test_gram_aat_refs_match_pallas(nw, m, B, pad, general):
    """gram_aat_i8[a]_ref against gram_aat_i8[a]_pallas(tm=S) in interpret
    mode, which quantises W on the same stripes; the general kernel on
    words with missing codes, the a-only one on complete words."""
    rng = np.random.default_rng(nw * 13 + m + B + pad)
    words = _gram_words(rng, nw, m, complete=not general, n_pad=pad)
    V, mave, msig2 = _gram_inputs(rng, nw, m, B)
    t = torch.from_numpy
    if general:
        got = tmv.gram_aat_i8(_t(words), t(V), t(mave), t(msig2))
        want = jmv.gram_aat_i8_pallas(
            jnp.asarray(words), jnp.asarray(V), jnp.asarray(mave),
            jnp.asarray(msig2), tm=tmv.GRAM_AAT_STRIPE)
    else:
        got = tmv.gram_aat_i8a(_t(words), t(V), t(mave), t(msig2))
        want = jmv.gram_aat_i8a_pallas(
            jnp.asarray(words), jnp.asarray(V), jnp.asarray(mave),
            jnp.asarray(msig2), tm=tmv.GRAM_AAT_STRIPE)
    assert got.shape == (4, 4 * nw, B)
    _close(got, want, GRAM_TOL)


@pytest.mark.parametrize("nw,m,B,pad", GRAM_CASES[1:3])
def test_gram_aat_refs_match_two_pass(nw, m, B, pad):
    """The fused plain versions against the port's own two-pass forms:
    axm_i8(W, mave W) after atxm_i8 on missing codes, axm_i8a(W) -
    colsum(mave W) after atxm_i8a on complete words (tests/
    test_data_layer.py:435-464)."""
    rng = np.random.default_rng(nw + m + B + pad)
    V, mave, msig2 = (torch.from_numpy(x) for x in _gram_inputs(rng, nw, m, B))
    words = _t(_gram_words(rng, nw, m, complete=False, n_pad=pad))
    av, bv = tmv.atxm_i8(words, V)
    W = msig2[:, None] * (av - mave[:, None] * bv)
    _close(tmv.gram_aat_i8(words, V, mave, msig2),
           tmv.axm_i8(words, W, mave[:, None] * W), TWO_PASS_TOL)
    words = _t(_gram_words(rng, nw, m, complete=True, n_pad=pad))
    W = msig2[:, None] * (tmv.atxm_i8a(words, V)
                          - mave[:, None] * V.sum(dim=(0, 1))[None, :])
    want = tmv.axm_i8a(words, W) - (mave[:, None] * W).sum(dim=0)
    _close(tmv.gram_aat_i8a(words, V, mave, msig2), want, TWO_PASS_TOL)


def test_gram_aat_stripe_and_budget():
    """The stripe width, the stripe group and the shared-memory formula
    agree with the CUDA source (csrc/gram_aat.cu); the route admits Nw =
    822 word rows and not 823, and at 822 the kernel's shared memory fits
    the budget; the plain versions refuse a partial stripe, and
    gram_aat_fits says so."""
    import os
    src = open(os.path.join(os.path.dirname(tmv.__file__), os.pardir, "csrc",
                            "gram_aat.cu")).read()
    assert f"constexpr int kGramS = {tmv.GRAM_AAT_STRIPE};" in src
    assert f"constexpr int kGramGroup = {tmv.GRAM_AAT_GROUP};" in src
    assert ("return 4 * kGramS * nw + kScratchBytes;" in src
            and "constexpr int kTile = 8 * kGramS;" in src
            and "kScratchBytes = 4 * 2 * kTile + 2 * kTile + 4 * 2 * 4;"
            in src)
    assert tmv.gram_aat_smem_bytes(822) <= tmv.GRAM_AAT_SMEM_BUDGET
    assert tmv.gram_aat_fits(822, 512) and not tmv.gram_aat_fits(823, 512)
    assert not tmv.gram_aat_fits(32, 544)
    words = torch.zeros((32, 544), dtype=torch.int32)
    V = torch.zeros((4, 128, 1))
    with pytest.raises(ValueError, match="stripe"):
        tmv.gram_aat_i8a_ref(words, V, torch.zeros(544), torch.ones(544))


@pytest.mark.parametrize("nw,m", [(32, 512), (64, 1024)])
def test_ax_matches_pallas(nw, m):
    """f32 sum_m a w - b u against ax_pallas in interpret mode: the same
    products summed in another order, so they agree to a few ulps of the
    sum of |terms| (the people statistics' w = msig > 0 and u = mave msig
    cancel to a result far smaller than that sum).  The count numb (w = 0,
    u = -1) is an integer sum, exact on both sides."""
    rng = np.random.default_rng(nw * 3 + m)
    words = _words(rng, nw, m)
    msig = rng.uniform(0.5, 2.0, m).astype(np.float32)
    mave = rng.uniform(0.0, 2.0, m).astype(np.float32)
    w, u = msig, (mave * msig).astype(np.float32)
    got = tmv.ax(_t(words), torch.from_numpy(w), torch.from_numpy(u))
    want = jmv.ax_pallas(jnp.asarray(words), jnp.asarray(w), jnp.asarray(u))
    terms = tmv.ax_ref(_t(words), torch.from_numpy(w), -torch.from_numpy(u),
                       torch.float64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FOLD_TOL * float(terms.abs().max()))
    zero, mone = np.zeros(m, np.float32), -np.ones(m, np.float32)
    np.testing.assert_array_equal(
        tmv.ax(_t(words), torch.from_numpy(zero), torch.from_numpy(mone)),
        np.asarray(jmv.ax_pallas(jnp.asarray(words), jnp.asarray(zero),
                                 jnp.asarray(mone))))


def test_swar_decode_matches_code_tables():
    """Every byte value decodes to the reference LUT values, at the planar
    position (k, 4i+b) of its bit pair k in byte b of word row i."""
    words = np.arange(1024, dtype=np.uint32).astype(np.uint8).view(
        np.uint32).reshape(16, 16)
    a, b = tmv.decode_planar_dense(_t(words), torch.float64)
    by = words.view(np.uint8).reshape(16, 16, 4)        # [i, m, byte]
    for k in range(4):
        code = (by >> (2 * k)) & 3                      # [i, m, b]
        want_a = CODE_A[code].transpose(0, 2, 1).reshape(64, 16)
        want_b = CODE_B[code].transpose(0, 2, 1).reshape(64, 16)
        np.testing.assert_array_equal(a[k].numpy(), want_a)
        np.testing.assert_array_equal(b[k].numpy(), want_b)


def test_digits_equal_jax():
    """_quant_digits / _quant_digits_t give JAX's digits and scales bit for
    bit, in both orientations, including an all-zero column."""
    rng = np.random.default_rng(1)
    W = rng.standard_normal((512, 5)).astype(np.float32)
    W[:, 3] = 0.0
    for x, axis in ((W.T, 0), (W, 1)):
        d_t, s_t = tmv._quant_digits(torch.from_numpy(np.ascontiguousarray(x)), axis)
        d_j, s_j = jmv._quant_digits(jnp.asarray(x), axis)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    V = rng.standard_normal((4, 128, 3)).astype(np.float32)
    d_t, s_t = tmv._quant_digits_t(torch.from_numpy(V))
    d_j, s_j = jmv._quant_digits_t(jnp.asarray(V))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_folds_match_jax():
    rng = np.random.default_rng(2)
    B = 3
    s0 = rng.uniform(0.5, 2.0, B).astype(np.float32)
    zt = rng.integers(-2**20, 2**20, (tmv._NDIG * B, 4, 32)).astype(np.int32)
    _close(tmv._fold_digits_zt(torch.from_numpy(zt), torch.from_numpy(s0), B),
           jmv._fold_digits_zt(jnp.asarray(zt), jnp.asarray(s0), B), FOLD_TOL)
    za = rng.integers(-2**20, 2**20, (tmv._NDIG * B, 64)).astype(np.int32)
    _close(tmv._fold_digits_t(torch.from_numpy(za), torch.from_numpy(s0), B),
           jmv._fold_digits_t(jnp.asarray(za), jnp.asarray(s0), B), FOLD_TOL)
    zw = rng.integers(-2**20, 2**20, (4, 32, tmv._NDIG * B)).astype(np.int32)
    _close(tmv._fold_digits(torch.from_numpy(zw), torch.from_numpy(s0), B),
           jmv._fold_digits(jnp.asarray(zw), jnp.asarray(s0), B), FOLD_TOL)


@pytest.mark.parametrize("nw,m,B", CASES)
def test_axm_i8a_matches_pallas(nw, m, B):
    rng = np.random.default_rng(nw * 7 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    w8t, _ = tmv._quant_digits(torch.from_numpy(W).T, 0)
    j8t, _ = jmv._quant_digits(jnp.transpose(jnp.asarray(W)), 0)
    np.testing.assert_array_equal(w8t.numpy(), np.asarray(j8t))
    # the integer digit products are exact on both sides: equal
    np.testing.assert_array_equal(tmv.axm_i8a_int_ref(_t(words), w8t).numpy(),
                                  np.asarray(_jax_axm_int(words, j8t)))
    _close(tmv.axm_i8a(_t(words), torch.from_numpy(W)),
           jmv.axm_i8a_pallas(jnp.asarray(words), jnp.asarray(W)), FOLD_TOL)


@pytest.mark.parametrize("nw,m,B", CASES)
def test_atxm_i8a_matches_pallas(nw, m, B):
    rng = np.random.default_rng(nw * 5 + m + B)
    words = _words(rng, nw, m)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    v8, _ = tmv._quant_digits_t(torch.from_numpy(V))
    j8, _ = jmv._quant_digits_t(jnp.asarray(V))
    np.testing.assert_array_equal(v8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(tmv.atxm_i8a_int_ref(_t(words), v8).numpy(),
                                  np.asarray(_jax_atxm_int(words, j8)))
    _close(tmv.atxm_i8a(_t(words), torch.from_numpy(V)),
           jmv.atxm_i8a_pallas(jnp.asarray(words), jnp.asarray(V)), FOLD_TOL)


@pytest.mark.parametrize("nw,m,B", CASES)
def test_axm_i8_matches_pallas(nw, m, B):
    """A_a W - A_b U: both integer products equal JAX's kernel body exactly;
    the folded f32 within FOLD_TOL of axm_i8_pallas, which chunks B=70 into
    32-column calls where the port makes one (per-column quantisation)."""
    rng = np.random.default_rng(nw * 3 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 3).astype(np.float32)
    w8t, _ = tmv._quant_rows(torch.from_numpy(W))
    u8t, _ = tmv._quant_rows(torch.from_numpy(U))
    j8t, _ = jmv._quant_digits(jnp.transpose(jnp.asarray(W)), 0)
    k8t, _ = jmv._quant_digits(jnp.transpose(jnp.asarray(U)), 0)
    np.testing.assert_array_equal(u8t.numpy(), np.asarray(k8t))
    za, zb = tmv.axm_i8_int_ref(_t(words), w8t, u8t)
    ja, jb = _jax_axm_i8_int(words, j8t, k8t)
    np.testing.assert_array_equal(za.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(zb.numpy(), np.asarray(jb))
    _close(tmv.axm_i8(_t(words), torch.from_numpy(W), torch.from_numpy(U)),
           jmv.axm_i8_pallas(jnp.asarray(words), jnp.asarray(W),
                             jnp.asarray(U)), FOLD_TOL)


@pytest.mark.parametrize("nw,m,B", CASES)
def test_atxm_i8_matches_pallas(nw, m, B):
    """(A_a^T V, A_b^T V): both integer products exact against JAX's kernel
    body, each folded output within FOLD_TOL of atxm_i8_pallas."""
    rng = np.random.default_rng(nw * 11 + m + B)
    words = _words(rng, nw, m)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    v8, _ = tmv._quant_digits_t(torch.from_numpy(V))
    j8, _ = jmv._quant_digits_t(jnp.asarray(V))
    av, bv = tmv.atxm_i8_int_ref(_t(words), v8)
    jav, jbv = _jax_atxm_i8_int(words, j8)
    np.testing.assert_array_equal(av.numpy(), np.asarray(jav))
    np.testing.assert_array_equal(bv.numpy(), np.asarray(jbv))
    got = tmv.atxm_i8(_t(words), torch.from_numpy(V))
    want = jmv.atxm_i8_pallas(jnp.asarray(words), jnp.asarray(V))
    for g, w in zip(got, want):
        _close(g, w, FOLD_TOL)


def test_general_products_on_padding():
    """Padding samples and markers hold code 01 (the 0x55 fill): a = b = 0
    there, so the general products are zero on padding rows and columns.
    N = 16*Nw - 5 (not a multiple of 16) leaves padding samples inside the
    last word row."""
    from gvamp_tpu.ops.layout import PlanarLayout
    rng = np.random.default_rng(12)
    nw, m, M = 32, 512, 300
    words = _words(rng, nw, m)
    words[:, M:] = 0x55555555
    orig = PlanarLayout(N=16 * nw - 5, n_words=nw).planar_to_orig()
    pad_k, pad_p = np.nonzero(orig < 0)       # planar slots of padding
    by = words.view(np.uint8).reshape(nw, m, 4)
    for k, p in zip(pad_k, pad_p):
        i, b = divmod(int(p), 4)
        by[i, :, b] = (by[i, :, b] & np.uint8(~(3 << (2 * k)) & 0xFF)) \
            | np.uint8(1 << (2 * k))
    a, b = tmv.decode_planar_dense(_t(words), torch.float64)
    assert not a[:, :, M:].any() and not b[:, :, M:].any()
    assert not a[pad_k, pad_p].any() and not b[pad_k, pad_p].any()
    assert b[:, :, :M].sum() > 0
    W = rng.standard_normal((m, 3)).astype(np.float32)
    V = rng.standard_normal((4, 4 * nw, 3)).astype(np.float32)
    z = tmv.axm_i8(_t(words), torch.from_numpy(W), torch.from_numpy(W))
    assert not z[pad_k, pad_p].any()
    av, bv = tmv.atxm_i8(_t(words), torch.from_numpy(V))
    assert not av[M:].any() and not bv[M:].any()


@pytest.mark.parametrize("nw,m", [(32, 512), (64, 1024)])
def test_atx_matches_pallas(nw, m):
    """f32 (A_a^T v, A_b^T v); v >= 0 keeps the sums free of cancellation,
    so the two summation orders agree to a few ulps of the largest sum."""
    rng = np.random.default_rng(nw + m)
    words = _words(rng, nw, m)
    v = rng.random((4, 4 * nw)).astype(np.float32)
    av, bv = tmv.atx(_t(words), torch.from_numpy(v))
    jav, jbv = jmv.atx_pallas(jnp.asarray(words), jnp.asarray(v))
    _close(av, jav, FOLD_TOL)
    _close(bv, jbv, FOLD_TOL)


def test_dense_f64_matches_xla():
    """The dense plain versions in f64 against ax_xla ... atxm_xla; both are
    true f64 contractions of the same decode (1e-12 of the largest entry)."""
    rng = np.random.default_rng(3)
    nw, m, B = 32, 512, 3
    words = _words(rng, nw, m)
    tw, jw = _t(words), jnp.asarray(words)
    w, u = rng.standard_normal(m), rng.standard_normal(m)
    W, U = rng.standard_normal((m, B)), rng.standard_normal((m, B))
    v = rng.standard_normal((4, 4 * nw))
    V = rng.standard_normal((4, 4 * nw, B))
    f64 = torch.float64
    t = torch.from_numpy
    _close(tmv.ax_ref(tw, t(w), t(u), f64),
           jmv.ax_xla(jw, w, u, dtype=jnp.float64), 1e-12)
    _close(tmv.axm_ref(tw, t(W), t(U), f64),
           jmv.axm_xla(jw, W, U, dtype=jnp.float64), 1e-12)
    for got, want in zip(tmv.atx_ref(tw, t(v), f64),
                         jmv.atx_xla(jw, v, dtype=jnp.float64)):
        _close(got, want, 1e-12)
    for got, want in zip(tmv.atxm_ref(tw, t(V), f64),
                         jmv.atxm_xla(jw, V, dtype=jnp.float64)):
        _close(got, want, 1e-12)


def test_cpu_wrappers_launch_nothing_and_non_cpu_raises():
    """On the CPU the wrappers run their plain versions and count no launch;
    a tensor on any other device takes the kernel route, which checks its
    operands and raises rather than falling back."""
    rng = np.random.default_rng(4)
    words = _t(_words(rng, 32, 512))
    tmv.reset_launches()
    assert set(tmv.LAUNCHES) == {"axm_i8a", "atxm_i8a", "axm_i8", "atxm_i8",
                                 "atx", "ax", "gram_aat_i8a", "gram_aat_i8",
                                 "gram_i8a", "gram_i8", "axm_bf16",
                                 "atxm_bf16", "axm_i8s", "atx_a",
                                 "marker_counts", "stream",
                                 "stream_sum", "v0_stream", "v1_decode_a",
                                 "v2_decode_ab", "v3_bitcast", "v5_dot1",
                                 "v6_fused_ab", "v7_i8decode", "v8_atxm_vt",
                                 "v7_i8decode_round2"}
    tmv.axm_i8a(words, torch.ones((512, 2)))
    tmv.atxm_i8a(words, torch.ones((4, 128, 1)))
    tmv.axm_i8(words, torch.ones((512, 2)), torch.ones((512, 2)))
    tmv.atxm_i8(words, torch.ones((4, 128, 1)))
    tmv.atx(words, torch.ones((4, 128)))
    tmv.ax(words, torch.ones(512), torch.ones(512))
    for fn in (tmv.gram_aat_i8a, tmv.gram_aat_i8):
        fn(words, torch.ones((4, 128, 1)), torch.ones(512), torch.ones(512))
    tmv.gram_i8a(words, torch.ones((512, 1)), torch.ones((4, 128)),
                 torch.zeros(1))
    tmv.gram_i8(words, torch.ones((512, 1)), torch.ones((512, 1)),
                torch.ones((4, 128)))
    tmv.marker_counts(words, torch.ones((4, 128)))
    assert set(tmv.LAUNCHES.values()) == {0}
    meta = words.to("meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.axm_i8a(meta, torch.ones((512, 1), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.atxm_i8a(meta, torch.ones((4, 128, 1), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.axm_i8(meta, torch.ones((512, 1), device="meta"),
                   torch.ones((512, 1), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.atxm_i8(meta, torch.ones((4, 128, 1), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.atx(meta, torch.ones((4, 128), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.ax(meta, torch.ones(512, device="meta"),
               torch.ones(512, device="meta"))
    for fn in (tmv.gram_aat_i8a, tmv.gram_aat_i8):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(meta, torch.ones((4, 128, 1), device="meta"),
               torch.ones(512, device="meta"), torch.ones(512, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.marker_counts(meta, torch.ones((4, 128), device="meta"))
    # 2**24 samples: the f32 non-missing counts would no longer be exact
    huge = torch.empty((2**20, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="below 2"):
        tmv.atx(huge, torch.empty((4, 2**22), device="meta"))
    assert set(tmv.LAUNCHES.values()) == {0}
