"""The products behind the port's tools (the bf16 split, axm_bf16,
atxm_bf16, axm_i8s, atx_a in gvamp_tpu_torch/ops/matvec.py) against the JAX
package's Pallas kernels in interpret mode, and the tools themselves
(gvamp_tpu_torch/tools/) on the CPU.  The CUDA kernels are held against
these plain versions on the card by chip_smoke.py."""

import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.tools import common

torch.set_num_threads(1)

# folded f32 outputs of one exact integer product: a few ulps of the
# largest entry (tests/test_torch_matvec.py)
FOLD_TOL = 1e-6
# the bf16-split products: the same exact per-term products (a or b times
# a bf16 part) with f32 sums in another order
BF16_TOL = 1e-6

TOOL_KERNELS = ("axm_bf16", "atxm_bf16", "axm_i8s", "atx_a")


def _words(rng, nw, m):
    return rng.integers(0, 2**32, size=(nw, m), dtype=np.uint64).astype(np.uint32)


def _t(words_np):
    return torch.from_numpy(words_np.view(np.int32).copy())


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max() + 1e-30
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _bits(x):
    return np.asarray(x).view(np.uint16)


@pytest.mark.parametrize("dim", [0, 1])
def test_split_hi_lo_equals_jax(dim):
    """The three bf16 parts equal JAX's bit for bit, across magnitudes and
    with zeros; mid and lo are real residuals (not all zero), and the parts
    add back to x within f32 rounding."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((256, 7))
         * 10.0 ** rng.integers(-6, 7, (256, 7))).astype(np.float32)
    x[3, :] = 0.0
    x[:, 2] = -x[:, 2]
    got = tmv._split_hi_lo(torch.from_numpy(x), dim)
    want = jmv._split_hi_lo(jnp.asarray(x), dim)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                  _bits(jax.lax.bitcast_convert_type(
                                      want, jnp.uint16)))
    hi, mid, lo = (p.to(torch.float64) for p in torch.chunk(got, 3, dim=dim))
    assert mid.abs().max() > 0 and lo.abs().max() > 0
    xs = torch.from_numpy(x).to(torch.float64)
    assert float(((hi + mid + lo) - xs).abs().max()
                 / xs.abs().max()) < 1e-7


# (Nw, Mpad, B): B=70 takes the _BMAX_BF16 column chunking on both sides
BF16_CASES = [(32, 512, 1), (64, 1024, 3), (32, 512, 70)]


@pytest.mark.parametrize("nw,m,B", BF16_CASES)
def test_bf16_refs_match_pallas(nw, m, B):
    """axm_bf16 / atxm_bf16 (the plain versions on the CPU) against
    axm_pallas / atxm_pallas in interpret mode."""
    rng = np.random.default_rng(nw * 17 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 3).astype(np.float32)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    t = torch.from_numpy
    jw = jnp.asarray(words)
    z = tmv.axm_bf16(_t(words), t(W), t(U))
    assert z.shape == (4, 4 * nw, B)
    _close(z, jmv.axm_pallas(jw, jnp.asarray(W), jnp.asarray(U)), BF16_TOL)
    got = tmv.atxm_bf16(_t(words), t(V))
    want = jmv.atxm_pallas(jw, jnp.asarray(V))
    for g, w in zip(got, want):
        assert g.shape == (m, B)
        _close(g, w, BF16_TOL)


def test_bf16_refs_keep_every_part():
    """Against float64 the split products err far below what one bf16 part
    alone would (about 1e-3 relative): the plain versions use all three."""
    rng = np.random.default_rng(8)
    nw, m, B = 32, 512, 2
    words = _t(_words(rng, nw, m))
    W = torch.from_numpy(rng.standard_normal((m, B)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((4, 4 * nw, B)).astype(np.float32))
    f64 = torch.float64
    z64 = tmv.axm_ref(words, W, W, f64)
    err = float((tmv.axm_bf16_ref(words, W, W) - z64).abs().max()
                / z64.abs().max())
    a64, b64 = tmv.atxm_ref(words, V, f64)
    av, bv = tmv.atxm_bf16_ref(words, V)
    err = max(err, float((av - a64).abs().max() / a64.abs().max()),
              float((bv - b64).abs().max() / b64.abs().max()))
    assert err < 5e-7
    one_part = tmv._split_hi_lo(W, 1)[:, :B].to(torch.float32)
    err1 = float((tmv.axm_ref(words, one_part, one_part, f64) - z64).abs().max()
                 / z64.abs().max())
    assert err1 > 100 * err


def _jax_axm_i8s_int(words, w8t, mu8t):
    """JAX's shared-accumulator digit products: the _axm_i8s_kernel body,
    interpret mode."""
    nw, m = words.shape
    D = w8t.shape[0]
    tnw, tm = jmv._pick_tnw(nw, 256), jmv._pick_tm(m, 2048)
    vmem = pltpu.VMEM
    dig = pl.BlockSpec((D, tm), lambda i, j: (0, j), memory_space=vmem)
    return pl.pallas_call(
        jmv._axm_i8s_kernel, grid=(nw // tnw, m // tm),
        in_specs=[pl.BlockSpec((tnw, tm), lambda i, j: (i, j), memory_space=vmem),
                  dig, dig],
        out_specs=pl.BlockSpec((D, 4, 4 * tnw), lambda i, j: (0, 0, i),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((D, 4, 4 * nw), jnp.int32),
        interpret=True)(jnp.asarray(words), jnp.asarray(w8t), jnp.asarray(mu8t))


# B=33 is above _BMAX_AXM: JAX chunks it into two calls, the port makes one
@pytest.mark.parametrize("nw,m,B", [(32, 512, 1), (64, 1024, 2),
                                    (32, 512, 33)])
def test_axm_i8s_matches_pallas(nw, m, B):
    """The shared-scale digits equal JAX's _quant_digits_pair; the int32
    products equal the JAX kernel body's; the fold is within FOLD_TOL of
    axm_i8s_pallas."""
    rng = np.random.default_rng(nw * 19 + m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 1.5).astype(np.float32)
    w8t, mu8t, ws = tmv._quant_digits_pair(torch.from_numpy(W),
                                           torch.from_numpy(U))
    j8t, jm8t, jws = jmv._quant_digits_pair(jnp.asarray(W), jnp.asarray(U))
    np.testing.assert_array_equal(w8t.numpy(), np.asarray(j8t))
    np.testing.assert_array_equal(mu8t.numpy(), np.asarray(jm8t))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws)[:, 0])
    np.testing.assert_array_equal(
        tmv.axm_i8s_int_ref(_t(words), w8t, mu8t).numpy(),
        np.asarray(_jax_axm_i8s_int(words, j8t, jm8t)))
    z = tmv.axm_i8s(_t(words), torch.from_numpy(W), torch.from_numpy(U))
    assert z.shape == (4, 4 * nw, B)
    _close(z, jmv.axm_i8s_pallas(jnp.asarray(words), jnp.asarray(W),
                                 jnp.asarray(U)), FOLD_TOL)


@pytest.mark.parametrize("nw,m", [(32, 512), (64, 1024)])
def test_atx_a_matches_pallas(nw, m):
    """A_a^T v: equal to atx_a_pallas on dyadic v (multiples of 1/8, every
    f32 partial sum exact in any order), within 1e-6 relative on Gaussian
    v; and equal to the a-side of atx."""
    rng = np.random.default_rng(nw * 23 + m)
    words = _words(rng, nw, m)
    jw = jnp.asarray(words)
    vd = (rng.integers(0, 9, (4, 4 * nw)) / 8).astype(np.float32)
    got = tmv.atx_a(_t(words), torch.from_numpy(vd))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jmv.atx_a_pallas(jw, vd)))
    np.testing.assert_array_equal(got.numpy(),
                                  tmv.atx(_t(words), torch.from_numpy(vd))[0])
    vg = rng.standard_normal((4, 4 * nw)).astype(np.float32)
    _close(tmv.atx_a(_t(words), torch.from_numpy(vg)),
           jmv.atx_a_pallas(jw, vg), FOLD_TOL)


def test_tool_products_on_padding():
    """Padding samples and markers hold code 01 (a = b = 0): the four
    products are zero on padding rows and marker columns."""
    from gvamp_tpu_torch.ops.layout import PlanarLayout
    rng = np.random.default_rng(13)
    nw, m, M = 32, 512, 300
    words = _words(rng, nw, m)
    words[:, M:] = 0x55555555
    orig = PlanarLayout(N=16 * nw - 5, n_words=nw).planar_to_orig()
    pad_k, pad_p = np.nonzero(orig < 0)
    by = words.view(np.uint8).reshape(nw, m, 4)
    for k, p in zip(pad_k, pad_p):
        i, b = divmod(int(p), 4)
        by[i, :, b] = (by[i, :, b] & np.uint8(~(3 << (2 * k)) & 0xFF)) \
            | np.uint8(1 << (2 * k))
    W = torch.from_numpy(rng.standard_normal((m, 3)).astype(np.float32))
    V = torch.from_numpy(rng.standard_normal((4, 4 * nw, 3)).astype(np.float32))
    for fn in (tmv.axm_bf16, tmv.axm_i8s):
        z = fn(_t(words), W, W)
        assert not z[pad_k, pad_p].any() and z.abs().max() > 0
    av, bv = tmv.atxm_bf16(_t(words), V)
    assert not av[M:].any() and not bv[M:].any() and bv[:M].abs().max() > 0
    av1 = tmv.atx_a(_t(words), V[..., 0])
    assert not av1[M:].any() and av1[:M].abs().max() > 0


def test_tool_wrappers_launch_nothing_on_cpu_and_raise_elsewhere():
    """On the CPU the four wrappers run their plain versions and count no
    launch; a tensor on any other device takes the kernel route, which
    raises rather than falling back.  The shared-accumulator bound is
    381*M, tighter than one plane's 254*M."""
    rng = np.random.default_rng(6)
    words = _t(_words(rng, 32, 512))
    tmv.reset_launches()
    assert set(TOOL_KERNELS) <= set(tmv.LAUNCHES)
    tmv.axm_bf16(words, torch.ones((512, 2)), torch.ones((512, 2)))
    tmv.atxm_bf16(words, torch.ones((4, 128, 2)))
    tmv.axm_i8s(words, torch.ones((512, 2)), torch.ones((512, 2)))
    tmv.atx_a(words, torch.ones((4, 128)))
    assert set(tmv.LAUNCHES.values()) == {0}
    meta = words.to("meta")
    m1 = torch.ones((512, 1), device="meta")
    for call in (lambda: tmv.axm_bf16(meta, m1, m1),
                 lambda: tmv.atxm_bf16(meta, torch.ones((4, 128, 1),
                                                        device="meta")),
                 lambda: tmv.axm_i8s(meta, m1, m1),
                 lambda: tmv.atx_a(meta, torch.ones((4, 128), device="meta"))):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert set(tmv.LAUNCHES.values()) == {0}
    k = (2**31 - 1) // 381
    tmv._check_bound("axm_i8s", k, 381)
    with pytest.raises(ValueError, match="381"):
        tmv._check_bound("axm_i8s", k + 1, 381)
    tmv._check_bound("axm_i8", k + 1)


def test_bound_of_the_tool_kernels():
    """At config B (N=327,680 x M=131,072) each of the four is bound by the
    10.74 GB of words at 3.35 TB/s, about 3.21 ms; the bf16 products' bf16
    operations alone would take 0.52 ms per column."""
    nw, m = 20_480, 131_072
    for name in TOOL_KERNELS:
        ms, by = common.bound(name, nw, m, 1)
        assert by == "bytes" and 3.2 < ms < 3.25, (name, ms, by)
    ops_ms = 2 * 16 * nw * m * 6 / common.BF16_OPS_PER_S * 1e3
    assert 0.5 < ops_ms < 0.53


def test_words_helpers():
    """complete_words leaves no missing code; synth_words keeps about one
    missing call in 64 with ``miss`` (one in four codes is 01, one in
    sixteen of those kept) and none without."""
    gen = torch.Generator()
    gen.manual_seed(0)
    w = common.random_words(gen, 16, 5000, "cpu")
    assert w.shape == (16, 5000)

    def missing(x):
        """Calls with code 01: one set bit each in lo & ~hi."""
        lo = x & 0x55555555
        hi = (x >> 1) & 0x55555555
        return int(np.unpackbits((lo & ~hi).numpy().view(np.uint8)).sum())

    assert missing(common.complete_words(w)) == 0
    assert missing(common.synth_words(gen, False, 4096, 4096, "cpu")) == 0
    share = missing(common.synth_words(gen, True, 4096, 4096, "cpu")) / (
        4096 * 4096)
    assert abs(share - 1 / 64) < 0.001


def test_tools_import_quietly(capsys, monkeypatch):
    """Importing a tool parses no argument and runs nothing."""
    monkeypatch.setattr(sys, "argv", ["x", "--no-such-flag", "1", "2"])
    for name in ("kernel_check", "bench_gram", "profile_kernels", "common"):
        importlib.reload(importlib.import_module(f"gvamp_tpu_torch.tools.{name}"))
    assert capsys.readouterr().out == ""


def test_kernel_check_and_bench_gram_pass_on_cpu(capsys):
    """kernel_check's float64-oracle checks and bench_gram.correctness pass
    through the plain versions on the CPU; the default device is the card,
    which raises here."""
    from gvamp_tpu_torch.tools import bench_gram, kernel_check
    assert kernel_check.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("ok  ") == 11 + 7 and "FAIL" not in out
    assert bench_gram.correctness("cpu") is True
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            kernel_check.main([])


def test_profile_prints_one_row_per_kernel(capsys):
    """One row per kernel and width: the four digit products and, where the
    words take them, the dual and the primal fused Grams; above
    GRAM_AAT_MAX_NW word rows the dual Grams, and at word rows that are
    not whole bands the primal ones, are named as not timed."""
    from gvamp_tpu_torch.tools import profile_kernels
    widths = [f"B={B}" for B in profile_kernels.WIDTHS]
    for nw, fused in ((32, True), (823, False)):
        assert profile_kernels.main(["--device", "cpu", str(nw), "64" if
                                     nw > 32 else "4096", "1"]) == 0
        lines = capsys.readouterr().out.splitlines()
        rows = [ln for ln in lines if ln.rstrip().endswith("GB/s")]
        names = [ln.split()[0] for ln in rows]
        timed = profile_kernels.DIGIT_PRODUCTS + (
            profile_kernels.DUAL_GRAMS + profile_kernels.PRIMAL_GRAMS) * fused
        assert len(rows) == len(timed) * len(widths) + 3
        for name in timed:
            assert [r.split()[1] for r in rows if r.split()[0] == name] \
                == widths
        assert {"ax", "atx", "atx_a"} <= set(names)
        assert sum("not timed" in ln for ln in lines) == 2 * (not fused)


def test_bench_gram_times_on_cpu(capsys):
    """bench_gram's timing section at a tiny size: every fused kernel beside
    its composition, the dual ones at their own shape where the words'
    N exceeds their stripe cache."""
    from gvamp_tpu_torch.tools import bench_gram
    assert bench_gram.main(["--device", "cpu", "--reps", "1", "64",
                            "1024"]) == 0
    out = capsys.readouterr().out
    for name in ("gram_i8a", "gram_i8", "axm_i8s", "gram_aat_i8",
                 "gram_aat_i8a", "comp AAT a-only"):
        assert f"\n{name} " in out, name
    assert bench_gram._dual_shape(6400, 65536) == (320, 1_310_720)
    assert bench_gram._dual_shape(64, 1024) == (64, 1024)


SASS_LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_112atx_a_kernelEPKjPKfPflll
\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x0 */
        /*0010*/                   PRMT R2, R3, 0x7650, R4 ;         /* 0x0 */
        /*0020*/                   LDS.128 R8, [R2+0x40] ;           /* 0x0 */
        /*0030*/                   FADD R6, R5, R6 ;                 /* 0x0 */
        /*0040*/               @!P0 BRA 0x10 ;                       /* 0x0 */
        /*0050*/                   EXIT ;                            /* 0x0 */
        /*0060*/                   BRA 0x60;                         /* 0x0 */
\t\tFunction : _ZN12_GLOBAL__N_110atx_kernelEPKjPKfPflll
        /*0000*/                   I2F.U32 R1, R2 ;                  /* 0x0 */
        /*0010*/                   EXIT ;                            /* 0x0 */
"""


def test_sass_count_splits_functions_and_loops(tmp_path, capsys):
    """sass_count: the functions matching a pattern, each loop closed by a
    backward branch (not the branch to itself after EXIT), opcodes by
    family, counts divided by --per."""
    from gvamp_tpu_torch.tools import sass_count
    found = sass_count.count(SASS_LISTING, "atx_a_kernel")
    assert list(found) == ["_ZN12_GLOBAL__N_112atx_a_kernelEPKjPKfPflll"]
    length, bodies = found["_ZN12_GLOBAL__N_112atx_a_kernelEPKjPKfPflll"]
    assert length == 7
    assert [(lo, hi) for lo, hi, _ in bodies] == [(0x10, 0x40)]
    assert bodies[0][2] == {"PRMT": 1, "LDS": 1, "FADD": 1, "BRA": 1}
    assert set(sass_count.count(SASS_LISTING, "atx_")) == {
        "_ZN12_GLOBAL__N_112atx_a_kernelEPKjPKfPflll",
        "_ZN12_GLOBAL__N_110atx_kernelEPKjPKfPflll"}
    path = tmp_path / "k.sass"
    path.write_text(SASS_LISTING)
    assert sass_count.main([str(path), "atx_a_kernel", "--per", "2"]) == 0
    out = capsys.readouterr().out
    assert "4 instructions, 2 per 2: PRMT 0.5, LDS 0.5, FADD 0.5, BRA 0.5" \
        in out
    assert sass_count.main([str(path), "gram_kernel"]) == 1
