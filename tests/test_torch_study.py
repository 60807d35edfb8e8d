"""The study kernels of the port (gvamp_tpu_torch/ops/study.py: stream,
stream_sum, v0_stream, v1_decode_a, v2_decode_ab, v3_bitcast, v5_dot1,
v6_fused_ab; v7_i8decode and v8_atxm_vt in test_torch_round2.py) against the JAX package's study kernels (tools/bench_stream.py,
tools/bench_variants.py) run in interpret mode, and against numpy where the
JAX grids drop rows; the bounds, the tools bench_stream and bench_variants
on the CPU, and the build hash over every CUDA source.  The CUDA kernels are
held against these plain versions on the card by chip_smoke.py."""

import functools
import importlib
import os
import re
import shutil
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
from gvamp_tpu_torch.ops import study
from gvamp_tpu_torch.tools import common

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUDY_KERNELS = common.STUDY_KERNELS


@pytest.fixture
def jax_tools(monkeypatch):
    """(tools.bench_stream, tools.bench_variants) of the JAX package.
    bench_stream parses sys.argv when imported, so it is imported with a
    bare argv; neither file changes."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setattr(sys, "argv", ["bench_stream"])
    return (importlib.import_module("tools.bench_stream"),
            importlib.import_module("tools.bench_variants"))


def _words(rng, nw, m):
    return rng.integers(0, 2**32, size=(nw, m), dtype=np.uint64).astype(np.uint32)


def _t(words_np):
    return torch.from_numpy(words_np.view(np.int32).copy())


def _wrap(x):
    """int64 sums -> their int32 reading mod 2**32."""
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _np_row_sums(words):
    return _wrap(words.astype(np.int64).sum(1))[None, :]


def _np_stream(words, tm):
    nw, m = words.shape
    return _wrap(words.astype(np.int64).reshape(nw, m // tm, tm).sum(1))


# numpy's own decode of a 2-bit code: dosage a and non-missing indicator b
_NP_A, _NP_B = np.array([2, 0, 1, 0]), np.array([1, 0, 1, 1])


def _np_planes(words):
    """(a, b) float64[4, 4*Nw, Mpad]: plane k, row 4i+b of word row i."""
    w = words.astype(np.int64)
    nw, m = words.shape
    code = np.stack([np.stack([(w >> (8 * b + 2 * k)) & 3 for b in range(4)],
                              axis=1).reshape(4 * nw, m) for k in range(4)])
    return _NP_A[code].astype(np.float64), _NP_B[code].astype(np.float64)


def _np_decode(words, with_b=False, byte_rows=False):
    """numpy's own a-plane decode (plus the b-plane with ``with_b``) summed
    over the 4 planes and the markers: per word row as u32 byte lanes, or
    per byte row 4i+b with ``byte_rows``; mod 2**32."""
    w = words.astype(np.int64)
    tot = np.zeros((words.shape[0], 4), np.int64)
    for b in range(4):
        for k in range(4):
            code = (w >> (8 * b + 2 * k)) & 3
            tot[:, b] += (_NP_A[code] + with_b * _NP_B[code]).sum(1)
    if byte_rows:
        return _wrap(tot.reshape(-1))[None, :]
    return _wrap((tot << (8 * np.arange(4))).sum(1))[None, :]


# numpy's row sums of each row-sum rung
NP_ROWS = {"stream_sum": _np_row_sums, "v0_stream": _np_row_sums,
           "v1_decode_a": _np_decode,
           "v2_decode_ab": functools.partial(_np_decode, with_b=True),
           "v3_bitcast": functools.partial(_np_decode, byte_rows=True)}


def _jax(fn, words, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(words), **kw))


# (Nw, Mpad, tm, tnw): both tiles JAX's default and others; tnw varied
# where the shape allows
STREAM_CASES = [(256, 512, 512, 256), (256, 1024, 512, 128),
                (256, 1024, 1024, 256), (512, 1536, 512, 256),
                (512, 1536, 512, 512)]


@pytest.mark.parametrize("nw,m,tm,tnw", STREAM_CASES)
def test_stream_equals_jax(jax_tools, nw, m, tm, tnw):
    bs, _ = jax_tools
    words = _words(np.random.default_rng(nw + m + tm + tnw), nw, m)
    got = study.stream(_t(words), tm).numpy()
    assert got.shape == (nw, tm) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax(bs.stream, words, tnw=tnw, tm=tm))
    np.testing.assert_array_equal(got, _np_stream(words, tm))


ROW_SHAPES = [(256, 512), (256, 1024), (512, 1536)]


@pytest.mark.parametrize("nw,m", ROW_SHAPES)
@pytest.mark.parametrize("name", list(NP_ROWS))
def test_row_sums_equal_jax(jax_tools, name, nw, m):
    """Each plain row sum equals its JAX kernel bit for bit, and numpy's own
    decode; stream_sum at two tnw where Nw allows, so tnw does not change
    the result.  v3_bitcast's byte rows come in the order 4i+b."""
    bs, bv = jax_tools
    words = _words(np.random.default_rng(3 * nw + m), nw, m)
    got = getattr(study, name)(_t(words)).numpy()
    rows = 4 * nw if name == "v3_bitcast" else nw
    assert got.shape == (1, rows) and got.dtype == np.int32
    if name == "stream_sum":
        for tnw in (128, 256):
            np.testing.assert_array_equal(
                got, _jax(bs.stream_sum, words, tnw=tnw, tm=512))
    else:
        np.testing.assert_array_equal(got, _jax(getattr(bv, name), words))
    np.testing.assert_array_equal(got, NP_ROWS[name](words))


# one code in every bit pair: 00 (a = 2), 10 (a = 1), 01 (missing, a = 0),
# 11 (a = 0); per word the four planes give 4 * a in each byte lane
@pytest.mark.parametrize("word,lane", [(0x00000000, 8), (0xAAAAAAAA, 4),
                                       (0x55555555, 0), (0xFFFFFFFF, 0)])
def test_v1_decode_a_exact_codes(word, lane):
    nw, m = 8, 2048 + 512
    words = np.full((nw, m), word, np.uint32)
    got = study.v1_decode_a(_t(words)).numpy()
    np.testing.assert_array_equal(got, _wrap(np.full((1, nw), m * lane
                                                      * 0x01010101)))


@pytest.mark.parametrize("word,a_lane,ab_lane", [
    (0x00000000, 8, 12), (0xAAAAAAAA, 4, 8), (0x55555555, 0, 0),
    (0xFFFFFFFF, 0, 4)])
def test_v2_v3_exact_codes(word, a_lane, ab_lane):
    """Words of one code: per word, 4 (a + b) in each byte lane for
    v2_decode_ab (b = 1 for 00, 10 and 11, 0 for the missing 01), and
    4 a in every byte row for v3_bitcast."""
    nw, m = 8, 2048 + 512
    words = _t(np.full((nw, m), word, np.uint32))
    np.testing.assert_array_equal(
        study.v2_decode_ab(words).numpy(),
        _wrap(np.full((1, nw), m * ab_lane * 0x01010101)))
    np.testing.assert_array_equal(study.v3_bitcast(words).numpy(),
                                  np.full((1, 4 * nw), m * a_lane))


def test_v3_bitcast_byte_row_order(jax_tools):
    """Byte b of word row i is byte row 4i+b, in the port and in the JAX
    kernel under forced interpret mode, not the tile-local order b*TNW+i:
    words whose four bytes decode to different sums (codes 00, 10, 01 and
    then one 10 among 00s: 8, 4, 0, 7 per word) give the pattern
    8, 4, 0, 7 repeated down the rows."""
    _, bv = jax_tools
    nw, m = 256, 512
    words = np.full((nw, m), 0x0255AA00, np.uint32)
    want = np.tile(m * np.array([8, 4, 0, 7], np.int32), nw)[None, :]
    np.testing.assert_array_equal(study.v3_bitcast(_t(words)).numpy(), want)
    np.testing.assert_array_equal(_jax(bv.v3_bitcast, words), want)


# the staged products against float64 (the digit quantisation errs about
# 127^-4 of each column's largest |entry| per term; the f32 fold a few
# ulps) and against JAX (the same integers, folded in f32 on each side;
# 1.8e-7 measured at Nw=256, M=1,024), relative to max|z|
PRODUCT_TOL = 5e-7


def _np_products(words, W, U=None):
    """float64 A_a W (- A_b U) from numpy's own decode: [4, 4*Nw, B]."""
    a, b = _np_planes(words)
    z = np.einsum("knm,mc->knc", a, W.astype(np.float64))
    if U is not None:
        z -= np.einsum("knm,mc->knc", b, U.astype(np.float64))
    return z


def _close(got, want, tol=PRODUCT_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# shapes where JAX's grid (Nw // 256 x Mpad // 512) drops rows or columns
DROPPED_SHAPES = [(300, 1024), (256, 1000), (300, 1000), (300, 8), (7, 8)]


@pytest.mark.parametrize("nw,m", DROPPED_SHAPES)
def test_every_row_at_shapes_jax_drops(nw, m):
    rng = np.random.default_rng(nw * 7 + m)
    words = _words(rng, nw, m)
    t = _t(words)
    np.testing.assert_array_equal(study.stream_sum(t).numpy(),
                                  _np_row_sums(words))
    for name in ("v0_stream", "v1_decode_a", "v2_decode_ab", "v3_bitcast"):
        np.testing.assert_array_equal(getattr(study, name)(t).numpy(),
                                      NP_ROWS[name](words))
    tm = 8
    np.testing.assert_array_equal(study.stream(t, tm).numpy(),
                                  _np_stream(words, tm))
    W = rng.standard_normal((m, 2)).astype(np.float32)
    U = (rng.standard_normal((m, 2)) * 0.5).astype(np.float32)
    tW, tU = torch.from_numpy(W), torch.from_numpy(U)
    _close(study.v5_dot1(t, tW), _np_products(words, W))
    _close(study.v6_fused_ab(t, tW, tU), _np_products(words, W, U))


@pytest.mark.parametrize("nw,m", [(256, 512), (256, 1024)])
def test_v5_dot1_matches_jax(jax_tools, nw, m):
    """The plain v5_dot1 (axm_i8a's integers and fold) against JAX's
    v5_dot1 at B=2 under forced interpret mode, and against float64."""
    _, bv = jax_tools
    rng = np.random.default_rng(nw + 5 * m)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, 2)).astype(np.float32)
    z = study.v5_dot1(_t(words), torch.from_numpy(W))
    with pltpu.force_tpu_interpret_mode():
        want = bv.v5_dot1(jnp.asarray(words), jnp.asarray(W))
    _close(z, want)
    _close(z, _np_products(words, W))


def _jax_v6_intended(bv, words, W, U):
    """JAX's _v6_kernel with the right-hand side it was written for: per
    marker tile j, rows [w8 of tile j; -u8 of tile j] under one joint digit
    scale of [W; -U] (the tool's wrapper interleaves the markers instead)."""
    nw, m = words.shape
    B = W.shape[1]
    D, tnw, tm = 4 * B, bv.TNW, bv.TM
    wu8, s = bv._quant_digits(jnp.concatenate([W, -U], axis=0), 1)
    wu8 = wu8.reshape(2, m // tm, tm, D).transpose(1, 0, 2, 3).reshape(
        2 * m, D)
    vmem = pltpu.VMEM
    z = pl.pallas_call(
        bv._v6_kernel, grid=(nw // tnw, m // tm),
        in_specs=[pl.BlockSpec((tnw, tm), lambda i, j: (i, j),
                               memory_space=vmem),
                  pl.BlockSpec((2 * tm, D), lambda i, j: (j, 0),
                               memory_space=vmem)],
        out_specs=pl.BlockSpec((4, 4 * tnw, D), lambda i, j: (0, i, 0),
                               memory_space=vmem),
        out_shape=jax.ShapeDtypeStruct((4, 4 * nw, D), jnp.int32),
    )(words, wu8)
    return bv._fold_digits(z, s[0][None, None, :], B)


@pytest.mark.parametrize("nw,m,B", [(256, 512, 2), (256, 1024, 2),
                                    (256, 1024, 1), (256, 512, 16),
                                    (256, 512, 64)])
def test_v6_fused_ab_matches_the_intended_contract(jax_tools, nw, m, B):
    """The plain v6_fused_ab (axm_i8s's integers and fold) against
    axm_i8s_pallas, against JAX's _v6_kernel fed the intended per-tile
    [w8; -u8] rows (forced interpret mode), and against float64; B = 16
    and 64 (D = 64 and 256) are the widths that the kernel's one read of
    the words covers."""
    _, bv = jax_tools
    rng = np.random.default_rng(nw + 3 * m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 0.5).astype(np.float32)
    z = study.v6_fused_ab(_t(words), torch.from_numpy(W), torch.from_numpy(U))
    jw, jW, jU = jnp.asarray(words), jnp.asarray(W), jnp.asarray(U)
    _close(z, jmv.axm_i8s_pallas(jw, jW, jU))
    with pltpu.force_tpu_interpret_mode():
        _close(z, _jax_v6_intended(bv, jw, jW, jU))
    _close(z, _np_products(words, W, U))


def test_v1_decode_a_chunks_the_columns():
    """The plain v1 decodes _REF_COLS columns at a time; a matrix wider than
    one chunk, not a multiple of it, gives the same sums as numpy."""
    nw, m = 4, 2 * study._REF_COLS + 12
    words = _words(np.random.default_rng(11), nw, m)
    np.testing.assert_array_equal(study.v1_decode_a(_t(words)).numpy(),
                                  _np_decode(words))


def test_stream_raises_when_tm_does_not_divide():
    words = _t(_words(np.random.default_rng(1), 4, 1000))
    with pytest.raises(ValueError, match="must divide Mpad"):
        study.stream(words, 512)
    with pytest.raises(ValueError, match="must divide Mpad"):
        study.stream_ref(words, 0)


def test_wrappers_take_the_plain_versions_on_cpu_and_raise_elsewhere():
    """On the CPU each wrapper returns its plain version's result and counts
    no launch; a tensor on any other device takes the kernel route, which
    raises rather than falling back."""
    words = _t(_words(np.random.default_rng(2), 32, 1024))
    tmv.reset_launches()
    assert set(STUDY_KERNELS) <= set(tmv.LAUNCHES)
    assert torch.equal(study.stream(words, 512, 128, 4),
                       study.stream_ref(words, 512))
    assert torch.equal(study.stream_sum(words, 1024, 8),
                       study.stream_sum_ref(words))
    assert torch.equal(study.v0_stream(words), study.v0_stream_ref(words))
    assert torch.equal(study.v1_decode_a(words), study.v1_decode_a_ref(words))
    assert torch.equal(study.v2_decode_ab(words),
                       study.v2_decode_ab_ref(words))
    assert torch.equal(study.v3_bitcast(words), study.v3_bitcast_ref(words))
    W, U = torch.randn((1024, 3)), torch.randn((1024, 3))
    assert torch.equal(study.v5_dot1(words, W), tmv.axm_i8a_ref(words, W))
    assert torch.equal(study.v6_fused_ab(words, W, U),
                       tmv.axm_i8s_ref(words, W, U))
    assert set(tmv.LAUNCHES.values()) == {0}
    meta = words.to("meta")
    Wm, Um = W.to("meta"), U.to("meta")
    for call in (lambda: study.stream(meta), lambda: study.stream_sum(meta),
                 lambda: study.v0_stream(meta),
                 lambda: study.v1_decode_a(meta),
                 lambda: study.v2_decode_ab(meta),
                 lambda: study.v3_bitcast(meta),
                 lambda: study.v5_dot1(meta, Wm),
                 lambda: study.v6_fused_ab(meta, Wm, Um)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert set(tmv.LAUNCHES.values()) == {0}


def test_bound_of_the_study_kernels():
    """Bytes only: the words once plus the int32 output (4 Nw for
    v3_bitcast's byte rows) at 3.35 TB/s, about 0.50 ms at the tools' 1.68
    GB and 3.21 ms at config B."""
    for (nw, m), lo, hi in (((6_400, 65_536), 0.500, 0.505),
                            ((20_480, 131_072), 3.20, 3.22)):
        for name in STUDY_KERNELS:
            ms, by = common.bound(name, nw, m, 1)
            out = 4 * nw * {"stream": 512, "v3_bitcast": 4}.get(name, 1)
            assert by == "bytes" and lo < ms < hi, (name, ms)
            assert ms == pytest.approx(1e3 * (4 * nw * m + out)
                                       / common.HBM_BYTES_PER_S, rel=1e-12)


@pytest.mark.parametrize("B,by", [(1, "bytes"), (2, "bytes"),
                                  (64, "operations")])
def test_bound_of_the_staged_products(B, by):
    """v5_dot1 and v6_fused_ab are charged as axm_i8a and axm_i8s: the
    words and the f32 columns at 3.35 TB/s against 2 N M D int8 operations
    (twice that for v6) at 1,979 TOP/s, the larger of the two; at config
    B the bytes bound them at the ladder's B = 2, the operations at
    B = 64."""
    nw, m = 20_480, 131_072
    n = 16 * nw
    assert not set(common.STUDY_PRODUCTS) & set(STUDY_KERNELS)
    for name, planes, cols in (("v5_dot1", 1, 1), ("v6_fused_ab", 2, 2)):
        lib = common.STUDY_PRODUCTS[name]
        ms, got_by = common.bound(name, nw, m, B)
        assert (ms, got_by) == common.bound(lib, nw, m, B)
        t_bytes = (4 * nw * m + (cols * 4 * m + 4 * n) * B) \
            / common.HBM_BYTES_PER_S
        t_ops = 2 * n * m * 4 * B * planes / common.INT8_OPS_PER_S
        assert got_by == by
        assert ms == pytest.approx(1e3 * max(t_bytes, t_ops), rel=1e-12)


def test_bench_stream_runs_on_cpu(capsys):
    from gvamp_tpu_torch.tools import bench_stream
    assert bench_stream.main(["--device", "cpu", "8", "1024", "1"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if "of 3.35 TB/s" in ln]
    assert len(rows) == 2 + 2 * len(study.THREADS) * len(study.LOAD_BYTES)
    for name in ("torch.sum (whole matrix)", "torch.sum per row",
                 "stream threads=128 load=4B",
                 "stream_sum threads=1024 load=16B"):
        assert name in out, name
    assert bench_stream.main(["--device", "cpu", "8", "1000", "1"]) == 0
    assert "stream: skipped" in capsys.readouterr().out


def test_bench_variants_runs_on_cpu(capsys):
    from gvamp_tpu_torch.tools import bench_variants
    assert bench_variants.main(["--device", "cpu", "8", "1024", "1"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.endswith("GB/s")]
    assert len(rows) == 9
    for name in ("v0_stream", "v1_decode_a", "v2_decode_ab", "v3_bitcast",
                 "v4_dot (=axm_i8a B=2)", "v5_dot1 (stacked)",
                 "v6_fused_ab (err=", "v7_i8decode B=2", "ref axm_i8 B=2"):
        assert f"\n{name}" in out, name
    err = float(out.split("v6_fused_ab (err=")[1].split(")")[0])
    assert err <= bench_variants.V6_TOL
    assert "every rung equal to its plain version" in out
    assert "FAULT" not in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_variants.main([])


@pytest.mark.parametrize("name", ["v0_stream", "v3_bitcast", "v5_dot1",
                                  "v6_fused_ab", "v7_i8decode"])
def test_bench_variants_fails_when_a_rung_differs(capsys, monkeypatch, name):
    """A rung whose result is one off its plain version's anywhere makes
    the tool name it and return 1."""
    from gvamp_tpu_torch.tools import bench_variants
    ref = getattr(study, f"{name}_ref")

    def off_by_one(*args):
        z = ref(*args).clone(memory_format=torch.contiguous_format)
        z.view(-1)[-1] += 1
        return z

    monkeypatch.setattr(study, name, off_by_one)
    assert bench_variants.main(["--device", "cpu", "8", "1024", "1"]) == 1
    out = capsys.readouterr().out
    assert f"FAULT {name}" in out and "differs from its plain version" in out
    assert "every rung equal" not in out


def test_study_tools_import_quietly(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x", "--no-such-flag", "1", "2"])
    for name in ("bench_stream", "bench_variants", "bench_round2"):
        importlib.reload(importlib.import_module(f"gvamp_tpu_torch.tools.{name}"))
    assert capsys.readouterr().out == ""


def test_build_hash_covers_every_source(tmp_path):
    """The library's name changes when a header's bytes change, or when a
    file is added, in a copy of csrc/; the repository's files stay as they
    are."""
    from gvamp_tpu_torch.ops import _build
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    assert {p.name for p in src.iterdir()} >= {"matvec.cu", "study.cu",
                                               "swar.cuh"}
    h0 = _build.source_hash(str(src))
    assert h0 == _build.source_hash(str(src))
    header = src / "swar.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    h1 = _build.source_hash(str(src))
    assert h1 != h0
    (src / "extra.cuh").write_bytes(b"")
    assert _build.source_hash(str(src)) not in (h0, h1)
    assert _build.source_hash() == _build.source_hash(_build.CSRC)


@pytest.mark.parametrize("fail", [None, "study.cu"])
def test_build_compiles_each_source_then_links(tmp_path, monkeypatch, fail):
    """One nvcc per source under csrc/, then one link into the library
    named by the sources' hash; the objects are removed, and a failing
    source raises with its command and output and leaves no library.  The
    nvcc here is a stand-in script that logs its arguments and writes the
    file after -o."""
    from gvamp_tpu_torch.ops import _build
    calls = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {calls}\n'
        f'case "$*" in *{fail or "no-such-source"}*) echo broken; exit 1;; '
        "esac\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n'
        'echo "ptxas info: $$"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(nvcc.parent.parent))
    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, src)
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "CSRC", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    sources = sorted(p.name for p in src.glob("*.cu"))
    if fail:
        with pytest.raises(RuntimeError, match=f"(?s)nvcc failed.*{fail}"
                                               f".*broken"):
            _build.build()
        assert os.listdir(out) == []
        return
    lib = _build.build()
    assert lib == str(out / f"libgvamp_tpu_torch_"
                            f"{_build.source_hash(str(src))}.so")
    assert os.listdir(out) == [os.path.basename(lib)]
    lines = calls.read_text().splitlines()
    assert len(lines) == len(sources) + 1
    assert sorted(ln.split()[-1].rsplit("/", 1)[-1]
                  for ln in lines[:-1]) == sources
    assert all(" -c " in ln for ln in lines[:-1])
    assert lines[-1].split()[0] == "-shared"
    assert _build.BUILD_INFO["log"].count("ptxas info") == len(sources) + 1
    assert _build.build() == lib and len(calls.read_text().splitlines()) == \
        len(sources) + 1


# the mangled names of every instantiation of study.cu's kernels, as ptxas
# reports them on the card (nvcc names the anonymous namespace by file):
# stream per V; the row sums per <V, Decode, lanes> (stream_sum and
# v0_stream, v1_decode_a, v2_decode_ab, v3_bitcast); stage_dot (v5_dot1);
# i8decode per <kVec> (both v7_i8decode keys); atxm_vt (v8_atxm_vt); and
# fused_ab.cu's fused_ab_kernel per digit group width N (v6_fused_ab)
_NS = "_ZN40_GLOBAL__N__4cd102fc_8_study_cu_649beea1"
_FAB_NS = "_ZN44_GLOBAL__N__22bb6098_11_fused_ab_cu_29e18db9"
FUSED_AB_INSTANTIATIONS = [f"{_FAB_NS}15fused_ab_kernelILi{n}EEEvPKjPKhPillll"
                           for n in study.FUSED_AB_N]
STUDY_INSTANTIATIONS = (
    [f"{_NS}13stream_kernelILi{v}EEEvPKjPjllll" for v in (1, 2, 4)]
    + [f"{_NS}14row_sum_kernelILi{v}ELNS_6DecodeE{d}ELi{lanes}EEEvPKjPjll"
       for v in (1, 2, 4) for d, lanes in ((0, 1), (1, 1), (2, 1), (1, 4))]
    + [f"{_NS}16stage_dot_kernelEPKjPKiPillll"]
    + [f"{_NS}15i8decode_kernelILb{b}EEEvPKhS2_Pillll" for b in (0, 1)]
    + [f"{_NS}14atxm_vt_kernelEPKjPKhPillll"]
    + FUSED_AB_INSTANTIATIONS)


@pytest.mark.parametrize("spilling", STUDY_INSTANTIATIONS)
def test_chip_smoke_checks_every_instantiation_for_spills(monkeypatch,
                                                          spilling):
    """chip_smoke's phase 2 reads a spill store in any instantiation of a
    study kernel (every bytes per load and decode of the row sums, the
    staged v5_dot1, both load widths of i8decode, atxm_vt, v6_fused_ab's
    wgmma kernel at every digit group width)."""
    monkeypatch.syspath_prepend(REPO)
    smoke = importlib.import_module("chip_smoke")
    report = {f"_Z{smoke.PTXAS_ENTRY.get(k, f'{k}_kernel')}v": (32, 0)
              for k in smoke.PRODUCT_KERNELS}
    report.update({n: (32, 0) for n in STUDY_INSTANTIATIONS})
    smoke.check_ptxas(report)
    report[spilling] = (255, 8)
    with pytest.raises(AssertionError, match=spilling):
        smoke.check_ptxas(report)


def test_chip_smoke_names_the_fused_ab_kernel(monkeypatch):
    """v6_fused_ab's ptxas entry matches every instantiation of
    fused_ab_kernel and nothing of study.cu, v5_dot1's the one stage_dot;
    its kernels line names csrc/fused_ab.cu; phase 3s runs it at the
    ladder's B = 2 and at the widths its one read covers."""
    monkeypatch.syspath_prepend(REPO)
    smoke = importlib.import_module("chip_smoke")
    names = list(STUDY_INSTANTIATIONS)
    assert [n for n in names if re.search(smoke.PTXAS_ENTRY["v6_fused_ab"],
                                          n)] == FUSED_AB_INSTANTIATIONS
    assert [n for n in names if re.search(smoke.PTXAS_ENTRY["v5_dot1"], n)] \
        == [f"{_NS}16stage_dot_kernelEPKjPKiPillll"]
    assert smoke.FUSED_AB_SOURCE == "gvamp_tpu_torch/csrc/fused_ab.cu"
    assert os.path.isfile(os.path.join(REPO, smoke.FUSED_AB_SOURCE))
    assert smoke.FUSED_AB_WIDTHS == (2, 16, 64)
    assert "v6_fused_ab" in smoke.FORWARD_KERNELS


@pytest.mark.parametrize("D,n,kt,groups", [(4, 8, 256, 1), (8, 8, 256, 1),
                                           (20, 32, 256, 1), (64, 64, 256, 1),
                                           (68, 128, 128, 1),
                                           (256, 256, 128, 1),
                                           (280, 256, 128, 2)])
def test_fused_ab_group_width(D, n, kt, groups):
    """D digit rows take the narrowest wgmma group width of FUSED_AB_N that
    holds them (256 past that, in groups), and its tile length."""
    assert study.fused_ab_n(D) == n and study.fused_ab_kt(n) == kt
    w8 = torch.ones((D, 16), dtype=torch.int8)
    assert study.fused_ab_digits(w8, w8, n, kt).shape[:2] == (groups, 1)


@pytest.mark.parametrize("m", [1000, 8])
@pytest.mark.parametrize("D", [20, 280])
def test_fused_ab_digit_layout(m, D):
    """fused_ab_digits reads back to w8t and mu8t: entry [z, j, p, c, r8,
    r, e] is digit row z n + 8 r8 + r of type p (w8, then mu8) at marker
    j kt + 16 c + e, and every entry past D or past Mpad is zero."""
    rng = np.random.default_rng(D + m)
    w8 = torch.from_numpy(rng.integers(-127, 128, (D, m), dtype=np.int8))
    mu8 = torch.from_numpy(rng.integers(-127, 128, (D, m), dtype=np.int8))
    n = study.fused_ab_n(D)
    kt = study.fused_ab_kt(n)
    dig = study.fused_ab_digits(w8, mu8, n, kt)
    groups, tiles = -(-D // n), -(-m // kt)
    assert dig.shape == (groups, tiles, 2, kt // 16, n // 8, 8, 16)
    assert dig.dtype == torch.int8 and dig.is_contiguous()
    # one bulk copy per (group, tile), whole 16-byte core-matrix rows
    assert dig[0, 0].numel() == 2 * kt * n and (2 * kt * n) % 16 == 0
    z, j, p, c, r8, r, e = np.meshgrid(
        *[np.arange(x) for x in dig.shape], indexing="ij")
    row = z * n + 8 * r8 + r
    col = j * kt + 16 * c + e
    full = np.zeros((2, groups * n, tiles * kt), np.int8)
    full[0, :D, :m] = w8.numpy()
    full[1, :D, :m] = mu8.numpy()
    np.testing.assert_array_equal(dig.numpy(), full[p, row, col])
    pad = (row >= D) | (col >= m)
    assert pad.any() and not dig.numpy()[pad].any()
    inside = ~pad
    assert (p[inside] == 0).sum() == (p[inside] == 1).sum() == D * m


def test_bench_fused_ab_runs_on_cpu(capsys, monkeypatch):
    """bench_fused_ab on the CPU: one line per width with both kernels'
    rounds and the bound; a v6_fused_ab that differs from axm_i8s is a
    fault (exit 1)."""
    from gvamp_tpu_torch.tools import bench_fused_ab
    argv = ["--device", "cpu", "64", "512", "1", "--widths", "1,16",
            "--rounds", "2"]
    assert bench_fused_ab.main(argv) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if "v6_fused_ab" in ln]
    assert [ln.split()[0] for ln in rows] == ["B=1", "B=16"]
    assert all(ln.count(" ms") == 3 and "axm_i8s" in ln and "bound" in ln
               for ln in rows)
    monkeypatch.setattr(study, "v6_fused_ab",
                        lambda w, W, U: study.v6_fused_ab_ref(w, W, U) + 1)
    assert bench_fused_ab.main(argv) == 1
    assert "FAULT v6_fused_ab B=1: differs from axm_i8s" in \
        capsys.readouterr().out
