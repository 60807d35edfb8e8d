"""The study kernels of the port (gvamp_tpu_torch/ops/study.py: stream,
stream_sum, v0_stream, v1_decode_a) against the JAX package's study kernels
(tools/bench_stream.py, tools/bench_variants.py) run in interpret mode, and
against numpy where the JAX grids drop rows; the byte bounds, the tools
bench_stream and bench_variants on the CPU, and the build hash over every
CUDA source.  The CUDA kernels are held against these plain versions on the
card by chip_smoke.py."""

import importlib
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

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


def _np_decode_a(words):
    """numpy's own a-plane decode, {2,0,1,0}[code] per 2-bit code, summed as
    u32 byte lanes over the 4 planes and the markers, mod 2**32."""
    w = words.astype(np.int64)
    tot = np.zeros(words.shape[0], np.int64)
    for b in range(4):
        for k in range(4):
            code = (w >> (8 * b + 2 * k)) & 3
            tot += (np.array([2, 0, 1, 0])[code] << (8 * b)).sum(1)
    return _wrap(tot)[None, :]


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
@pytest.mark.parametrize("name", ["stream_sum", "v0_stream", "v1_decode_a"])
def test_row_sums_equal_jax(jax_tools, name, nw, m):
    """Each plain row sum equals its JAX kernel bit for bit; stream_sum at
    two tnw where Nw allows, so tnw does not change the result."""
    bs, bv = jax_tools
    words = _words(np.random.default_rng(3 * nw + m), nw, m)
    got = getattr(study, name)(_t(words)).numpy()
    assert got.shape == (1, nw) and got.dtype == np.int32
    if name == "stream_sum":
        for tnw in (128, 256):
            np.testing.assert_array_equal(
                got, _jax(bs.stream_sum, words, tnw=tnw, tm=512))
    else:
        np.testing.assert_array_equal(got, _jax(getattr(bv, name), words))
    want = _np_decode_a(words) if name == "v1_decode_a" else _np_row_sums(words)
    np.testing.assert_array_equal(got, want)


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


# shapes where JAX's grid (Nw // 256 x Mpad // 512) drops rows or columns
DROPPED_SHAPES = [(300, 1024), (256, 1000), (300, 8), (7, 8)]


@pytest.mark.parametrize("nw,m", DROPPED_SHAPES)
def test_every_row_at_shapes_jax_drops(nw, m):
    words = _words(np.random.default_rng(nw * 7 + m), nw, m)
    t = _t(words)
    np.testing.assert_array_equal(study.stream_sum(t).numpy(),
                                  _np_row_sums(words))
    np.testing.assert_array_equal(study.v0_stream(t).numpy(),
                                  _np_row_sums(words))
    np.testing.assert_array_equal(study.v1_decode_a(t).numpy(),
                                  _np_decode_a(words))
    tm = 8
    np.testing.assert_array_equal(study.stream(t, tm).numpy(),
                                  _np_stream(words, tm))


def test_v1_decode_a_chunks_the_columns():
    """The plain v1 decodes _REF_COLS columns at a time; a matrix wider than
    one chunk, not a multiple of it, gives the same sums as numpy."""
    nw, m = 4, 2 * study._REF_COLS + 12
    words = _words(np.random.default_rng(11), nw, m)
    np.testing.assert_array_equal(study.v1_decode_a(_t(words)).numpy(),
                                  _np_decode_a(words))


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
    assert set(tmv.LAUNCHES.values()) == {0}
    meta = words.to("meta")
    for call in (lambda: study.stream(meta), lambda: study.stream_sum(meta),
                 lambda: study.v0_stream(meta),
                 lambda: study.v1_decode_a(meta)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert set(tmv.LAUNCHES.values()) == {0}


def test_bound_of_the_study_kernels():
    """Bytes only: the words once plus the int32 output at 3.35 TB/s, about
    0.50 ms at the tools' 1.68 GB and 3.21 ms at config B."""
    for (nw, m), lo, hi in (((6_400, 65_536), 0.500, 0.505),
                            ((20_480, 131_072), 3.20, 3.22)):
        for name in STUDY_KERNELS:
            ms, by = common.bound(name, nw, m, 1)
            out = 4 * nw * (512 if name == "stream" else 1)
            assert by == "bytes" and lo < ms < hi, (name, ms)
            assert ms == pytest.approx(1e3 * (4 * nw * m + out)
                                       / common.HBM_BYTES_PER_S, rel=1e-12)


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
    for name in ("v0_stream", "v1_decode_a", "v4_dot (=axm_i8a B=2)",
                 "ref axm_i8 B=2"):
        assert f"\n{name} " in out, name
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_variants.main([])


def test_study_tools_import_quietly(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["x", "--no-such-flag", "1", "2"])
    for name in ("bench_stream", "bench_variants"):
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


STUDY_INSTANTIATIONS = (
    [f"_ZN12_GLOBAL__N_113stream_kernelILi{v}EEEvPKjPjllll" for v in (1, 2, 4)]
    + [f"_ZN12_GLOBAL__N_114row_sum_kernelILi{v}ELb{d}EEEvPKjPjll"
       for v in (1, 2, 4) for d in (0, 1)])


@pytest.mark.parametrize("spilling", STUDY_INSTANTIATIONS)
def test_chip_smoke_checks_every_instantiation_for_spills(monkeypatch,
                                                          spilling):
    """chip_smoke's phase 2 reads a spill store in any instantiation of a
    study kernel (every bytes per load, with and without the decode)."""
    monkeypatch.syspath_prepend(REPO)
    smoke = importlib.import_module("chip_smoke")
    report = {f"_Z{smoke.PTXAS_ENTRY.get(k, f'{k}_kernel')}v": (32, 0)
              for k in smoke.PRODUCT_KERNELS}
    report.update({n: (32, 0) for n in STUDY_INSTANTIATIONS})
    smoke.check_ptxas(report)
    report[spilling] = (255, 8)
    with pytest.raises(AssertionError, match=spilling):
        smoke.check_ptxas(report)
