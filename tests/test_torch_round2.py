"""The last three study kernels of the port (gvamp_tpu_torch/ops/study.py:
v7_i8decode, under both of its launch keys, and v8_atxm_vt) and the tool
bench_round2, against the JAX package's study kernels (tools/bench_round2.py,
tools/bench_variants.py) run in forced interpret mode and its library
kernels (axm_i8a_pallas, atxm_i8a_pallas), and against numpy where the
JAX grids drop rows; the byte-row layout, the wrapper rule, the bounds, and
chip_smoke's table of the TPU kernels.  The CUDA kernels are held against
these plain versions on the card by chip_smoke.py."""

import importlib
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from gvamp_tpu.ops import matvec as jmv

from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.ops import study
from gvamp_tpu_torch.tools import common

from test_torch_study import (DROPPED_SHAPES, PRODUCT_TOL, _close,
                              _np_planes, _np_products, _t, _words)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V7_KEYS = ("v7_i8decode", "v7_i8decode_round2")


@pytest.fixture
def jax_round2(monkeypatch):
    """(tools.bench_round2, tools.bench_variants) of the JAX package.
    bench_round2 parses sys.argv when imported, so it is imported with a
    bare argv; neither file changes."""
    monkeypatch.syspath_prepend(REPO)
    monkeypatch.setattr(sys, "argv", ["bench_round2"])
    return (importlib.import_module("tools.bench_round2"),
            importlib.import_module("tools.bench_variants"))


def _np_atxm(words, V):
    """float64 A_a^T V from numpy's own decode: [Mpad, B]."""
    a, _ = _np_planes(words)
    return np.einsum("knm,knc->mc", a, V.astype(np.float64))


@pytest.mark.parametrize("nw,m", [(256, 512), (3, 8), (5, 36), (1, 16)])
def test_expand_words_equals_jax_and_collapse_inverts_it(jax_round2, nw, m):
    """Byte row 4i+b is byte b of word row i, as JAX's expand_words lays
    them out; collapse_bytes gives the words back, bit for bit."""
    br, _ = jax_round2
    words = _words(np.random.default_rng(nw + m), nw, m)
    got = study.expand_words(_t(words))
    assert got.dtype == torch.int8 and got.shape == (4 * nw, m)
    assert got.is_contiguous()
    want = br.expand_words(jnp.asarray(words))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[4 * (nw - 1) + 1],
                                  ((words[-1] >> 8) & 0xFF).astype(np.uint8)
                                  .view(np.int8))
    assert torch.equal(study.collapse_bytes(got), _t(words))


# whole tiles of the JAX grids (Nw // 256 x Mpad // 512)
JAX_CASES = [(256, m, B) for m in (512, 1024) for B in (1, 2, 5)]


@pytest.mark.parametrize("nw,m,B", JAX_CASES)
def test_v7_i8decode_matches_both_jax_copies(jax_round2, nw, m, B):
    """The plain v7_i8decode (both keys) on the byte rows against JAX's two
    copies of v7_i8decode (forced interpret mode, on JAX's expand_words
    bytes), against axm_i8a_pallas on the words, and against float64."""
    br, bv = jax_round2
    rng = np.random.default_rng(nw + 7 * m + B)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, B)).astype(np.float32)
    bytes8 = study.expand_words(_t(words))
    tW = torch.from_numpy(W)
    z = study.v7_i8decode(bytes8, tW)
    assert torch.equal(study.v7_i8decode_round2(bytes8, tW), z)
    with pltpu.force_tpu_interpret_mode():
        jb = br.expand_words(jnp.asarray(words))
        for fn in (br.v7_i8decode, bv.v7_i8decode):
            _close(z, fn(jb, jnp.asarray(W)))
    _close(z, jmv.axm_i8a_pallas(jnp.asarray(words), jnp.asarray(W)))
    _close(z, _np_products(words, W))


@pytest.mark.parametrize("nw,m,B", JAX_CASES)
def test_v8_atxm_vt_matches_jax(jax_round2, nw, m, B):
    """The plain v8_atxm_vt against JAX's v8_atxm_vt (forced interpret
    mode), atxm_i8a_pallas and float64."""
    br, _ = jax_round2
    rng = np.random.default_rng(3 * nw + m + B)
    words = _words(rng, nw, m)
    V = rng.standard_normal((4, 4 * nw, B)).astype(np.float32)
    av = study.v8_atxm_vt(_t(words), torch.from_numpy(V))
    assert av.shape == (m, B) and av.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        _close(av, br.v8_atxm_vt(jnp.asarray(words), jnp.asarray(V)))
    _close(av, jmv.atxm_i8a_pallas(jnp.asarray(words), jnp.asarray(V)))
    _close(av, _np_atxm(words, V))


@pytest.mark.parametrize("nw,m", DROPPED_SHAPES)
def test_every_row_at_shapes_jax_drops(nw, m):
    """At shapes where JAX's grids drop rows or markers, both plain
    versions against numpy float64 (no JAX value is pinned there)."""
    rng = np.random.default_rng(nw * 11 + m)
    words = _words(rng, nw, m)
    W = rng.standard_normal((m, 3)).astype(np.float32)
    V = rng.standard_normal((4, 4 * nw, 3)).astype(np.float32)
    bytes8 = study.expand_words(_t(words))
    for key in V7_KEYS:
        _close(getattr(study, key)(bytes8, torch.from_numpy(W)),
               _np_products(words, W))
    _close(study.v8_atxm_vt(_t(words), torch.from_numpy(V)),
           _np_atxm(words, V))


def test_wrappers_take_the_plain_versions_on_cpu_and_raise_elsewhere():
    """On the CPU each new wrapper returns its plain version's result (v7:
    axm_i8a's on the words its bytes came from, v8: atxm_i8a's) and counts
    no launch; a tensor on any other device takes the kernel route, which
    raises rather than falling back."""
    words = _t(_words(np.random.default_rng(5), 32, 1024))
    bytes8 = study.expand_words(words)
    W, V = torch.randn((1024, 3)), torch.randn((4, 128, 3))
    tmv.reset_launches()
    assert set(V7_KEYS) | {"v8_atxm_vt"} <= set(tmv.LAUNCHES)
    for key in V7_KEYS:
        assert torch.equal(getattr(study, key)(bytes8, W),
                           tmv.axm_i8a_ref(words, W))
        assert torch.equal(getattr(study, f"{key}_ref")(bytes8, W),
                           tmv.axm_i8a_ref(words, W))
    assert torch.equal(study.v8_atxm_vt(words, V), tmv.atxm_i8a_ref(words, V))
    assert set(tmv.LAUNCHES.values()) == {0}
    for call in (lambda: study.v7_i8decode(bytes8.to("meta"), W.to("meta")),
                 lambda: study.v7_i8decode_round2(bytes8.to("meta"),
                                                  W.to("meta")),
                 lambda: study.v8_atxm_vt(words.to("meta"), V.to("meta"))):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()
    assert set(tmv.LAUNCHES.values()) == {0}


def test_bound_of_the_round2_kernels():
    """v7 (both keys) is charged as axm_i8a, v8 as atxm_i8a: the 10.74 GB
    of words (v7's byte rows are the same bytes) and the f32 columns at
    3.35 TB/s, about 3.21 ms at config B and B = 2."""
    nw, m = 20_480, 131_072
    for name, lib in (("v7_i8decode", "axm_i8a"),
                      ("v7_i8decode_round2", "axm_i8a"),
                      ("v8_atxm_vt", "atxm_i8a")):
        assert common.STUDY_PRODUCTS[name] == lib
        for B in (1, 2, 64):
            assert common.bound(name, nw, m, B) == common.bound(lib, nw, m, B)
        ms, by = common.bound(name, nw, m, 2)
        assert by == "bytes" and 3.2 < ms < 3.23, (name, ms)


def test_bench_round2_runs_on_cpu(capsys):
    from gvamp_tpu_torch.tools import bench_round2
    assert bench_round2.main(["--device", "cpu", "8", "1024", "1"]) == 0
    out = capsys.readouterr().out
    rows = [ln for ln in out.splitlines() if ln.endswith("GB/s")]
    assert len(rows) == 4
    for name in ("atxm_i8a B=2 (prod)", "v8_atxm_vt B=2",
                 "axm_i8a B=2 (prod)", "v7_i8decode B=2"):
        assert f"\n{name} " in out, name
    assert "v8_atxm_vt equal to atxm_i8a, v7_i8decode to axm_i8a" in out
    assert "FAULT" not in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            bench_round2.main([])


@pytest.mark.parametrize("name,ref", [("v8_atxm_vt", "v8_atxm_vt_ref"),
                                      ("v7_i8decode_round2",
                                       "v7_i8decode_round2_ref")])
def test_bench_round2_fails_when_a_kernel_differs(capsys, monkeypatch, name,
                                                  ref):
    """A kernel whose result is one off anywhere makes the tool name it and
    return 1."""
    from gvamp_tpu_torch.tools import bench_round2
    plain = getattr(study, ref)

    def off_by_one(*args):
        z = plain(*args).clone(memory_format=torch.contiguous_format)
        z.view(-1)[-1] += 1
        return z

    monkeypatch.setattr(study, name, off_by_one)
    assert bench_round2.main(["--device", "cpu", "8", "1024", "1"]) == 1
    out = capsys.readouterr().out
    short = name.replace("_round2", "")
    assert f"FAULT {short}: differs from its plain version" in out
    lib = "atxm_i8a" if name == "v8_atxm_vt" else "axm_i8a"
    assert f"FAULT {short}: differs from {lib}" in out


# the JAX function each of chip_smoke's REPLACES keys names, where it is
# not the key itself (the library kernels: <key>_pallas)
JAX_NAMES = {"axm_bf16": "axm_pallas", "atxm_bf16": "atxm_pallas",
             "v7_i8decode_round2": "v7_i8decode"}
# the JAX package's files with Pallas kernels
PALLAS_FILES = ("gvamp_tpu/ops/matvec.py", "tools/bench_stream.py",
                "tools/bench_variants.py", "tools/bench_round2.py")


def test_chip_smoke_replaces_names_each_tpu_kernel(monkeypatch):
    """chip_smoke's REPLACES has one row for each of the 25 functions of the
    JAX package whose body reaches pl.pallas_call (14 in matvec.py, 11 under
    tools/), and each row names the line of its file that reads
    ``def <function>(``."""
    monkeypatch.syspath_prepend(REPO)
    smoke = importlib.import_module("chip_smoke")
    pallas = set()
    for path in PALLAS_FILES:
        src = open(os.path.join(REPO, path)).read()
        for part in re.split(r"\n(?=def |@)", src):
            if part.startswith("def ") and "pl.pallas_call(" in part:
                pallas.add((path, re.match(r"def (\w+)\(", part).group(1)))
    named = set()
    for key, where in smoke.REPLACES.items():
        path, line = where.rsplit(":", 1)
        fn = JAX_NAMES.get(key, key if path.startswith("tools/")
                           else f"{key}_pallas")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith(f"def {fn}("), (key, where, text)
        named.add((path, fn))
    assert len(smoke.REPLACES) == len(named) == len(pallas) == 25
    assert named == pallas
    assert set(V7_KEYS) | {"v8_atxm_vt"} <= set(smoke.STUDY)
