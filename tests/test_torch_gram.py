"""The port's fused primal Gram (gvamp_tpu_torch/ops/matvec.py gram_i8a /
gram_i8 and GenoBed.fn_gram) against the JAX package: the plain versions
against gram_i8a_pallas / gram_i8_pallas in interpret mode at the port's
band height (tnw=GRAM_BAND_NW), against the port's own two-pass
composition, and the routing of fn_gram.  On the CPU the wrappers run the
plain versions; chip_smoke.py holds the CUDA kernels to them bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.ops import matvec as jmv
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.ops import matvec as tmv
from helpers import random_dataset
from test_data_layer import make_bed

torch.set_num_threads(1)

# (Nw, Mpad, B, per-column mask): B=70 takes both packages' column chunking
# (64 columns for gram_i8a, 32 for gram_i8)
CASES = [(32, 256, 1, False), (64, 512, 3, True), (32, 512, 70, False),
         (64, 256, 70, True), (64, 256, 1, True), (32, 512, 3, False)]
# against the Pallas kernels: the same digits, bands and exact integer
# products, folded and summed in another order (XLA's f32 reductions and
# FMA contraction against the port's separate roundings): measured up to
# 1.8e-7 of the largest entry at these cases
PALLAS_TOL = 1e-6
# against the two-pass composition: z is requantised per 16-row band here
# and per column there, each ~127^-4 fine (tests/test_data_layer.py:357-377)
TWO_PASS_TOL = 5e-6


def _inputs(nw, m, B, per_col, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(nw, m),
                         dtype=np.uint64).astype(np.uint32)
    W = rng.standard_normal((m, B)).astype(np.float32)
    U = (rng.standard_normal((m, B)) * 2).astype(np.float32)
    shape = (4, 4 * nw, B) if per_col else (4, 4 * nw)
    na = (rng.random(shape) > 0.1).astype(np.float32)
    cu = rng.standard_normal(B).astype(np.float32)
    return words, W, U, na, cu


def _t(x):
    x = np.asarray(x)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(x.copy())


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("nw,m,B,per_col", CASES)
def test_gram_i8a_ref_matches_pallas(nw, m, B, per_col):
    words, W, _, na, cu = _inputs(nw, m, B, per_col, 1)
    av_j, sv_j = jmv.gram_i8a_pallas(jnp.asarray(words), jnp.asarray(W),
                                     jnp.asarray(na), jnp.asarray(cu),
                                     tnw=tmv.GRAM_BAND_NW)
    av_t, sv_t = tmv.gram_i8a(_t(words), _t(W), _t(na), _t(cu))
    assert av_t.shape == (m, B) and sv_t.shape == (B,)
    _close(av_t, av_j, PALLAS_TOL)
    _close(sv_t, sv_j, PALLAS_TOL)


@pytest.mark.parametrize("nw,m,B,per_col", CASES)
def test_gram_i8_ref_matches_pallas(nw, m, B, per_col):
    words, W, U, na, _ = _inputs(nw, m, B, per_col, 2)
    a_j, b_j = jmv.gram_i8_pallas(jnp.asarray(words), jnp.asarray(W),
                                  jnp.asarray(U), jnp.asarray(na),
                                  tnw=tmv.GRAM_BAND_NW)
    a_t, b_t = tmv.gram_i8(_t(words), _t(W), _t(U), _t(na))
    assert a_t.shape == b_t.shape == (m, B)
    _close(a_t, a_j, PALLAS_TOL)
    _close(b_t, b_j, PALLAS_TOL)


@pytest.mark.parametrize("nw,m,B,per_col", CASES[:4])
def test_gram_refs_match_two_pass(nw, m, B, per_col):
    """Both fused forms against atxm(na (axm(.))) of the port's own plain
    products, the composition fn_gram replaces."""
    words, W, U, na, cu = _inputs(nw, m, B, per_col, 3)
    tw, tW, tU, tna, tcu = map(_t, (words, W, U, na, cu))
    mask = tmv._mask_cols(tna, B)
    z = (tmv.axm_i8a_ref(tw, tW) - tcu) * mask
    av, sv = tmv.gram_i8a(tw, tW, tna, tcu)
    _close(av, tmv.atxm_i8a_ref(tw, z), TWO_PASS_TOL)
    _close(sv, z.sum(dim=(0, 1)), TWO_PASS_TOL)
    z = tmv.axm_i8_ref(tw, tW, tU) * mask
    for got, want in zip(tmv.gram_i8(tw, tW, tU, tna),
                         tmv.atxm_i8_ref(tw, z)):
        _close(got, want, TWO_PASS_TOL)


def test_band_height_and_budget():
    """The band is one named constant (Nw must hold whole bands); a block
    takes at most GRAM_MAX_QUADS marker quads, whose ring of GRAM_RING band
    tiles fits the shared-memory budget: Mpad up to 135,168 on 132 SMs
    (config B's 131,072 fits, in 224,224 bytes)."""
    assert tmv.GRAM_BAND_NW == 16 and tmv.GRAM_RING == 3
    words = torch.zeros((40, 512), dtype=torch.int32)
    with pytest.raises(ValueError, match="band"):
        tmv.gram_i8a_ref(words, torch.ones((512, 1)),
                         torch.ones((4, 160)), torch.zeros(1))
    def fits(m):
        return tmv.gram_fits(torch.empty((32, m), dtype=torch.int32,
                                         device="meta"))
    assert fits(131_072) and fits(135_168) and not fits(135_172)
    assert tmv.gram_smem_bytes(131_072, 132) == 224_224
    assert tmv.gram_smem_bytes(135_168, 132) <= tmv.GRAM_AAT_SMEM_BUDGET
    meta = torch.empty((32, 240_000), dtype=torch.int32, device="meta")
    assert not tmv.gram_fits(meta)
    assert tmv.gram_fits(torch.empty((32, 131_072), dtype=torch.int32,
                                     device="meta"))


def test_gram_wrappers_refuse_non_cpu_tensors_without_a_kernel():
    """On a device that is neither the CPU nor CUDA the wrappers raise (no
    fallback to the plain versions), and nothing is counted."""
    tmv.reset_launches()
    meta = torch.empty((32, 512), dtype=torch.int32, device="meta")
    W = torch.ones((512, 1), device="meta")
    na = torch.ones((4, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.gram_i8a(meta, W, na, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tmv.gram_i8(meta, W, W, na)
    assert tmv.LAUNCHES["gram_i8a"] == tmv.LAUNCHES["gram_i8"] == 0


# fn_gram against JAX's fn_gram: the same plain-vs-Pallas difference as
# PALLAS_TOL, then the mave/msig corrections (a cancelling subtraction on
# complete genotypes) on both sides
FN_GRAM_TOL = 1e-5


@pytest.mark.parametrize("miss", [0.0, 0.05])
def test_fn_gram_matches_jax(miss, monkeypatch):
    """A^T A X through fn_gram with phenotype NAs, complete genotypes
    (gram_i8a) and missing calls (gram_i8), against JAX's fn_gram, both
    under GVAMP_FUSED_GRAM=1; and against the port's two-pass form."""
    monkeypatch.setenv("GVAMP_FUSED_GRAM", "1")
    rng = np.random.default_rng(29)
    N, M, B = 500, 300, 2
    codes, y = random_dataset(rng, N, M, miss_geno=miss)
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float32,
                             backend="pallas")
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, device="cpu")
    assert t.geno_complete == (miss == 0.0)
    X = rng.standard_normal((t.Mpad, B)).astype(np.float32)
    jg, tg = j.fn_gram(), t.fn_gram()
    assert jg is not None and tg is not None
    got = tg(t.op, torch.from_numpy(X))
    _close(got, jg(j.op, jnp.asarray(X)), FN_GRAM_TOL)
    axm_fn, atxm_fn = t.fns_multi()
    _close(got, atxm_fn(t.op, axm_fn(t.op, torch.from_numpy(X))),
           FN_GRAM_TOL)


def test_fn_gram_routing(monkeypatch):
    """fn_gram is off by default and under GVAMP_NO_FUSED_GRAM=1, None in
    float64 and above the band tiles' budget; else gram_i8a on complete
    genotypes and gram_i8 on genotypes with missing calls (the routing of
    tests/test_round4.py:60-70)."""
    rng = np.random.default_rng(5)
    codes = rng.choice([0, 2, 3], size=(40, 64)).astype(np.uint8)
    y = rng.normal(size=64)
    t = TGenoBed.from_arrays(make_bed(codes), y, N=64, device="cpu")
    monkeypatch.delenv("GVAMP_FUSED_GRAM", raising=False)
    assert t.fn_gram() is None
    monkeypatch.setenv("GVAMP_FUSED_GRAM", "1")
    assert t.fn_gram() is not None
    monkeypatch.setenv("GVAMP_NO_FUSED_GRAM", "1")
    assert t.fn_gram() is None
    monkeypatch.delenv("GVAMP_NO_FUSED_GRAM")
    assert TGenoBed.from_arrays(make_bed(codes), y, N=64, device="cpu",
                                dtype=torch.float64).fn_gram() is None
    calls = []
    for name in ("gram_i8a", "gram_i8"):
        monkeypatch.setattr(
            tmv, name,
            lambda *a, _n=name: calls.append(_n) or (a[1], a[1][0]))
    X = torch.zeros((t.Mpad, 1))
    t.fn_gram()(t.op, X)
    codes_m, y_m = random_dataset(rng, 64, 40, miss_geno=0.05)
    tm = TGenoBed.from_arrays(make_bed(codes_m), y_m, N=64, device="cpu")
    tm.fn_gram()(tm.op, X)
    assert calls == ["gram_i8a", "gram_i8"]
    for m, fits in ((134_656, True), (135_680, False)):
        words = torch.full((32, m), 0x55555555, dtype=torch.int32)
        g = TGenoBed.from_device_words(words, np.zeros(512), N=512,
                                       standardize_phen=False,
                                       mave=np.zeros(m), msig=np.ones(m))
        g._complete = True
        assert (g.fn_gram() is not None) == fits
