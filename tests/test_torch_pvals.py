"""The port's LOO / LOCO p-values (gvamp_tpu_torch/ops/pvals.py) against
the JAX package's (gvamp_tpu/ops/pvals.py) on the same genotypes with
missing calls, the same z1 = A x1 and the same x1, compared in log10 p.
JAX runs f32 through the Pallas kernels in interpret mode and f64 through
XLA."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.ops import pvals as jpv
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.ops import pvals as tpv
from helpers import random_dataset
from test_data_layer import make_bed

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}
# |log10 p_port - log10 p_jax|.  f64: the same float64 sums in another
# order (~1e-15 relative) through the same host t-test (1e-13 seen).  f32:
# the moments are compensated f32 sums whose order inside an N-chunk
# differs, and the marker statistics differ by a few f32 ulps
# (tests/test_torch_data.py), which the regression's cancellation
# amplifies (2e-6 seen).
LOG10P_TOL = {torch.float64: 1e-11, torch.float32: 2e-5}
# LOCO predictors: f64 true-f64 products; f32 digit products folded in
# another order (test_torch_data.PRODUCT_TOL), relative to max |y_chrom|
PRED_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
N, M = 300, 40          # N not a multiple of 16: padding inside a word row


def _setup(dt, seed):
    rng = np.random.default_rng(seed)
    codes, y = random_dataset(rng, N, M, miss_geno=0.05, miss_phen=0.08)
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt, device="cpu")
    assert not t.geno_complete and not j.geno_complete
    x1 = rng.normal(size=t.Mpad) * t.m_mask.numpy() * 0.1
    z1 = np.array(j.ax(jnp.asarray(x1, JAX_DTYPE[dt])))
    return rng, j, t, x1, z1


def _log10_close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.all((got > 0) & (got <= 1))
    np.testing.assert_allclose(np.log10(got), np.log10(want), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_loo_pvals_match_jax(dt):
    _, j, t, x1, z1 = _setup(dt, 0)
    got = tpv.loo_pvals(t, torch.as_tensor(z1, dtype=dt),
                        torch.as_tensor(x1, dtype=dt))
    want = jpv.loo_pvals(j, jnp.asarray(z1, JAX_DTYPE[dt]),
                         jnp.asarray(x1, JAX_DTYPE[dt]))
    _log10_close(got, want, LOG10P_TOL[dt])
    assert got.shape == (M,)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_loo_pvals_multi_match_jax(dt):
    """Three estimates in one pass: each row equals the port's single call
    bit for bit and matches JAX's batched call."""
    rng, j, t, _, _ = _setup(dt, 1)
    E = 3
    x1s = rng.normal(size=(t.Mpad, E)) * t.m_mask.numpy()[:, None] * 0.1
    z1s = np.stack([np.array(j.ax(jnp.asarray(x1s[:, e], JAX_DTYPE[dt])))
                    for e in range(E)], axis=-1)
    got = tpv.loo_pvals_multi(t, torch.as_tensor(z1s, dtype=dt),
                              torch.as_tensor(x1s, dtype=dt))
    want = jpv.loo_pvals_multi(j, jnp.asarray(z1s, JAX_DTYPE[dt]),
                               jnp.asarray(x1s, JAX_DTYPE[dt]))
    assert got.shape == (E, M)
    for e in range(E):
        _log10_close(got[e], want[e], LOG10P_TOL[dt])
        single = tpv.loo_pvals(t, torch.as_tensor(z1s[..., e], dtype=dt),
                               torch.as_tensor(x1s[:, e], dtype=dt))
        np.testing.assert_array_equal(got[e], single)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_loco_pvals_match_jax(dt):
    """Four chromosomes: p-values in log10 and every chromosome's
    predictor y_chrom (passed to predictor_cb) against JAX's."""
    _, j, t, x1, z1 = _setup(dt, 3)
    chroms = np.repeat(np.arange(1, 5), M // 4)
    preds_t, preds_j = {}, {}
    got = tpv.loco_pvals(
        t, torch.as_tensor(z1, dtype=dt), torch.as_tensor(x1, dtype=dt),
        chroms, predictor_cb=lambda ch, yc: preds_t.__setitem__(ch, yc))
    want = jpv.loco_pvals(
        j, jnp.asarray(z1, JAX_DTYPE[dt]), jnp.asarray(x1, JAX_DTYPE[dt]),
        chroms, predictor_cb=lambda ch, yc: preds_j.__setitem__(
            ch, np.asarray(yc)))
    _log10_close(got, want, LOG10P_TOL[dt])
    assert set(preds_t) == set(preds_j) == {1, 2, 3, 4}
    for ch in preds_j:
        want_p = preds_j[ch]
        np.testing.assert_allclose(
            preds_t[ch].numpy(), want_p, rtol=0,
            atol=PRED_TOL[dt] * np.abs(want_p).max())
    # LOCO differs from LOO: each chromosome's own predictor is added back
    loo = tpv.loo_pvals(t, torch.as_tensor(z1, dtype=dt),
                        torch.as_tensor(x1, dtype=dt))
    assert not np.allclose(got, loo)


def test_loco_without_chromosomes_gives_ones():
    """No marker on chromosomes 1-23: every LOCO p-value is 1, as JAX's."""
    _, j, t, x1, z1 = _setup(torch.float64, 4)
    chroms = np.zeros(M, dtype=np.int32)
    got = tpv.loco_pvals(t, torch.as_tensor(z1), torch.as_tensor(x1), chroms)
    want = jpv.loco_pvals(j, jnp.asarray(z1), jnp.asarray(x1), chroms)
    np.testing.assert_array_equal(got, np.ones(M))
    np.testing.assert_array_equal(want, np.ones(M))


def test_moments_ignore_the_global_tf32_setting():
    """_moments switches TF32 off for its products and restores the global
    setting (on the CPU TF32 never applies; the flag is what is checked)."""
    _, _, t, _, _ = _setup(torch.float32, 5)
    prev = torch.backends.cuda.matmul.allow_tf32
    seen = []
    real_einsum = torch.einsum

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real_einsum(*args)

    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.einsum = spy
        vecs = torch.stack([t.na_planar, t.filter_pheno()])
        out = tpv._moments(t.words, vecs, t.na_planar, block=256)
    finally:
        torch.einsum = real_einsum
        after = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen and not any(seen)
    assert after is True
    assert all(torch.isfinite(x).all() for x in out)
