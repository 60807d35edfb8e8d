"""The port's data layer (gvamp_tpu_torch/data.py) against the JAX
package's GenoBed: the same .bed bytes give the same words, statistics,
completeness and products (JAX f32 through the Pallas kernels in interpret
mode, f64 through XLA)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink
from gvamp_tpu_torch import data as tdata
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from helpers import DenseOracle, random_dataset
from test_data_layer import make_bed

torch.set_num_threads(1)

# f32 statistics: both sides form the moments with compensated two-sum over
# N chunks (1-ulp sums) and differ only in the order inside a chunk, so
# mave/msig agree to a few f32 ulps.  f64: 1e-10, as the JAX tests hold
# JAX's own f64 statistics against the dense oracle.
STATS_TOL = {torch.float32: 2e-6, torch.float64: 1e-10}
# f32 products: the same digits and exact integer products on both sides,
# folded in another order -> a few ulps of the largest entry.  f64: true-f64
# contractions on both sides.
PRODUCT_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}


def _complete_dataset(rng, N, M):
    codes = rng.choice([0, 2, 3], size=(M, N)).astype(np.uint8)  # no code 1
    y = rng.normal(2.0, 3.0, size=N)
    y[rng.choice(N, 9, replace=False)] = np.nan  # phenotype NAs still exist
    return codes, y


def _pair(codes, y, N, dt):
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt)
    return j, t


def _close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * (np.abs(want).max() + 1e-30))


def test_words_byte_identical(tmp_path):
    """From the same .bed bytes (in memory and on disk) the port's words
    hold the JAX container's bits."""
    rng = np.random.default_rng(0)
    N, M = 203, 77
    codes, y = random_dataset(rng, N, M)
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N)
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N)
    want = np.asarray(j.words)
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32), want)
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    tf = TGenoBed.from_files(bed, phen, N=N, Mt=M)
    np.testing.assert_array_equal(tf.words.numpy().view(np.uint32), want)
    assert (tf.Mpad, tf.nonas) == (j.Mpad, j.nonas)
    np.testing.assert_allclose(tf.scale, j.scale, rtol=1e-12)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,M", [(61, 33), (1000, 40)])
def test_marker_stats_match_jax_and_oracle(N, M, dt):
    rng = np.random.default_rng(42)
    codes, y = random_dataset(rng, N, M)
    j, t = _pair(codes, y, N, dt)
    assert t.mave.dtype == dt
    _close(t.mave, j.mave, STATS_TOL[dt])
    _close(t.msig, j.msig, STATS_TOL[dt])
    oracle = DenseOracle(codes, y)
    np.testing.assert_allclose(t.mave.numpy()[:M], oracle.mave,
                               rtol=STATS_TOL[dt])
    np.testing.assert_allclose(t.msig.numpy()[:M], oracle.msig,
                               rtol=STATS_TOL[dt])
    assert np.all(t.mave.numpy()[M:] == 0) and np.all(t.msig.numpy()[M:] == 0)


@pytest.mark.parametrize("miss", [0.0, 0.05])
def test_geno_complete_matches_jax(miss):
    rng = np.random.default_rng(7)
    codes, y = random_dataset(rng, 130, 40, miss_geno=miss)
    for dt in (torch.float32, torch.float64):
        j, t = _pair(codes, y, 130, dt)
        assert t.geno_complete == j.geno_complete == (miss == 0.0)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_products_match_jax(dt):
    """ax/atx/axm/atxm with standardisation, NA masking and 1/sqrt(N)
    against the JAX container's fns / fns_multi."""
    rng = np.random.default_rng(29)
    N, M, B = 130, 40, 3
    codes, y = _complete_dataset(rng, N, M)
    j, t = _pair(codes, y, N, dt)
    assert t.geno_complete
    m_mask = t.m_mask.numpy()
    x = rng.normal(size=t.Mpad) * m_mask
    X = rng.normal(size=(t.Mpad, B)) * m_mask[:, None]
    v = t.layout.planarize(rng.normal(size=N))
    V = np.stack([t.layout.planarize(rng.normal(size=N)) for _ in range(B)],
                 axis=-1)
    tol = PRODUCT_TOL[dt]
    jd = JAX_DTYPE[dt]

    def T(a):
        return torch.as_tensor(a, dtype=dt)

    _close(t.ax(T(x)), j.ax(jnp.asarray(x, jd)), tol)
    _close(t.atx(T(v)), j.atx(jnp.asarray(v, jd)), tol)
    _close(t.axm(T(X)), j.axm(jnp.asarray(X, jd)), tol)
    _close(t.atxm(T(V)), j.atxm(jnp.asarray(V, jd)), tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_products_match_jax_missing(dt):
    """ax/atx/axm/atxm on genotypes with 5% missing calls (the general
    branches: axm_i8/atxm_i8 in f32, the dense products in f64) against
    the JAX container's; N = 131 is not a multiple of 16, so padding
    samples (code 01) sit inside the last word row."""
    rng = np.random.default_rng(31)
    N, M, B = 131, 40, 3
    codes, y = random_dataset(rng, N, M, miss_geno=0.05)
    j, t = _pair(codes, y, N, dt)
    assert not t.geno_complete and not j.geno_complete
    m_mask = t.m_mask.numpy()
    x = rng.normal(size=t.Mpad) * m_mask
    X = rng.normal(size=(t.Mpad, B)) * m_mask[:, None]
    v = t.layout.planarize(rng.normal(size=N))
    V = np.stack([t.layout.planarize(rng.normal(size=N)) for _ in range(B)],
                 axis=-1)
    tol = PRODUCT_TOL[dt]
    jd = JAX_DTYPE[dt]

    def T(a):
        return torch.as_tensor(a, dtype=dt)

    _close(t.ax(T(x)), j.ax(jnp.asarray(x, jd)), tol)
    _close(t.atx(T(v)), j.atx(jnp.asarray(v, jd)), tol)
    _close(t.axm(T(X)), j.axm(jnp.asarray(X, jd)), tol)
    _close(t.atxm(T(V)), j.atxm(jnp.asarray(V, jd)), tol)
    # and the dense f64 oracle of the standardised operator
    oracle = DenseOracle(codes, y)
    want = oracle.A.T @ x[:M] * oracle.na
    np.testing.assert_allclose(t.deplanarize(t.ax(T(x)))[:N], want, rtol=0,
                               atol=tol * 10 * np.abs(want).max())


def test_chromosomes_match_jax(tmp_path):
    """chromosomes() reads the .bim ('X' as 23) for the owned marker range,
    as the JAX container does; without a .bim it raises."""
    rng = np.random.default_rng(8)
    N, M = 64, 24
    codes, y = random_dataset(rng, N, M)
    bim = str(tmp_path / "d.bim")
    chroms = np.repeat(np.arange(1, 7), M // 6)
    plink.write_bim(bim, chroms)
    with open(bim) as f:
        lines = f.readlines()
    lines[-1] = "X" + lines[-1][lines[-1].index(" "):]
    with open(bim, "w") as f:
        f.writelines(lines)
    bed = make_bed(codes)
    j = JGenoBed.from_arrays(bed[4:16], y, N=N, Mt=M, S=4, bim_path=bim)
    t = TGenoBed.from_arrays(bed[4:16], y, N=N, Mt=M, S=4, bim_path=bim)
    np.testing.assert_array_equal(t.chromosomes(), j.chromosomes())
    assert list(t.chromosomes()) == list(chroms[4:16])
    full = TGenoBed.from_arrays(bed, y, N=N, bim_path=bim)
    assert full.chromosomes()[-1] == 23
    with pytest.raises(ValueError, match="no .bim"):
        TGenoBed.from_arrays(bed, y, N=N).chromosomes()


def test_float64_on_cuda_raises():
    """f64 has no kernel: a CUDA container in f64 is refused up front."""
    with pytest.raises(NotImplementedError, match="float64 on CUDA"):
        tdata._check_placement(torch.device("cuda"), torch.float64)
    tdata._check_placement(torch.device("cuda"), torch.float32)


def test_set_phen_and_helpers_match_jax():
    rng = np.random.default_rng(9)
    N, M = 97, 29
    codes, _ = _complete_dataset(rng, N, M)
    j, t = _pair(codes, rng.normal(size=N), N, torch.float64)
    y = rng.normal(size=N)
    y[:5] = np.nan
    j.set_phen(y, standardize=True)
    t.set_phen(y, standardize=True)
    assert (t.nonas, t.intercept) == (j.nonas, j.intercept)
    _close(t.filter_pheno(), j.filter_pheno(), 1e-14)
    _close(t.mave, j.mave, 1e-10)
    _close(t.msig, j.msig, 1e-10)
    np.testing.assert_array_equal(t.n_mask_planar.numpy(),
                                  np.asarray(j.n_mask_planar))
    np.testing.assert_array_equal(t.m_mask.numpy(), np.asarray(j.m_mask))
    np.testing.assert_array_equal(t.deplanarize(t.planarize(y[:N] * 0 + 1.5)),
                                  j.deplanarize(j.planarize(y[:N] * 0 + 1.5)))
    np.testing.assert_array_equal(t.pad_m(np.arange(M)).numpy(),
                                  np.asarray(j.pad_m(np.arange(M))))
