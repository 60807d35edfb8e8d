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
from gvamp_tpu_torch import dist
from gvamp_tpu_torch.ops import matvec as tmv
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from helpers import DenseOracle, random_dataset
from test_data_layer import make_bed

torch.set_num_threads(1)

# f32 statistics: the port's sums are exact integer counts and JAX's
# compensated two-sum over N chunks (1-ulp sums) ends on the same sums;
# the two formulas then differ in the order of a few f32 operations, so
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
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt, device="cpu")
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
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, device="cpu")
    want = np.asarray(j.words)
    np.testing.assert_array_equal(t.words.numpy().view(np.uint32), want)
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    tf = TGenoBed.from_files(bed, phen, N=N, Mt=M, device="cpu")
    np.testing.assert_array_equal(tf.words.numpy().view(np.uint32), want)
    assert (tf.Mpad, tf.nonas) == (j.Mpad, j.nonas)
    np.testing.assert_allclose(tf.scale, j.scale, rtol=1e-12)


# layouts of the statistics pass: two plain ones, then those where a pass
# with divisor rules faltered (Nw = 224, Nw/32 = 7 a prime; Mpad = 512*5;
# three mesh slabs of 512 markers) and a marker with no call beside a
# person plane with no phenotype
STATS_LAYOUTS = [pytest.param(61, 33, {}, id="61-33"),
                 pytest.param(1000, 40, {}, id="1000-40"),
                 pytest.param(3584, 40, {}, id="nw224"),
                 pytest.param(200, 2560, {}, id="mpad2560"),
                 pytest.param(300, 1100, {"shards": 3}, id="slabs3"),
                 pytest.param(130, 40, {"holes": True}, id="holes")]


def _stats_dataset(N, M, holes=False):
    codes, y = random_dataset(np.random.default_rng(42), N, M)
    if holes:
        codes[3] = 1          # marker 3: every call missing
        y[1::4] = np.nan      # planar plane k = 1: every phenotype NA
    return codes, y


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,M,kw", STATS_LAYOUTS)
def test_marker_stats_match_jax_and_oracle(N, M, kw, dt):
    codes, y = _stats_dataset(N, M, kw.get("holes", False))
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    mesh = dist.Mesh(kw["shards"], "cpu") if "shards" in kw else None
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt, device="cpu",
                             mesh=mesh)
    assert t.Mpad == j.Mpad
    assert t.mave.dtype == dt
    _close(t.mave, j.mave, STATS_TOL[dt])
    _close(t.msig, j.msig, STATS_TOL[dt])
    oracle = DenseOracle(codes, y)
    np.testing.assert_allclose(t.mave.numpy()[:M], oracle.mave,
                               rtol=STATS_TOL[dt])
    np.testing.assert_allclose(t.msig.numpy()[:M], oracle.msig,
                               rtol=STATS_TOL[dt])
    assert np.all(t.mave.numpy()[M:] == 0) and np.all(t.msig.numpy()[M:] == 0)


# set bits of each byte value
_BYTE_POPC = np.array([bin(v).count("1") for v in range(256)], np.int64)


def _popc(x: np.ndarray) -> np.ndarray:
    """Set bits of each uint32 of ``x``, summed over its four bytes."""
    x = np.ascontiguousarray(x, dtype=np.uint32)
    return _BYTE_POPC[x.view(np.uint8)].reshape(*x.shape, 4).sum(-1)


def _kernel_counts(words: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """What ``csrc/counts.cu`` computes, in numpy: per word and mask word
    n2, n1, nb by its three bit identities, then (S_a, S_b, S_aa)."""
    w = words.astype(np.uint32)
    m = (mask.astype(np.uint32) & np.uint32(0x55555555))[:, None]
    hi = w >> np.uint32(1)
    n2 = _popc(m & ~w & ~hi).sum(0)
    n1 = _popc(m & ~w & hi).sum(0)
    nb = _popc(m & (~w | hi)).sum(0)
    return np.stack([2 * n2 + n1, nb, 4 * n2 + n1])


def test_count_identities_match_the_decode_tables():
    """The count kernel's three bit identities give ``matvec._swar``'s
    dosage a, a**2 and indicator b for every byte value, at every bit pair
    and byte of a word, under a mask of that one field."""
    x = torch.arange(256, dtype=torch.int32)
    for j in range(4):
        w = x << (8 * j)
        for k in range(4):
            a, b = tmv._swar(w, k)
            a = ((a >> (8 * j)) & 0xFF).numpy()
            b = ((b >> (8 * j)) & 0xFF).numpy()
            mask = np.full(1, 1 << (8 * j + 2 * k))
            got = _kernel_counts(w.numpy()[None, :], mask)
            np.testing.assert_array_equal(got, np.stack([a, b, a * a]))


# (N, first marker, last marker) of the words the counts read: Nw/32 = 7
# (a prime), a width of 512*5, a ragged width at an odd offset, the second
# slab of a two-slab mesh, and the marker with no call beside the plane
# with no phenotype
COUNT_LAYOUTS = [pytest.param(3584, 0, 40, False, id="nw224"),
                 pytest.param(200, 0, 2560, False, id="mpad2560"),
                 pytest.param(131, 3, 2560 - 3, False, id="ragged"),
                 pytest.param(300, 512, 1024, False, id="slab"),
                 pytest.param(130, 0, 40, True, id="holes")]


@pytest.mark.parametrize("N,lo,hi,holes", COUNT_LAYOUTS)
def test_marker_counts_are_exact(N, lo, hi, holes):
    """The statistics pass's counts S_a, S_b, S_aa (the plain version,
    ``marker_counts`` on the CPU) equal numpy's integer sums over the codes
    and the NA mask, at widths and row counts no block divides; the count
    kernel's bit identities over ``na_mask_words`` give the same counts."""
    M = min(hi, 2500)
    codes, y = _stats_dataset(N, M, holes)
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=torch.float64,
                             device="cpu")
    oracle = DenseOracle(codes, y)
    na = oracle.na.astype(np.int64)[None, :]
    a, b = oracle.a.astype(np.int64), oracle.b.astype(np.int64)
    want = np.zeros((3, t.Mpad), np.int64)
    want[:, :M] = [(a * na).sum(1), (b * na).sum(1), (a * a * na).sum(1)]
    want = want[:, lo:hi]
    words = t.words[:, lo:hi]
    got = tmv.marker_counts(words, t.na_planar)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    mask = tmv.na_mask_words(t.na_planar).numpy()
    np.testing.assert_array_equal(_kernel_counts(words.numpy(), mask), want)
    if holes:
        assert want[:, 3].tolist() == [0, 0, 0]


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
    t = TGenoBed.from_arrays(bed[4:16], y, N=N, Mt=M, S=4, bim_path=bim,
                             device="cpu")
    np.testing.assert_array_equal(t.chromosomes(), j.chromosomes())
    assert list(t.chromosomes()) == list(chroms[4:16])
    full = TGenoBed.from_arrays(bed, y, N=N, bim_path=bim, device="cpu")
    assert full.chromosomes()[-1] == 23
    with pytest.raises(ValueError, match="no .bim"):
        TGenoBed.from_arrays(bed, y, N=N, device="cpu").chromosomes()


def test_float64_on_cuda_raises():
    """f64 has no kernel: a CUDA container in f64 is refused up front."""
    with pytest.raises(NotImplementedError, match="float64 on CUDA"):
        tdata._check_placement(torch.device("cuda"), torch.float64)
    tdata._check_placement(torch.device("cuda"), torch.float32)


def test_entry_points_default_to_the_card(tmp_path):
    """GenoBed.from_arrays, GenoBed.from_files and convert.geno_from_numpy
    put the container on CUDA unless the caller names another device; a
    call that names none on a machine without a card raises, it never runs
    on the CPU quietly."""
    import inspect
    from gvamp_tpu_torch import convert
    for fn in (TGenoBed.from_arrays, TGenoBed.from_files,
               convert.geno_from_numpy):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    rng = np.random.default_rng(3)
    codes, y = _complete_dataset(rng, 40, 12)
    bed = str(tmp_path / "d.bed")
    plink.write_bed(bed, codes)
    calls = [lambda: TGenoBed.from_arrays(make_bed(codes), y, N=40),
             lambda: TGenoBed.from_files(bed, None, N=40, Mt=12),
             lambda: convert.geno_from_numpy(
                 np.full((32, 512), 0x55555555, np.uint32), y, N=40,
                 mave=np.zeros(512), msig=np.ones(512))]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


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


# People statistics: sum_v and numb through ax (f32: ax's plain version
# against ax_pallas, f32 sums of the same products in another order; f64:
# true f64 on both sides) and sumsq in f32 on both sides for every dtype,
# as JAX computes it.  mave_p sums centred values and msig_p's denominator
# sumsq - n mave_p^2 cancels, so both carry f32 sum-order error: measured
# up to 1.2e-6 (f32 mave_p) and 1e-7 (msig_p, either dtype) of the largest
# entry at these sizes.  numb_p is an integer count, equal.
PEOPLE_TOL = {torch.float32: 1e-5, torch.float64: 1e-5}


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("miss", [0.0, 0.05])
def test_people_statistics_match_jax(dt, miss):
    """(mave_p, msig_p, numb_p) and the dual Jacobi base against the JAX
    container's compute_people_statistics and make_aux, with phenotype
    NAs; numb_p counts exactly."""
    from gvamp_tpu import linear as jlinear
    from gvamp_tpu_torch import linear as tlinear
    rng = np.random.default_rng(17)
    N, M = 131, 300
    codes, y = random_dataset(rng, N, M, miss_geno=miss)
    j, t = _pair(codes, y, N, dt)
    assert t.geno_complete == (miss == 0.0)
    got = t.compute_people_statistics()
    want = j.compute_people_statistics()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dt
        _close(g, w, PEOPLE_TOL[dt])
    base = tlinear.xxt_diag_base(t)
    want_base = jlinear.make_aux(j, jlinear.VampConfig(use_xxt=True, slq_k=2))
    _close(base, want_base.xxt_diag_base, PEOPLE_TOL[dt])


# The dual Gram: f32 quantises W per 64-marker stripe in the port and per
# tm-marker tile in JAX (tm = 512 here), each ~127^-4 fine, and sums in
# another order; f64 runs the dense two-pass form on both sides.
GRAM_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("miss", [0.0, 0.05])
def test_gram_aat_matches_jax(dt, miss):
    """A A^T Up with NA phenotypes: the port's fn_gram_aat (f32: the fused
    gram_aat_i8a / gram_aat_i8; f64: None, so the two-pass form) against
    JAX's fn_gram_aat (pallas) or its two-pass form (xla)."""
    rng = np.random.default_rng(23)
    N, M, B = 131, 512, 2
    codes, y = random_dataset(rng, N, M, miss_geno=miss)
    j, t = _pair(codes, y, N, dt)
    U = np.stack([t.layout.planarize(rng.normal(size=N)) for _ in range(B)],
                 axis=-1)
    jd = JAX_DTYPE[dt]
    Uj = jnp.asarray(U, jd)
    jg = j.fn_gram_aat()
    if jg is not None:
        want = jg(j.op, Uj)
    else:
        want = j.axm(j.atxm(Uj))
    tg = t.fn_gram_aat()
    assert (tg is None) == (dt == torch.float64)
    Ut = torch.as_tensor(U, dtype=dt)
    got = tg(t.op, Ut) if tg is not None else t.axm(t.atxm(Ut))
    _close(got, want, GRAM_TOL[dt])
    # the padding samples and NA slots are zero
    na = t.na_planar.numpy()[:, :, None]
    assert not np.any(got.numpy() * (1 - na))


def test_fn_gram_aat_routing(monkeypatch):
    """fn_gram_aat returns None under GVAMP_NO_FUSED_GRAM=1, in float64 and
    above the shared-memory budget (Nw = 832 word rows, N = 13,312); else the
    a-only kernel on complete genotypes and the general one otherwise."""
    from gvamp_tpu_torch.ops import matvec
    rng = np.random.default_rng(5)
    codes, y = _complete_dataset(rng, 64, 40)
    t = TGenoBed.from_arrays(make_bed(codes), y, N=64, device="cpu")
    assert t.fn_gram_aat() is not None
    monkeypatch.setenv("GVAMP_NO_FUSED_GRAM", "1")
    assert t.fn_gram_aat() is None
    monkeypatch.delenv("GVAMP_NO_FUSED_GRAM")
    assert TGenoBed.from_arrays(make_bed(codes), y, N=64, device="cpu",
                                dtype=torch.float64).fn_gram_aat() is None
    calls = []
    for name in ("gram_aat_i8a", "gram_aat_i8"):
        monkeypatch.setattr(matvec, name,
                            lambda *a, _n=name: calls.append(_n) or a[1])
    U = torch.zeros((4, t.layout.n_bytes, 1))
    t.fn_gram_aat()(t.op, U)
    codes_m, y_m = random_dataset(rng, 64, 40, miss_geno=0.05)
    tm = TGenoBed.from_arrays(make_bed(codes_m), y_m, N=64, device="cpu")
    tm.fn_gram_aat()(tm.op, U)
    assert calls == ["gram_aat_i8a", "gram_aat_i8"]
    for nw, fits in ((800, True), (832, False)):
        words = torch.full((nw, 512), 0x55555555, dtype=torch.int32)
        g = TGenoBed.from_device_words(words, np.zeros(16 * nw), N=16 * nw,
                                       standardize_phen=False,
                                       mave=np.zeros(512), msig=np.ones(512))
        assert (g.fn_gram_aat() is not None) == fits
