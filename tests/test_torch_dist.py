"""The port's marker mesh (gvamp_tpu_torch/dist.py) at the product layer,
against the JAX package's device mesh (gvamp_tpu/dist.py, the shard_map
paths of gvamp_tpu/data.py): the reference's block partition, the slab
reader, the mesh's own collectives, and under K in {2, 4, 8} CPU shards
against JAX's K-device mesh over the test run's virtual CPU devices
(tests/conftest.py), on the same words (``convert.geno_from_numpy(mesh=)``),
with complete genotypes and with missing calls: the marker and people
statistics, ``ax`` / ``atx`` / ``axm`` / ``atxm``, the completeness check
and the fused dual Gram.  JAX runs f32 through its Pallas kernels in
interpret mode under ``shard_map`` (tests/test_torch_dist_kernels.py),
f64 through XLA; the port runs each kernel's plain version per slab."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import dist as jdist
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink
from gvamp_tpu_torch import convert, dist
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.data import GenoDense as TGenoDense
from gvamp_tpu_torch.ops import pvals as tpvals
from gvamp_tpu_torch.ops.layout import PlanarLayout
from helpers import random_dataset
from test_data_layer import make_bed

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}
# f64: rtol 1e-10, the JAX package's own mesh limit.  f32: rtol 1e-5 (the
# JAX package's, tests/test_data_layer.py:186-237) with an absolute floor
# of 2e-7 of the largest entry.  The port's plain digit products and JAX's
# interpret-mode Pallas kernels fold the same exact integer sums in another
# order, and the centring av - mave sv cancels, so small entries differ by
# more than JAX's own absolute 1e-7 (which holds its sharded kernels
# against an f64 reference on smaller values) allows, with a mesh or
# without one.  Measured on these data over the statistics and the four
# products, each K case's largest absolute error / that over the largest
# entry / the absolute floor it needs beside rtol 1e-5:
#   K=2: complete 1.19e-6/2.96e-7/5.03e-7, missing 9.54e-7/2.51e-7/2.93e-7
#   K=4: complete 1.07e-6/3.22e-7/5.15e-7, missing 1.43e-6/3.97e-7/2.88e-7
#   K=8: complete 1.19e-6/3.44e-7/5.30e-7, missing 1.07e-6/2.68e-7/4.69e-7
# so an absolute 1e-7 cannot be met here; the worst floor needed is
# 1.53e-7 of the largest entry (K=8 complete, atxm), and 2e-7 sits just
# above it.  The dual Gram: 5e-5 of its largest entry, the JAX package's
# own limit.
TOL = {torch.float64: dict(rtol=1e-10, atol=0.0),
       torch.float32: dict(rtol=1e-5, atol=2e-7)}
GRAM_TOL = 5e-5
N, M, B = 130, 300, 3


@pytest.mark.parametrize("mt,nranks", [(11, 4), (8, 4), (3, 5), (1000, 7)])
def test_divide_work_matches_jax(mt, nranks):
    """The reference's block partition (utilities.cpp:259-291): the first
    mt % nranks ranks take one marker more (tests/test_dist.py:32-40)."""
    starts, counts = dist.divide_work(mt, nranks)
    j_starts, j_counts = jdist.divide_work(mt, nranks)
    np.testing.assert_array_equal(starts, j_starts)
    np.testing.assert_array_equal(counts, j_counts)
    assert int(counts.sum()) == mt and counts.max() - counts.min() <= 1
    if (mt, nranks) == (11, 4):
        assert list(counts) == [3, 3, 3, 2] and list(starts) == [0, 3, 6, 9]


def test_mesh_layout_and_local_collectives():
    """One process: K shards on the CPU, the equal slabs, a shard_map that
    sums in shard order and one that gathers, and a replication check that
    has no other process to ask."""
    mesh = dist.Mesh(4, "cpu")
    assert (mesh.n_shards, mesh.shards, mesh.world) == (4, (0, 1, 2, 3), 1)
    assert not mesh.distributed and mesh.device == torch.device("cpu")
    assert mesh.cols(2048) == [(0, 512), (512, 1024), (1024, 1536),
                               (1536, 2048)]
    with pytest.raises(ValueError, match="equal shards"):
        mesh.cols(1001)
    x = torch.arange(24.0).reshape(2, 12)
    slabs = mesh.split(x)
    assert [s.shape for s in slabs] == [(2, 3)] * 4
    assert all(s.is_contiguous() for s in slabs)
    w = torch.arange(12.0) + 1
    got = mesh.shard_map(lambda g, w_: g @ w_, ("m",), "sum")(slabs, w)
    torch.testing.assert_close(got, x @ w, rtol=0, atol=0)
    got = mesh.shard_map(lambda g, v: (v @ g, 2 * (v @ g)), (None,), "m")(
        slabs, torch.ones(2))
    torch.testing.assert_close(got[0], x.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(got[1], 2 * x.sum(0), rtol=0, atol=0)
    assert mesh.assert_replicated(x, w) == 2


def test_mesh_defaults_to_the_card():
    """A mesh built without a device is on the card, or raises where there
    is none: it never moves a run to the CPU on its own."""
    if torch.cuda.is_available():
        assert dist.Mesh(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.Mesh(2)


def _entry_points(tmp_path):
    """Each container entry point that takes a device, called with its
    default device (the card) and the keywords given."""
    rng = np.random.default_rng(5)
    n, m = 40, 30
    codes, y = random_dataset(rng, n, m)
    bed = str(tmp_path / "d.bed")
    plink.write_bed(bed, codes)
    X = rng.normal(size=(m, n))
    meth = str(tmp_path / "d.meth")
    X.astype(np.float64).tofile(meth)
    words = TGenoBed.from_arrays(make_bed(codes), y, N=n,
                                 device="cpu").words.numpy().view(np.uint32)
    return {
        "bed_from_arrays": lambda **kw: TGenoBed.from_arrays(
            make_bed(codes), y, N=n, **kw),
        "bed_from_files": lambda **kw: TGenoBed.from_files(
            bed, None, N=n, Mt=m, **kw),
        "dense_from_arrays": lambda **kw: TGenoDense.from_arrays(
            X, y, N=n, **kw),
        "dense_from_files": lambda **kw: TGenoDense.from_files(
            meth, None, N=n, Mt=m, **kw),
        "geno_from_numpy": lambda **kw: convert.geno_from_numpy(
            words, y, N=n, M=m, **kw),
    }


@pytest.mark.parametrize("entry", ["bed_from_arrays", "bed_from_files",
                                   "dense_from_arrays", "dense_from_files",
                                   "geno_from_numpy"])
def test_entry_point_device_must_match_mesh(entry, tmp_path):
    """A container entry point given a CPU mesh and its default device
    (the card) raises instead of building on the mesh's CPU; naming the
    mesh's device builds on it."""
    call = _entry_points(tmp_path)[entry]
    with pytest.raises(ValueError, match="disagrees with the mesh"):
        call(mesh=dist.Mesh(2, "cpu"))
    g = call(device="cpu", mesh=dist.Mesh(2, "cpu"))
    assert g.device == torch.device("cpu") and g.mesh.n_shards == 2


def test_checksum_sees_every_element():
    """The replication checksum changes with one flipped bit and with two
    swapped elements (a plain sum would not see the swap)."""
    x = torch.randn(1001, dtype=torch.float64)
    base = dist._checksum(x, "cpu")
    y = x.clone()
    y.view(torch.int64)[7] ^= 1
    z = x.clone()
    z[[3, 4]] = x[[4, 3]]
    assert dist._checksum(y, "cpu") != base
    assert dist._checksum(z, "cpu") != base
    assert dist._checksum(torch.tensor([True, False, True]), "cpu") != \
        dist._checksum(torch.tensor([True, True, False]), "cpu")


def test_slab_reader_reads_only_its_byte_ranges(tmp_path):
    """A process owning shard 1 of 4 reads the same words from a .bed
    whose bytes outside that shard's markers are garbage as from the clean
    file (the reference's per-rank slab read, data.cpp:201-234); shard 0
    read from the garbled file differs, so the garbage would show."""
    rng = np.random.default_rng(2)
    n, m = 70, 1700          # Mpad 2048 at 4 shards: slab width 512
    codes, _ = random_dataset(rng, n, m)
    clean, bad = str(tmp_path / "c.bed"), str(tmp_path / "b.bed")
    plink.write_bed(clean, codes)
    raw = bytearray(open(clean, "rb").read())
    mb = plink.bed_mbytes(n)
    lo, hi = 3 + 512 * mb, 3 + 1024 * mb      # shard 1's markers
    for i in range(3, len(raw)):
        if not lo <= i < hi:
            raw[i] = 0xA7
    open(bad, "wb").write(bytes(raw))
    nw = PlanarLayout.create(n).n_words
    cpu = [torch.device("cpu")]
    want = dist.read_bed_slabs(clean, n, m, 0, nw, 2048, 4, [1], cpu)[0]
    got = dist.read_bed_slabs(bad, n, m, 0, nw, 2048, 4, [1], cpu)[0]
    assert torch.equal(got, want) and got.shape == (nw, 512)
    assert not torch.equal(
        dist.read_bed_slabs(bad, n, m, 0, nw, 2048, 4, [0], cpu)[0],
        dist.read_bed_slabs(clean, n, m, 0, nw, 2048, 4, [0], cpu)[0])
    # the last shard: real markers 1536..1699, 0x55 padding after them
    last = dist.read_bed_slabs(clean, n, m, 0, nw, 2048, 4, [3], cpu)[0]
    full = TGenoBed.from_files(clean, None, N=n, Mt=m, device="cpu",
                               marker_align=2048)
    assert torch.equal(last, full.words[:, 1536:])
    assert (last[:, m - 1536:].numpy().view(np.uint32) == 0x55555555).all()


def _jax_mesh(k):
    return jax.sharding.Mesh(np.array(jax.devices()[:k]), ("m",))


def _pair(k, dt, complete, seed=7):
    """JAX's container on a k-device mesh and two port containers on a
    k-shard mesh over JAX's words: one computing its own statistics, one
    taking JAX's (so that a product's cancellation av - mave sv does not
    magnify the statistics' last-ulp differences)."""
    rng = np.random.default_rng(seed)
    codes, y = random_dataset(rng, N, M, miss_geno=0.0 if complete else 0.05)
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt], mesh=_jax_mesh(k))
    kw = dict(N=N, M=M, dtype=dt, mesh=dist.Mesh(k, "cpu"), device="cpu")
    own = convert.geno_from_numpy(np.asarray(j.words), y, **kw)
    t = convert.geno_from_numpy(np.asarray(j.words), y, mave=np.asarray(
        j.mave), msig=np.asarray(j.msig), **kw)
    return j, own, t, rng


def _close(got, want, dt, **kw):
    """Within TOL[dt], the absolute part scaled by the largest entry."""
    want = np.asarray(want, np.float64)
    kw = kw or dict(TOL[dt], atol=TOL[dt]["atol"] * np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got, np.float64), want, **kw)


def check_products(k, dt, complete):
    """The statistics, products, people statistics, completeness and dual
    Gram of a k-shard port mesh against JAX's k-device mesh (the f32 cases
    run in tests/test_torch_dist_kernels.py: JAX's interpret-mode Pallas
    kernels cost about 8 s a case)."""
    j, own, t, rng = _pair(k, dt, complete)
    assert t.Mpad == j.Mpad == 512 * k
    assert len(t.words) == k and all(g.shape == (t.layout.n_words, 512)
                                     for g in t.words)
    assert own.geno_complete == j.geno_complete == complete
    _close(own.mave, j.mave, dt)
    _close(own.msig, j.msig, dt)
    assert not own.mave[M:].any() and not own.msig[M:].any()

    # JAX's products jitted, as its engines run them (an eager shard_map
    # of the f64 decode costs seconds per call on the CPU)
    ax_j, atx_j = (jax.jit(f) for f in j.fns())
    axm_j, atxm_j = (jax.jit(f) for f in j.fns_multi())
    x = rng.normal(size=t.Mpad) * t.m_mask.numpy()
    _close(t.ax(torch.tensor(x, dtype=dt)),
           ax_j(j.op, jnp.asarray(x, j.dtype)), dt)
    v = rng.normal(size=N)
    _close(t.atx(t.planarize(v))[:M],
           np.asarray(atx_j(j.op, j.planarize(v)))[:M], dt)
    X = rng.normal(size=(t.Mpad, B)) * t.m_mask.numpy()[:, None]
    Z = t.axm(torch.tensor(X, dtype=dt))
    _close(Z, axm_j(j.op, jnp.asarray(X, j.dtype)), dt)
    V = np.stack([t.planarize(rng.normal(size=N)).numpy() for _ in range(B)],
                 axis=-1)
    _close(t.atxm(torch.tensor(V))[:M],
           np.asarray(atxm_j(j.op, jnp.asarray(V)))[:M], dt)

    got, want = own.compute_people_statistics(), j.compute_people_statistics()
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g_, w_ in zip(got[:2], want[:2]):
        _close(g_, w_, dt, rtol=0, atol=1e-5 * np.abs(np.asarray(w_)).max())

    assert t.fn_gram() is None
    fn_t, fn_j = t.fn_gram_aat(), j.fn_gram_aat()
    assert (fn_t is None) == (fn_j is None) == (dt == torch.float64)
    if fn_t is not None:
        z_t = fn_t(t.op, torch.tensor(V))
        z_j = np.asarray(jax.jit(fn_j)(j.op, jnp.asarray(V)))
        _close(z_t, z_j, dt, rtol=0, atol=GRAM_TOL * np.abs(z_j).max())


@pytest.mark.parametrize("complete", [True, False], ids=["complete", "miss"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_products_match_jax_mesh(k, complete):
    """float64: the dense plain products per slab against JAX's XLA ones
    under shard_map."""
    check_products(k, torch.float64, complete)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_mesh_equals_one_device(dt):
    """4 shards against one device on the same data: statistics, people
    statistics and completeness equal bit for bit (each marker's and each
    slot's sums are the same sums), products to the rounding of the slab
    partials' sum, and the p-values' moments pass (per slab, gathered)
    bit for bit."""
    rng = np.random.default_rng(11)
    codes, y = random_dataset(rng, N, M)
    t1 = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt,
                              device="cpu", marker_align=2048)
    t4 = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt,
                              device="cpu", mesh=dist.Mesh(4, "cpu"))
    assert t1.Mpad == t4.Mpad == 2048 and t4.device == torch.device("cpu")
    for a, b in ((t1.mave, t4.mave), (t1.msig, t4.msig)):
        assert torch.equal(a, b)
    assert t1.geno_complete is t4.geno_complete is False
    for a, b in zip(t1.compute_people_statistics(),
                    t4.compute_people_statistics()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(a.abs().max()))
    X = torch.tensor(rng.normal(size=(2048, 2)), dtype=dt) * t1.m_mask[:, None]
    z1, z4 = t1.axm(X), t4.axm(X)
    _close(z4, z1, dt)
    assert torch.equal(t1.atxm(z1), t4.atxm(z1))
    p1 = tpvals.loo_pvals_multi(t1, z1, X)
    p4 = tpvals.loo_pvals_multi(t4, z1, X)
    np.testing.assert_array_equal(p1, p4)


def test_geno_from_numpy_mesh_statistics():
    """JAX's global words split into the port's 8 slabs give the marker
    statistics of JAX's 8-device container (f64, rtol 1e-10)."""
    rng = np.random.default_rng(3)
    codes, y = random_dataset(rng, N, M)
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=jnp.float64,
                             backend="xla", mesh=_jax_mesh(8))
    t = convert.geno_from_numpy(np.asarray(j.words), y, N=N, M=M,
                                dtype=torch.float64,
                                mesh=dist.Mesh(8, "cpu"), device="cpu")
    assert [g.shape[1] for g in t.words] == [512] * 8
    words = np.concatenate([g.numpy() for g in t.words], axis=1)
    np.testing.assert_array_equal(words.view(np.uint32), np.asarray(j.words))
    np.testing.assert_allclose(t.mave.numpy(), np.asarray(j.mave), rtol=1e-10)
    np.testing.assert_allclose(t.msig.numpy(), np.asarray(j.msig), rtol=1e-10)
