"""The port's run modes (gvamp_tpu_torch/cli.py) against the JAX CLI on one
small dataset (the recipe of tests/test_cli.py:17-55), f64 and f32: test,
both, pvals-calc, predict and predict_single, the multi-trait series of
test and both, and the estimate-series parser (sim and --state-evo:
tests/test_torch_modes_sim.py).
The modes that infer run with JAX's probe on both sides (the port's
make_bern_probe replaced by JAX's, as the parity tests pass it in);
torch cannot reproduce jax.random."""

import os
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import cli as jcli
from gvamp_tpu import linear as jlinear
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink, vecio
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import linear as tlinear
from test_data_layer import make_bed
from test_torch_linear import CLI_LOG10P_TOL

torch.set_num_threads(1)

# tests/test_cli.py:17-55's dataset: N=600 x M=200, 1% missing calls, a
# 15-marker truth at h2 0.8, a .bim over 4 chromosomes
N, M, CV, H2 = 600, 200, 15, 0.8
# printed scores and prediction CSVs: f64 1e-9, f32 1e-5 (relative for the
# CSVs); the sim truth and phenotype files 1e-12 (f64)
TOL = {"float64": 1e-9, "float32": 1e-5}
DTYPES = ("float64", "float32")


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("modes")
    rng = np.random.default_rng(21)
    codes = jsim.random_genotypes(rng, M, N, miss_rate=0.01)
    bed = str(d / "t.bed")
    plink.write_bed(bed, codes)
    geno = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                                standardize_phen=False, dtype=jnp.float64,
                                backend="xla")
    vars_t, probs_t = jsim.two_group_prior(M, CV, H2)
    beta = jsim.simulate_mixture(rng, M, vars_t, probs_t)
    y = jsim.simulate_linear_phenotype(geno, beta, 1 / (1 - H2), rng)
    y2 = jsim.simulate_linear_phenotype(
        geno, jsim.simulate_mixture(rng, M, vars_t, probs_t), 5.0, rng)
    files = dict(bed=bed, phen=str(d / "t.phen"), phen2=str(d / "t2.phen"),
                 bim=str(d / "t.bim"), cc=str(d / "cc.phen"),
                 cov=str(d / "c.cov"))
    plink.write_phen(files["phen"], y)
    plink.write_phen(files["phen2"], y2)
    plink.write_bim(files["bim"], np.repeat(np.arange(1, 5), M // 4))
    plink.write_phen(files["cc"], (y > np.median(y)).astype(float))
    plink.write_covariates(files["cov"], rng.normal(size=(N, 2)))
    # a stored estimate series to score: iterations 1-4 of a port run
    series = []
    for it in range(1, 5):
        est = beta * (1 - 0.5 ** it) + rng.normal(size=M) * 0.01 / it
        path = str(d / f"run_it_{it}.bin")
        vecio.write_bin_shard(path, est, 0)
        vecio.write_bin_shard(str(d / f"gtemp_{it}_{it}_gibbs_est.bin"),
                              est, 0)
        for t in range(2):
            vecio.write_bin_shard(str(d / f"mt_phen{t}_it_{it}.bin"),
                                  est * (1 - t), 0)
        series.append(est)
    vecio.write_bin_shard(str(d / "cov_eff.bin"), np.array([0.3, -0.2]), 0)
    return SimpleNamespace(dir=d, beta=beta, vars=vars_t, probs=probs_t,
                           **files)


@pytest.fixture(autouse=True)
def one_device(monkeypatch):
    """The JAX CLI on one device: the test session's CPU backend holds 8
    virtual devices (tests/conftest.py), over which the CLI would shard."""
    monkeypatch.setattr(jcli, "_mesh", lambda opt: None)


@pytest.fixture
def jax_probe(monkeypatch):
    """The port's engines draw JAX's Rademacher probe (jax.random), so that
    a port CLI run and a JAX CLI run see the same probe."""
    def probe(geno, seed, n_probes=1):
        jdt = jnp.float64 if geno.dtype == torch.float64 else jnp.float32
        ns = SimpleNamespace(S=geno.S, Mpad=geno.Mpad, Mt=geno.Mt, dtype=jdt,
                             m_mask=jnp.asarray(geno.m_mask.cpu().numpy(),
                                                jdt))
        return torch.tensor(np.asarray(jlinear.make_bern_probe(
            ns, seed, n_probes)), dtype=geno.dtype, device=geno.device)
    monkeypatch.setattr(tlinear, "make_bern_probe", probe)


def _both_clis(capsys, args, dtype):
    """Run ``args`` through the JAX CLI and the port's (on the CPU), the
    output prefixes told apart by a j / t suffix on --out-name; returns
    ((JAX's value, printed lines), (the port's, lines))."""
    out = []
    for side, main in (("j", jcli.main),
                       ("t", lambda a: tcli.main(["--device", "cpu"] + a))):
        a = list(args) + ["--dtype", dtype, "--verbosity", "0"]
        if "--out-name" in a:
            a[a.index("--out-name") + 1] += side
        capsys.readouterr()
        val = main(a)
        out.append((val, capsys.readouterr().out.splitlines()))
    return out


def _numbers(lines):
    return [float(x) for ln in lines
            for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", ln)]


def _test_args(ds, *extra):
    return ["--run-mode", "test", "--bed-file-test", ds.bed,
            "--phen-files-test", ds.phen, "--N-test", str(N), "--Mt-test",
            str(M), "--out-dir", str(ds.dir), "--out-name", "test",
            *extra]


@pytest.mark.parametrize("dtype", DTYPES)
def test_test_mode_matches_jax(ds, capsys, dtype):
    """The R2 sweep over a stored series: every printed score within TOL,
    the same best iteration."""
    (vj, lj), (vt, lt) = _both_clis(capsys, _test_args(
        ds, "--estimate-file", str(ds.dir / "run_it_1.bin"),
        "--test-iter-range", "1,4"), dtype)
    assert vt[1] == vj[1] == 4 and len(lt) == len(lj) == 5
    np.testing.assert_allclose(_numbers(lt), _numbers(lj), rtol=0,
                               atol=TOL[dtype])
    assert [ln.split(":")[0] for ln in lt] == [ln.split(":")[0] for ln in lj]


def test_test_mode_bin_class_matches_jax(ds, capsys):
    """The probit confusion sweep with the covariate term from
    --cov-estimate-file: the printed TPR / FPR / accuracy lines equal."""
    args = _test_args(ds, "--model", "bin_class", "--estimate-file",
                      str(ds.dir / "run_it_1.bin"), "--test-iter-range",
                      "1,4", "--cov-file", ds.cov, "--C", "2",
                      "--cov-estimate-file", str(ds.dir / "cov_eff.bin"))
    args[args.index("--phen-files-test") + 1] = ds.cc
    for dtype in DTYPES:
        (vj, lj), (vt, lt) = _both_clis(capsys, args, dtype)
        assert lt == lj and vt == vj


@pytest.mark.parametrize("dtype", DTYPES)
def test_pvals_calc_matches_jax(ds, capsys, dtype):
    """LOO and LOCO over a 3-estimate series with a .bim: each file's
    log10 p within CLI_LOG10P_TOL of JAX's (relative to max(1, |log10 p|)),
    each LOCO predictor CSV within TOL.  f64: the JAX CLI's files.  f32:
    each CLI's f32 forward products (A x1, each chromosome's predictor)
    differ from the other's by a few ulps, which moves log10 p by up to
    2.2e-6 here, beyond the limit; so the LOO files are held against JAX's
    loo_pvals_multi on the port's own A x1 (the p-value pass itself, as
    tests/test_torch_linear.py holds it), and the LOCO files equal the
    port's loco_pvals bit for bit (its f64 twin is held to JAX above)."""
    import gvamp_tpu.ops.pvals as jpvals
    from gvamp_tpu.data import GenoBed as JG
    from gvamp_tpu_torch.data import GenoBed as TG
    from gvamp_tpu_torch.ops import pvals as tpvals
    _both_clis(capsys, [
        "--run-mode", "pvals-calc", "--bed-file", ds.bed, "--phen-files",
        ds.phen, "--bim-file", ds.bim, "--N", str(N), "--Mt", str(M),
        "--estimate-file", str(ds.dir / "run_it_2.bin"), "--test-iter-range",
        "2,4", "--out-dir", str(ds.dir), "--out-name", "pv"], dtype)

    def read(side, it, suf):
        return vecio.read_bin_shard(str(ds.dir / f"pv{side}_it_{it}{suf}"),
                                    M, 0)

    want = {it: read("j", it, "_pvals.bin") for it in (2, 3, 4)}
    if dtype == "float32":
        t = TG.from_files(ds.bed, ds.phen, N=N, Mt=M, device="cpu")
        j = JG.from_files(ds.bed, ds.phen, N=N, Mt=M, dtype=jnp.float32,
                          backend="pallas")
        ests = [vecio.read_bin_shard(str(ds.dir / f"run_it_{it}.bin"), M, 0)
                for it in (2, 3, 4)]
        x1s = torch.stack([t.pad_m(e * np.sqrt(N)) for e in ests], dim=1)
        z1s = t.axm(x1s)
        loo = jpvals.loo_pvals_multi(j, jnp.asarray(z1s.numpy()),
                                     jnp.asarray(x1s.numpy()))
        chroms = plink.read_chromosomes(ds.bim, M, 0)
        for e, it in enumerate((2, 3, 4)):
            want[it] = np.asarray(loo[e])
            np.testing.assert_array_equal(
                read("t", it, "_pvals_LOCO.bin"), tpvals.loco_pvals(
                    t, z1s[..., e].contiguous(), x1s[:, e].contiguous(),
                    chroms))
    for it in (2, 3, 4):
        pairs = [(read("t", it, "_pvals.bin"), want[it])]
        if dtype == "float64":
            pairs.append((read("t", it, "_pvals_LOCO.bin"),
                          read("j", it, "_pvals_LOCO.bin")))
        for pt, pj in pairs:
            lw, lg = np.log10(pj), np.log10(pt)
            assert np.all(np.abs(lg - lw)
                          <= CLI_LOG10P_TOL * np.maximum(1, -lw)), it
        for ch in range(1, 5):
            zj = np.loadtxt(ds.dir / f"pvj_it_{it}_LOCO_chr_{ch}.csv")
            zt = np.loadtxt(ds.dir / f"pvt_it_{it}_LOCO_chr_{ch}.csv")
            np.testing.assert_allclose(zt, zj, rtol=0,
                                       atol=TOL[dtype] * np.abs(zj).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_predict_modes_match_jax(ds, capsys, dtype, monkeypatch):
    """predict_single, predict --predict-format matrix and the
    file-per-individual layout: every CSV within TOL (relative).  The
    Gibbs-named series is given relative to the working directory: both
    CLIs take its extension after the path's first dot (ROADMAP.md Queue
    3), which a temporary directory's name may hold."""
    base = ["--bed-file-test", ds.bed, "--N-test", str(N), "--Mt-test",
            str(M), "--out-dir", str(ds.dir)]
    _both_clis(capsys, base + ["--run-mode", "predict_single",
                               "--estimate-file", str(ds.dir / "run_it_4.bin"),
                               "--out-name", "ps"], dtype)
    monkeypatch.chdir(ds.dir)
    gibbs = ["--run-mode", "predict", "--estimate-file",
             "gtemp_2_2_gibbs_est.bin", "--test-iter-range", "2,4"]
    _both_clis(capsys, base + gibbs + ["--out-name", "pm"], dtype)
    _both_clis(capsys, base + gibbs + ["--predict-format", "per-individual",
                                       "--out-name", "pi"], dtype)

    def close(name, **kw):
        zj = np.loadtxt(ds.dir / name.format("j"), **kw)
        zt = np.loadtxt(ds.dir / name.format("t"), **kw)
        assert zt.shape == zj.shape
        np.testing.assert_allclose(zt, zj, rtol=0,
                                   atol=TOL[dtype] * np.abs(zj).max())

    close("ps{}_predict.csv")
    close("pm{}_predict_matrix.csv", delimiter=",")
    for i in (0, 1, N - 1):
        close(f"pi{{}}_predict_{i}.csv")
    assert not os.path.exists(ds.dir / f"pit_predict_{N}.csv")


@pytest.mark.parametrize("dtype", DTYPES)
def test_both_mode_matches_jax(ds, capsys, jax_probe, dtype):
    """infere on the training set, then the test set's R2 with the
    training intercept and scale, through both CLIs (JAX's probe): the
    printed R2 within TOL."""
    (vj, lj), (vt, lt) = _both_clis(capsys, [
        "--run-mode", "both", "--bed-file", ds.bed, "--phen-files", ds.phen,
        "--bed-file-test", ds.bed, "--phen-files-test", ds.phen,
        "--N", str(N), "--Mt", str(M), "--N-test", str(N), "--Mt-test",
        str(M), "--iterations", "3", "--rho", "0.3",
        "--vars", ",".join(map(str, ds.vars)),
        "--probs", ",".join(map(str, ds.probs)),
        "--out-dir", str(ds.dir), "--out-name", "both"], dtype)
    assert abs(vt - vj) <= TOL[dtype]
    assert lt[-1].startswith("test R2 = ")


def test_both_mode_bin_class_warns_on_covariate_rows(ds, capsys, jax_probe):
    """bin_class both with --cov-file: the learned covariate effects apply
    to the test set when its rows match (the same printed counts as JAX);
    with a test set of other size the port warns, as JAX does."""
    args = ["--run-mode", "both", "--model", "bin_class", "--bed-file",
            ds.bed, "--phen-files", ds.cc, "--cov-file", ds.cov, "--C", "2",
            "--bed-file-test", ds.bed, "--phen-files-test", ds.cc,
            "--N", str(N), "--Mt", str(M), "--N-test", str(N), "--Mt-test",
            str(M), "--iterations", "2", "--rho", "0.3",
            "--vars", ",".join(map(str, ds.vars)),
            "--probs", ",".join(map(str, ds.probs)),
            "--out-dir", str(ds.dir), "--out-name", "bb"]
    capsys.readouterr()
    acc = tcli.main(["--device", "cpu", "--dtype", "float64",
                     "--verbosity", "0"] + args)
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1].startswith("test: TPR=") and 0.5 < acc <= 1
    assert not any("WARNING" in ln for ln in lines)
    # a test set of the first 400 people: its covariate rows do not match
    tbed = str(ds.dir / "t400.bed")
    plink.write_bed(tbed, _first_people_codes(ds.bed, 400))
    y, _ = plink.read_phen(ds.cc)
    plink.write_phen(str(ds.dir / "t400.phen"), y[:400])
    args[args.index("--bed-file-test") + 1] = tbed
    args[args.index("--phen-files-test") + 1] = str(ds.dir / "t400.phen")
    args[args.index("--N-test") + 1] = "400"
    tcli.main(["--device", "cpu", "--dtype", "float64", "--verbosity",
               "0"] + args)
    assert "WARNING: learned covariate effects NOT applied" in \
        capsys.readouterr().out


def _first_people_codes(bed, n):
    """The 2-bit codes [M, n] of the first n people of a .bed file."""
    by = plink.read_bed_slab(bed, N, M)
    codes = np.stack([(by >> (2 * k)) & 3 for k in range(4)], axis=2)
    return codes.reshape(M, -1)[:, :n].astype(np.uint8)


def test_multi_trait_series_match_jax(ds, capsys, jax_probe):
    """A two-trait series (``_phen{t}`` dumps) scored by test trait by
    trait, and both over two --phen-files (tests/test_cli.py:396-449),
    through both CLIs in f64: the printed scores within 1e-9, the same
    best iterations."""
    two = f"{ds.phen},{ds.phen2}"
    (vj, lj), (vt, lt) = _both_clis(capsys, _test_args(
        ds, "--estimate-file", str(ds.dir / "mt_it_1.bin"),
        "--test-iter-range", "1,4", "--phen-files-test", two), "float64")
    assert len(vt) == len(vj) == 2
    assert [b for _, b in vt] == [b for _, b in vj]
    np.testing.assert_allclose(_numbers(lt), _numbers(lj), rtol=0, atol=1e-9)
    (vj, lj), (vt, lt) = _both_clis(capsys, [
        "--run-mode", "both", "--bed-file", ds.bed, "--phen-files", two,
        "--bed-file-test", ds.bed, "--phen-files-test", two, "--N", str(N),
        "--Mt", str(M), "--N-test", str(N), "--Mt-test", str(M),
        "--iterations", "3", "--rho", "0.3",
        "--vars", ",".join(map(str, ds.vars)),
        "--probs", ",".join(map(str, ds.probs)),
        "--out-dir", str(ds.dir), "--out-name", "mtb"], "float64")
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-9)
    assert [ln.split("=")[0] for ln in lt if ln.startswith("test")] == [
        "test R2 (_phen0) ", "test R2 (_phen1) "]


def test_series_paths_and_tags_match_jax(tmp_path):
    """_series_paths on a stem holding "it" (tests/test_cli.py:362-380),
    _tagged on the dump names of each model, _estimate_series on a tagged
    series: the JAX CLI's answers."""
    d = tmp_path / "iter3"
    d.mkdir()
    for it in (2, 3):
        vecio.write_bin_shard(str(d / f"run_phen1_it_{it}.bin"),
                              np.full(8, float(it)), 0)
    for path, lo, hi in ((str(d / "run_it_2.bin"), 2, 3),
                         (str(d / "edit_est.bin"), 1, 2),
                         ("/tmp/a.b/x_probit_it_7.bin", 7, 9)):
        assert tcli._series_paths(path, lo, hi) == jcli._series_paths(path,
                                                                      lo, hi)
    for path in ("out/run_it_4.bin", "out/run_probit_it_4.bin",
                 "out/x_robust_it_10.bin", "out/est.bin"):
        assert tcli._tagged(path, "_phen1") == jcli._tagged(path, "_phen1")
    opt = SimpleNamespace(test_iter_range=(2, 3),
                          estimate_file=str(d / "run_it_2.bin"))
    got = {it: e[0] for it, e in tcli._estimate_series(opt, 8, 0, "_phen1")}
    assert got == {it: e[0] for it, e in jcli._estimate_series(
        opt, 8, 0, "_phen1")} == {2: 2.0, 3: 3.0}
    for phens, test in (([], False), (["a"], True), (["a", "b"], False)):
        o = SimpleNamespace(phen_files=phens, phen_files_test=[])
        assert tcli._trait_tags(o, test) == jcli._trait_tags(o, test)
