"""The port's dense methylation container (gvamp_tpu_torch.data.GenoDense)
and --type-data meth against the JAX package: statistics, products and
set_phen against JAX's GenoDense, the dense container against GenoBed on
decoded dosages, the linear engine per iteration on both sides, the CLI on
both sides, the options the port runs on dense data, and each option the
JAX package cannot run there, whose refusal in the port is pinned beside
the member JAX's GenoDense lacks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import cli as jcli
from gvamp_tpu import linear as jlinear
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoDense as JGenoDense
from gvamp_tpu.io import plink, vecio
from gvamp_tpu.ops.layout import CODE_TO_DOSAGE
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.data import GenoDense as TGenoDense
from test_data_layer import make_bed
from test_torch_data import JAX_DTYPE, PRODUCT_TOL, STATS_TOL, _close
from test_torch_linear import STEP_TOL
from test_torch_modes import jax_probe  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# the recipe of tests/test_cli.py:185-219: N=300 x M=96 standard normal
# probes, an 8-probe truth at h2 0.8; M is not a multiple of 8, so Mpad pads
SEED, N, M = 33, 300, 94


def _problem():
    rng = np.random.default_rng(SEED)
    X = rng.standard_normal((M, N))
    vars_t, probs_t = jsim.two_group_prior(M, 8, 0.8)
    beta = jsim.simulate_mixture(rng, M, vars_t, probs_t)
    g = JGenoDense.from_arrays(X, np.zeros(N), N=N, standardize_phen=False,
                               dtype=jnp.float64)
    y = jsim.simulate_linear_phenotype(g, beta, 1 / (1 - 0.8), rng)
    y[rng.choice(N, 7, replace=False)] = np.nan
    return X, y, beta, vars_t, probs_t


PROBLEM = _problem()


def _pair(dt, y=None):
    X = PROBLEM[0]
    y = PROBLEM[1] if y is None else y
    j = JGenoDense.from_arrays(X, y, N=N, dtype=JAX_DTYPE[dt])
    t = TGenoDense.from_arrays(X, y, N=N, dtype=dt, device="cpu")
    return j, t


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_dense_container_matches_jax(dt):
    """mave / msig within STATS_TOL, ax / atx / axm / atxm within
    PRODUCT_TOL, then the same after set_phen with another NA pattern;
    from_device on the same matrix gives from_arrays's statistics."""
    j, t = _pair(dt)
    assert (t.Mpad, t.layout.n_bytes) == (j.Mpad, j.layout.n_bytes)
    rng = np.random.default_rng(1)

    def check():
        _close(t.mave, j.mave, STATS_TOL[dt])
        _close(t.msig, j.msig, STATS_TOL[dt])
        x = rng.normal(size=t.Mpad) * t.m_mask.numpy()
        v = rng.normal(size=(4, t.layout.n_bytes))
        X = rng.normal(size=(t.Mpad, 3)) * t.m_mask.numpy()[:, None]
        V = rng.normal(size=(4, t.layout.n_bytes, 3))
        for got, want in (
                (t.ax(torch.tensor(x, dtype=dt)),
                 j.ax(jnp.asarray(x, JAX_DTYPE[dt]))),
                (t.atx(torch.tensor(v, dtype=dt)),
                 j.atx(jnp.asarray(v, JAX_DTYPE[dt]))),
                (t.axm(torch.tensor(X, dtype=dt)),
                 j.axm(jnp.asarray(X, JAX_DTYPE[dt]))),
                (t.atxm(torch.tensor(V, dtype=dt)),
                 j.atxm(jnp.asarray(V, JAX_DTYPE[dt])))):
            _close(got, want, PRODUCT_TOL[dt])

    check()
    y2 = PROBLEM[1].copy()
    y2[:11] = np.nan
    j.set_phen(y2, standardize=True)
    t.set_phen(y2, standardize=True)
    assert (t.nonas, t.intercept, t.scale) == (j.nonas, j.intercept, j.scale)
    check()
    _close(t.filter_pheno(), j.filter_pheno(), PRODUCT_TOL[dt])
    if dt == torch.float64:
        X = torch.zeros((t.Mpad, N), dtype=dt)
        X[:M] = torch.tensor(PROBLEM[0])
        d = TGenoDense.from_device(X, PROBLEM[1], N=N, M=M)
        assert torch.equal(d.mave, _pair(dt)[1].mave)
        assert torch.equal(d.msig, _pair(dt)[1].msig)


def test_dense_matches_bed_on_decoded_dosages():
    """GenoDense on the decoded dosages of complete genotypes equals the
    packed container (tests/test_data_layer.py:119), f64."""
    rng = np.random.default_rng(5)
    n, m = 64, 24
    codes = rng.choice([0, 2, 3], size=(m, n)).astype(np.uint8)
    y = rng.normal(size=n)
    bed = TGenoBed.from_arrays(make_bed(codes), y, N=n, dtype=torch.float64,
                               device="cpu")
    dense = TGenoDense.from_arrays(CODE_TO_DOSAGE[codes], y, N=n,
                                   dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(dense.mave[:m], bed.mave[:m], rtol=1e-12)
    np.testing.assert_allclose(dense.msig[:m], bed.msig[:m], rtol=1e-12)
    x = rng.normal(size=m)
    np.testing.assert_allclose(bed.deplanarize(bed.ax(bed.pad_m(x)))[:n],
                               dense.deplanarize(dense.ax(dense.pad_m(x)))[:n],
                               rtol=1e-8)
    v = rng.normal(size=n)
    np.testing.assert_allclose(bed.atx(bed.planarize(v))[:m],
                               dense.atx(dense.planarize(v))[:m], rtol=1e-8)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_linear_engine_on_dense_matches_jax(dt):
    """Six linear iterations on the dense containers with JAX's probe: x1
    per iteration and the scalars within STEP_TOL (1e-9 f64, 1e-4 f32)."""
    beta, vars_t, probs_t = PROBLEM[2:5]
    j, t = _pair(dt)
    kw = dict(max_iter=6, rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=5)
    bern = np.asarray(jlinear.make_bern_probe(j, 5, 1))
    xs = {"j": [], "t": []}

    def keep(side):
        def cb(it, state, metrics, g):
            xs[side].append(np.asarray(state.x1, np.float64).copy())
        return cb

    x_j, _, h_j = jlinear.infer(j, jlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False, callbacks=[keep("j")])
    x_t, _, h_t = tlinear.infer(t, tlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False, bern=bern,
                                callbacks=[keep("t")])
    assert len(h_t) == len(h_j) == 6
    for a, b in zip(xs["t"], xs["j"]):
        _close(torch.tensor(a), b, STEP_TOL[dt])
    for a, b in zip(h_t, h_j):
        for k in ("gam1", "gam2", "gamw", "alpha1", "alpha2"):
            assert abs(float(a[k]) - float(b[k])) <= STEP_TOL[dt] * abs(
                float(b[k])), k
    assert np.corrcoef(x_t, beta)[0, 1] > 0.9


@pytest.fixture(autouse=True)
def one_device(monkeypatch):
    """The JAX CLI on one device: the test session's CPU backend holds 8
    virtual devices (tests/conftest.py), over which the CLI would shard."""
    monkeypatch.setattr(jcli, "_mesh", lambda opt: None)


def _files(tmp_path):
    X, y = PROBLEM[:2]
    meth, phen = str(tmp_path / "m.meth"), str(tmp_path / "m.phen")
    plink.write_meth(meth, X)
    plink.write_phen(phen, y)
    return meth, phen


def _args(tmp_path, meth, phen, name, *extra):
    vars_t, probs_t = PROBLEM[3:5]
    return ["--run-mode", "infere", "--type-data", "meth", "--bed-file",
            meth, "--phen-files", phen, "--N", str(N), "--Mt", str(M),
            "--iterations", "4", "--rho", "0.3",
            "--vars", ",".join(map(str, vars_t)),
            "--probs", ",".join(map(str, probs_t)), "--verbosity", "0",
            "--out-dir", str(tmp_path / "out"), "--out-name", name,
            *extra]


# the CLIs' dumps: f64 1e-9 of the largest entry; f32 1e-5 (4 iterations of
# f32 rounding in other orders, the 6-iteration recipes' 5e-5 halved)
CLI_TOL = {"float64": 1e-9, "float32": 1e-5}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cli_meth_matches_jax(dtype, tmp_path, jax_probe):
    """--type-data meth --run-mode infere through both CLIs (JAX's probe):
    every iteration's estimate dump within CLI_TOL."""
    meth, phen = _files(tmp_path)
    jcli.main(_args(tmp_path, meth, phen, "j", "--dtype", dtype))
    tcli.main(["--device", "cpu"] + _args(tmp_path, meth, phen, "t",
                                          "--dtype", dtype))
    for it in range(1, 5):
        got = vecio.read_bin_shard(str(tmp_path / "out" / f"t_it_{it}.bin"),
                                   M, 0)
        want = vecio.read_bin_shard(str(tmp_path / "out" / f"j_it_{it}.bin"),
                                    M, 0)
        _close(torch.tensor(got), want, CLI_TOL[dtype])
    assert np.corrcoef(got, PROBLEM[2])[0, 1] > 0.9


# the options the JAX package runs on dense data (each run there through
# its CLI on a small .meth file): each runs in the port, f64 on the CPU
DENSE_OPTIONS = {
    "probit": ("--model", "bin_class"),
    "robust": ("--model", "robust"),
    "deflate": ("--deflate-k", "4"),
    "probe_path": ("--use-slq", "0"),
    "lmmse_damp": ("--use-lmmse-damp", "1"),
    "state_evo": ("--state-evo", "1"),
    "pip": ("--store-pip", "1"),
    "sync_timers": ("--sync-every", "2", "--phase-timers", "1")}


@pytest.mark.parametrize("name", DENSE_OPTIONS)
def test_options_run_on_dense_data(name, tmp_path):
    meth, phen = _files(tmp_path)
    if name == "probit":
        y = (np.nan_to_num(PROBLEM[1]) > 0).astype(float)
        plink.write_phen(phen, y)
    tag = {"probit": "_probit", "robust": "_robust"}.get(name, "")
    tcli.main(["--device", "cpu", "--dtype", "float64"]
              + _args(tmp_path, meth, phen, "o", *DENSE_OPTIONS[name]))
    x = vecio.read_bin_shard(str(tmp_path / "out" / f"o{tag}_it_4.bin"), M, 0)
    assert np.isfinite(x).all() and np.abs(x).max() > 0


def test_run_modes_on_dense_data(tmp_path, jax_probe):
    """test, both, a checkpoint with restart --resume, and sim on a .meth
    file through the port's CLI, each against the JAX CLI's output in f64
    (the printed R2s, the sim truth and phenotype, the resumed dump)."""
    meth, phen = _files(tmp_path)
    out = tmp_path / "out"
    vars_t, probs_t = PROBLEM[3:5]
    common = ["--type-data", "meth", "--N", str(N), "--Mt", str(M),
              "--dtype", "float64", "--verbosity", "0", "--out-dir", str(out),
              "--vars", ",".join(map(str, vars_t)),
              "--probs", ",".join(map(str, probs_t))]
    for side, main in (("j", jcli.main), ("t", lambda a: tcli.main(
            ["--device", "cpu"] + a))):
        main(_args(tmp_path, meth, phen, side + "a", "--dtype", "float64",
                   "--checkpoint", str(out / f"{side}.npz")))
        best = main(common + ["--run-mode", "test", "--bed-file-test", meth,
                              "--phen-files-test", phen, "--N-test", str(N),
                              "--Mt-test", str(M), "--estimate-file",
                              str(out / f"{side}a_it_1.bin"),
                              "--test-iter-range", "1,4",
                              "--out-name", side + "t"])
        r2 = main(common + ["--run-mode", "both", "--bed-file", meth,
                            "--phen-files", phen, "--bed-file-test", meth,
                            "--phen-files-test", phen, "--N-test", str(N),
                            "--Mt-test", str(M), "--iterations", "3",
                            "--out-name", side + "b"])
        main(_args(tmp_path, meth, phen, side + "r", "--dtype", "float64",
                   "--iterations", "2")[2:]
             + ["--run-mode", "restart", "--resume", str(out / f"{side}.npz")])
        main(common + ["--run-mode", "sim", "--bed-file", meth,
                       "--iterations", "2", "--h2", "0.6", "--CV", "6",
                       "--seed", "4", "--out-name", side + "s"])
        if side == "j":
            want = (best, r2)
    assert want[0][1] == best[1]
    assert abs(best[0] - want[0][0]) < 1e-9 and abs(r2 - want[1]) < 1e-9
    for name, n in (("r_it_6.bin", M), ("s_beta_true.bin", M)):
        got = vecio.read_bin_shard(str(out / f"t{name}"), n, 0)
        ref = vecio.read_bin_shard(str(out / f"j{name}"), n, 0)
        _close(torch.tensor(got), ref, 1e-9 if "it_" in name else 1e-12)
    _close(torch.tensor(np.loadtxt(out / "ts_y.txt")),
           np.loadtxt(out / "js_y.txt"), 1e-12)


# each option the JAX package cannot run on dense data, found by running
# its CLI on a small .meth file, and the GenoDense member whose absence
# fails it there (AttributeError); the port raises NotImplementedError
# naming the option
REFUSED = {
    "store_pvals": (("--store-pvals", "1"), "words", "--store-pvals"),
    "xxt": (("--use-XXT-denoiser", "1"), "compute_people_statistics",
            "--use-XXT-denoiser"),
    "red": (("--red", "1"), "window_fns_multi", "--red"),
    "cross_val": (("--use-cross-val", "1"), "sample_window",
                  "--use-cross-val"),
    "multi_trait": ((), "marker_stats_for", "several --phen-files"),
    "pvals_calc": (("--run-mode", "pvals-calc"), "words", "pvals-calc")}


@pytest.mark.parametrize("name", REFUSED)
def test_refusals_mirror_jax(name, tmp_path):
    extra, member, flag = REFUSED[name]
    j, _ = _pair(torch.float64)
    assert not hasattr(j, member)  # JAX's AttributeError at that member
    meth, phen = _files(tmp_path)
    args = _args(tmp_path, meth, phen, "x", "--dtype", "float64", *extra)
    if name == "multi_trait":
        args[args.index("--phen-files") + 1] = f"{phen},{phen}"
    if name == "pvals_calc":
        plink.write_bed(str(tmp_path / "unused.bed"),
                        np.zeros((1, 4), np.uint8))
        vecio.write_bin_shard(str(tmp_path / "e.bin"), np.ones(M), 0)
        args += ["--estimate-file", str(tmp_path / "e.bin")]
    with pytest.raises(NotImplementedError, match=flag.replace("-", r"\-")):
        tcli.main(["--device", "cpu"] + args)


def test_predict_modes_refuse_meth(tmp_path):
    """The JAX predict modes read --bed-file-test as .bed genotypes
    whatever --type-data says (gvamp_tpu/cli.py:765-770); the port refuses
    the combination rather than read a .meth file as packed genotypes."""
    meth, _ = _files(tmp_path)
    for mode in ("predict", "predict_single"):
        with pytest.raises(NotImplementedError, match="--type-data meth"):
            tcli.main(["--device", "cpu", "--run-mode", mode, "--type-data",
                       "meth", "--bed-file-test", meth, "--N-test", str(N),
                       "--Mt-test", str(M), "--estimate-file",
                       str(tmp_path / "e.bin"), "--out-dir",
                       str(tmp_path / "out")])
