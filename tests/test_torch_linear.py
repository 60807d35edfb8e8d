"""The port's linear VAMP path (gvamp_tpu_torch.linear / cli) against the
JAX package: one step from the same converted state, the 6-iteration
recipe of tests/test_linear_vamp.py (on complete genotypes and on
genotypes with 2% missing calls), the CLI dumps and p-value files, and an
import with JAX blocked.  JAX runs f32 through the Pallas kernels in
interpret mode and f64 through XLA; both sides get JAX's probe (jax.random
cannot be reproduced in torch)."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import sim as jsim
from gvamp_tpu.ops import pvals as jpvals
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink, vecio
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.ops import pvals as tpvals
from test_data_layer import make_bed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}
SCALARS = ("gam1", "gam2", "gamw", "alpha1", "alpha2")

# The recipe of tests/test_linear_vamp.py:203-238 (complete genotypes).
SEED, N, M, CV, H2 = 31, 500, 320, 20, 0.6
CFG = dict(rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=5)


def _make_problem(miss_rate):
    rng = np.random.default_rng(SEED)
    codes = jsim.random_genotypes(rng, M, N, miss_rate=miss_rate)
    vars_t, probs_t = jsim.two_group_prior(M, CV, H2)
    beta = jsim.simulate_mixture(rng, M, vars_t, probs_t)
    g = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=jnp.float64,
                             backend="xla")
    y = jsim.simulate_linear_phenotype(g, beta, 1 / (1 - H2), rng)
    return codes, y, beta, vars_t, probs_t


@pytest.fixture(scope="module")
def problem():
    return _make_problem(0.0)


@pytest.fixture(scope="module")
def problem_miss():
    """The same recipe with 2% missing calls (N = 500 is not a multiple of
    16): the general products axm_i8 / atxm_i8 on both sides."""
    return _make_problem(0.02)


def _genos(problem, dt):
    codes, y = problem[:2]
    j = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    j.set_phen(y)
    t = TGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=dt,
                             device="cpu")
    t.set_phen(y)
    return j, t


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


# One step from the same state, operator and probe: f64 agrees to 1e-9
# (two true-f64 engines, rounding order only); f32 to 1e-4 (the digit
# products agree to ~1e-7 and the CG solve amplifies that by its
# conditioning).
STEP_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


def _check_one_step(problem, dt):
    vars_t, probs_t = problem[3:5]
    j, t = _genos(problem, dt)
    cfg_j = jlinear.VampConfig(max_iter=4, **CFG)
    aux_j = jlinear.make_aux(j, cfg_j)
    step_j = jlinear.make_step(j, cfg_j)
    # three JAX iterations arm the tracked Gram product and the secant pair
    state0 = jlinear.init_state(j, cfg_j, probs_t, vars_t)
    for _ in range(3):
        state0, _ = step_j(state0, aux_j)
    state_j, m_j = step_j(state0, aux_j)

    # the port steps from the same 3-iteration state with JAX's probe and
    # JAX's statistics, so the step itself is the only difference
    t = convert.geno_from_numpy(np.asarray(j.words), np.asarray(problem[1]),
                                N=N, M=M, standardize_phen=False,
                                mave=np.asarray(j.mave),
                                msig=np.asarray(j.msig), dtype=dt,
                                device="cpu")
    cfg_t = tlinear.VampConfig(max_iter=4, **CFG)
    aux_t = convert.aux_from_numpy(t, cfg_t, np.asarray(aux_j.bern))
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in state0._asdict().items()}, dtype=dt,
        device="cpu")
    state_t, m_t = tlinear.make_step(t, cfg_t)(st, aux_t)

    assert state_t.it == int(state_j.it) == 4
    for k in SCALARS:
        assert _rel(m_t[k].detach(), m_j[k]) < STEP_TOL[dt], k
    assert _rel(state_t.x1, state_j.x1) < STEP_TOL[dt]
    # the port's state holds JAX's fields, the cross-validation one too
    # (-1 here, where no held-out R2 was taken); the dual (*_n) fields stay
    # zero in primal mode
    back = convert.state_to_numpy(state_t)
    assert set(jlinear.LinState._fields) == set(back)
    assert back["cv_r2"] == np.asarray(state_j.cv_r2) == -1
    for k in ("mu_cg_n", "mu_probe_n", "gmu_n"):
        assert not back[k].any() and back[k].shape == np.asarray(
            getattr(state_j, k)).shape
    assert set(back) <= set(jlinear.LinState._fields)
    return t


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_one_step_from_converted_state(problem, dt):
    assert _check_one_step(problem, dt).geno_complete


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_one_step_missing_genotypes(problem_miss, dt):
    """The step on genotypes with missing calls, to the same limits."""
    assert not _check_one_step(problem_miss, dt).geno_complete


def _check_six_iterations(problem, dt):
    """f64: cg_iters equal and x1 within 1e-8 of max|x1|.  f32: x1 within
    5e-5 of max|x1| and gam1/gam2/gamw/alpha2 within rtol 2e-4, the
    thresholds tests/test_linear_vamp.py holds the fused-Gram f32 run to."""
    beta, vars_t, probs_t = problem[2:5]
    j, t = _genos(problem, dt)
    cfg_j = jlinear.VampConfig(max_iter=6, **CFG)
    cfg_t = tlinear.VampConfig(max_iter=6, **CFG)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    x_j, _, h_j = jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                bern=bern)
    assert len(h_t) == len(h_j) == 6
    if dt == torch.float64:
        assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
        assert _rel(x_t, x_j) < 1e-8
    else:
        assert _rel(x_t, x_j) < 5e-5
        for k in ("gam1", "gam2", "gamw", "alpha2"):
            np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                       rtol=2e-4, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.9
    assert all(h["host_syncs"] > 0 and "wall_ms" not in h for h in h_t)
    return t


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_six_iteration_recipe_matches_jax(problem, dt):
    assert _check_six_iterations(problem, dt).geno_complete


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_six_iteration_recipe_missing_genotypes(problem_miss, dt):
    assert not _check_six_iterations(problem_miss, dt).geno_complete


# The routes that run the explicit noise pass: cfg.fold_noise=False, the
# environment switch GVAMP_NOISE_PASS=1 and the fused primal Gram
# (GVAMP_FUSED_GRAM=1), set on both sides; the 6-iteration recipe's limits.
NOISE_PASS_ROUTES = [("fold_noise", {}, dict(fold_noise=False)),
                     ("noise_pass_env", {"GVAMP_NOISE_PASS": "1"}, {}),
                     ("fused_gram", {"GVAMP_FUSED_GRAM": "1"}, {})]


@pytest.mark.parametrize("miss", [0.0, 0.02])
@pytest.mark.parametrize("route,env,kw", NOISE_PASS_ROUTES,
                         ids=[r[0] for r in NOISE_PASS_ROUTES])
def test_noise_pass_and_fused_gram_match_jax(problem, problem_miss, miss,
                                             route, env, kw, monkeypatch):
    """Six f32 iterations with the explicit noise pass (A x2 and z1 from one
    wide forward pass after the solve) on both sides, x1 within 5e-5 of
    max|x1| and the scalars within 2e-4; under GVAMP_FUSED_GRAM=1 the CG
    runs through fn_gram on both sides (the port's plain gram_i8a /
    gram_i8, JAX's Pallas kernels in interpret mode)."""
    prob = problem if miss == 0.0 else problem_miss
    beta, vars_t, probs_t = prob[2:5]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    j, t = _genos(prob, torch.float32)
    assert (t.fn_gram() is not None) == (route == "fused_gram")
    assert (j.fn_gram() is not None) == (route == "fused_gram")
    cfg_j = jlinear.VampConfig(max_iter=6, **CFG, **kw)
    cfg_t = tlinear.VampConfig(max_iter=6, **CFG, **kw)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    x_j, _, h_j = jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                bern=bern)
    assert len(h_t) == len(h_j) == 6
    assert _rel(x_t, x_j) < 5e-5
    for k in ("gam1", "gam2", "gamw", "alpha2", "R2_train_1", "R2_train_2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=2e-4, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.9


def test_fused_gram_launches_only_gram_in_the_cg(problem, monkeypatch):
    """Under GVAMP_FUSED_GRAM=1 every CG product of the primal solve goes
    through fn_gram (no two-pass product inside the CG), and the noise
    pass is one forward product per iteration."""
    from gvamp_tpu_torch.ops import matvec as tmv
    vars_t, probs_t = problem[3:5]
    monkeypatch.setenv("GVAMP_FUSED_GRAM", "1")
    _, t = _genos(problem, torch.float32)
    calls = {"gram_i8a": 0, "atxm_i8a": 0, "axm_i8a": 0}
    for name in calls:
        fn = getattr(tmv, name)

        def counted(*a, _f=fn, _n=name):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(tmv, name, counted)
    cfg = tlinear.VampConfig(max_iter=3, **CFG)
    _, _, hist = tlinear.infer(t, cfg, probs_t, vars_t, verbose=False)
    cg_total = sum(h["cg_iters"] for h in hist)
    # the SLQ basis (slq_k passes), the CG iterations and the refresh-tick
    # or cold-start init products are Gram calls; the two-pass transpose
    # runs only for A^T y at set-up
    assert calls["gram_i8a"] >= cfg.slq_k + cg_total
    assert calls["atxm_i8a"] == 1
    # A u at set-up, then one noise pass per iteration
    assert calls["axm_i8a"] == 1 + len(hist)


def test_cli_infere_dumps_match_library(problem, tmp_path):
    codes, y, _, vars_t, probs_t = problem
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    n_it = 3
    tcli.main(["--device", "cpu", "--run-mode", "infere", "--model", "linear",
               "--bed-file", bed, "--phen-files", phen, "--N", str(N),
               "--Mt", str(M), "--iterations", str(n_it), "--rho", "0.3",
               "--probs", ",".join(map(str, probs_t)),
               "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
               "--out-dir", str(tmp_path / "out"), "--out-name", "run"])
    pre = str(tmp_path / "out" / "run")
    g = TGenoBed.from_files(bed, phen, N=N, Mt=M, device="cpu")
    cfg = tlinear.VampConfig(max_iter=n_it, rho=0.3)
    x_lib, state, _ = tlinear.infer(g, cfg, probs_t, vars_t, verbose=False)
    dump = vecio.read_bin_shard(f"{pre}_it_{n_it}.bin", M, 0)
    # the dump scales the f32 x1 by 1/sqrt(N) in f64, as IterDumper does;
    # infer's f32 estimate is one f32 rounding away from it
    np.testing.assert_array_equal(dump, state.x1[:M].numpy() * (1 / np.sqrt(N)))
    np.testing.assert_allclose(dump, x_lib, rtol=2.0 ** -23)
    for it in range(1, n_it + 1):
        for name in (f"_r1_it_{it}.bin", f"_r2_it_{it}.bin",
                     f"_it_{it}_x2_hat.bin", f"_z1_it_{it}.csv"):
            assert os.path.getsize(pre + name) > 0
    for name in ("_gam1s.csv", "_gam2s.csv", "_R2trains.csv"):
        assert os.path.exists(pre + name)
    # --store-pip, once refused, writes the final posterior inclusion
    # probabilities (tests/test_torch_driver.py holds them against JAX's)
    tcli.main(["--device", "cpu", "--bed-file", bed, "--phen-files", phen,
               "--N", str(N), "--Mt", str(M), "--iterations", "1",
               "--probs", ",".join(map(str, probs_t)),
               "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
               "--out-dir", str(tmp_path / "out"), "--out-name", "pip",
               "--store-pip", "1"])
    p = vecio.read_bin_shard(str(tmp_path / "out" / "pip_pip.bin"), M, 0)
    assert np.all((p >= 0) & (p <= 1))
    # the marker mesh, once refused here, runs: --devices 2 (two shards on
    # the CPU, Mpad 1,024) writes the dumps of --devices 1 within f64 rtol
    # 1e-8 (tests/test_torch_dist*.py hold it against JAX's mesh); the
    # refusals left are those of ROADMAP.md Queue 3
    mesh_run = ["--device", "cpu", "--bed-file", bed, "--phen-files", phen,
                "--N", str(N), "--Mt", str(M), "--iterations", "2",
                "--probs", ",".join(map(str, probs_t)),
                "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
                "--dtype", "float64", "--out-dir", str(tmp_path / "out")]
    for k in ("1", "2"):
        tcli.main(mesh_run + ["--devices", k, "--out-name", f"dev{k}"])
    for it in (1, 2):
        for name in (f"_it_{it}.bin", f"_r1_it_{it}.bin", f"_r2_it_{it}.bin",
                     f"_it_{it}_x2_hat.bin"):
            np.testing.assert_allclose(
                vecio.read_bin_shard(f"{tmp_path}/out/dev2{name}", M, 0),
                vecio.read_bin_shard(f"{tmp_path}/out/dev1{name}", M, 0),
                rtol=1e-8, atol=1e-12, err_msg=name)


# |log10 p| of the CLI's f32 p-values against JAX's loo_pvals on the same
# z1 and x1: f32 moments and statistics in another order; the error grows
# with the t statistic, so it is bounded relative to max(1, |log10 p|)
CLI_LOG10P_TOL = 2e-6


def test_cli_store_pvals_on_missing_genotypes(problem_miss, tmp_path):
    """--store-pvals 1 with a .bim on 2% missing calls: the dumps, the LOO
    and LOCO p-value files and one predictor .csv per chromosome; the LOO
    file equals a library loo_pvals call on the same run and matches JAX's
    loo_pvals on the port's z1 and x1.  At --store-pvals 0 no p-values are
    written (the JAX CLI's own test, cli.py:176)."""
    codes, y, beta, vars_t, probs_t = problem_miss
    bed, phen, bim = (str(tmp_path / f"d.{e}") for e in ("bed", "phen", "bim"))
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    plink.write_bim(bim, np.repeat(np.arange(1, 5), M // 4))
    n_it = 3
    args = ["--device", "cpu", "--run-mode", "infere", "--model", "linear",
            "--bed-file", bed, "--phen-files", phen, "--bim-file", bim,
            "--N", str(N), "--Mt", str(M), "--iterations", str(n_it),
            "--rho", "0.3", "--probs", ",".join(map(str, probs_t)),
            "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
            "--out-dir", str(tmp_path / "out")]
    tcli.main(args + ["--store-pvals", "1", "--out-name", "run"])
    pre = str(tmp_path / "out" / "run")
    for it in range(1, n_it + 1):
        for name in (f"_it_{it}.bin", f"_r1_it_{it}.bin", f"_r2_it_{it}.bin",
                     f"_it_{it}_x2_hat.bin", f"_z1_it_{it}.csv"):
            assert os.path.getsize(pre + name) > 0
    for ch in range(1, 5):
        pred = np.loadtxt(f"{pre}_LOCO_chr_{ch}.csv")
        assert pred.shape[0] >= N and np.isfinite(pred).all()
    p_loo = vecio.read_bin_shard(pre + "_pvals.bin", M, 0)
    p_loco = vecio.read_bin_shard(pre + "_pvals_LOCO.bin", M, 0)
    assert np.all((p_loo > 0) & (p_loo <= 1) & (p_loco > 0) & (p_loco <= 1))

    g = TGenoBed.from_files(bed, phen, N=N, Mt=M, bim_path=bim, device="cpu")
    assert not g.geno_complete
    _, state, _ = tlinear.infer(g, tlinear.VampConfig(max_iter=n_it, rho=0.3),
                                probs_t, vars_t, verbose=False)
    np.testing.assert_array_equal(p_loo,
                                  tpvals.loo_pvals(g, state.z1, state.x1))
    np.testing.assert_array_equal(
        p_loco, tpvals.loco_pvals(g, state.z1, state.x1, g.chromosomes()))
    j = JGenoBed.from_files(bed, phen, N=N, Mt=M, dtype=jnp.float32,
                            backend="pallas")
    want = jpvals.loo_pvals(j, jnp.asarray(state.z1.numpy()),
                            jnp.asarray(state.x1.numpy()))
    lg, lw = np.log10(p_loo), np.log10(np.asarray(want))
    assert np.all(np.abs(lg - lw) <= CLI_LOG10P_TOL * np.maximum(1, -lw))
    # the causal markers carry the smallest p-values
    assert np.median(p_loo[beta != 0]) < np.median(p_loo[beta == 0])

    tcli.main(args + ["--store-pvals", "0", "--out-name", "quiet"])
    quiet = str(tmp_path / "out" / "quiet")
    assert os.path.exists(quiet + f"_it_{n_it}.bin")
    assert not os.path.exists(quiet + "_pvals.bin")
    assert not os.path.exists(quiet + "_pvals_LOCO.bin")


def test_red_ignores_use_slq(problem):
    """--red re-draws its window every iteration, so the fixed-Gram
    quadrature does not apply: it keeps its probe columns whatever
    use_slq says, bit for bit (tests/test_slq_engines.py:160-175)."""
    vars_t, probs_t = problem[3:5]
    _, t = _genos(problem, torch.float32)
    assert tlinear.probe_cols(tlinear.VampConfig(red=True)) == 1
    runs = [tlinear.infer(t, tlinear.VampConfig(max_iter=4, red=True,
                                                use_slq=flag),
                          probs_t, vars_t, verbose=False)
            for flag in (False, True)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for a, b in zip(runs[0][2], runs[1][2]):
        assert float(a["alpha2"]) == float(b["alpha2"])
        assert a["red_sbw"] == b["red_sbw"] and a["probe_iters"] > 0


def test_out_of_slice_options_raise(problem):
    vars_t, probs_t = problem[3:5]
    _, t = _genos(problem, torch.float64)
    # use_xxt left this list when the dual path was ported, fold_noise=False
    # when the explicit noise pass was (test_noise_pass_and_fused_gram_
    # match_jax), deflate_k > 0 when deflation was (tests/test_torch_
    # deflate.py), red, use_slq=False, sync_every and phase_timers when
    # the probe path and the driver options were (tests/test_torch_probe.py,
    # test_torch_red.py, test_torch_driver.py), use_cross_val when the
    # damping tuner was (tests/test_torch_crossval.py): they run here; the
    # multi-trait engines refuse the tuner, as the JAX CLI does
    from gvamp_tpu_torch import multi as tmulti
    with pytest.raises(NotImplementedError, match="use_cross_val"):
        tmulti._check_cfg(tlinear.VampConfig(use_cross_val=True))
    for kw, opts in ((dict(use_xxt=True, use_slq=False), {}),
                     (dict(red=True), {}), (dict(use_slq=False), {}),
                     (dict(use_cross_val=True), {}),
                     ({}, dict(sync_every=2)), ({}, dict(phase_timers=True))):
        x, _, h = tlinear.infer(t, tlinear.VampConfig(max_iter=2, **kw),
                                probs_t, vars_t, verbose=False, **opts)
        assert np.isfinite(x).all() and len(h) == 2


def test_port_imports_and_runs_without_jax():
    """In a fresh interpreter with JAX and the JAX package both blocked,
    every module of the port imports and tiny CPU inferences run with the
    port's own io, sim and native loader: linear (two-pass, then through
    the fused primal Gram's plain version under GVAMP_FUSED_GRAM=1, then
    dual through the fused dual Gram's) and probit with covariates."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["gvamp_tpu"] = None
import os, pkgutil, tempfile, importlib
import numpy as np
import gvamp_tpu_torch
for m in pkgutil.walk_packages(gvamp_tpu_torch.__path__, "gvamp_tpu_torch."):
    importlib.import_module(m.name)
from gvamp_tpu_torch import data, linear, native, probit, sim
from gvamp_tpu_torch.io import plink
from gvamp_tpu_torch.ops import matvec
rng = np.random.default_rng(0)
N, M = 200, 96
with tempfile.TemporaryDirectory() as tmp:
    bed = os.path.join(tmp, "d.bed")
    plink.write_bed(bed, sim.random_genotypes(rng, M, N))
    g = data.GenoBed.from_files(bed, None, N=N, Mt=M, standardize_phen=False,
                                device="cpu")
assert native.get_lib() is None or native.BUILD_DIR in native.get_lib()._name
vars_t, probs_t = sim.two_group_prior(M, 10, 0.5)
beta = sim.simulate_mixture(rng, M, vars_t, probs_t)
g.set_phen(sim.simulate_linear_phenotype(g, beta, 2.0, rng))
x, state, hist = linear.infer(g, linear.VampConfig(max_iter=3), probs_t,
                              vars_t, verbose=False)
assert np.isfinite(x).all() and len(hist) == 3
assert g.fn_gram() is None and g.fn_gram_aat() is not None
os.environ["GVAMP_FUSED_GRAM"] = "1"
matvec.reset_launches()
x, state, hist = linear.infer(g, linear.VampConfig(max_iter=3), probs_t,
                              vars_t, verbose=False)
assert g.fn_gram() is not None and np.isfinite(x).all() and len(hist) == 3
del os.environ["GVAMP_FUSED_GRAM"]
x, state, hist = linear.infer(g, linear.VampConfig(max_iter=3, use_xxt=True),
                              probs_t, vars_t, verbose=False)
assert np.isfinite(x).all() and len(hist) == 3 and state.gmu_n.abs().max() > 0
g.covs = rng.normal(size=(N, 2))
g.set_phen(sim.simulate_probit_phenotype(g, beta, 0.5, rng,
                                         cov_effects=np.array([0.3, -0.2])))
x, state, hist = probit.infer(g, probit.ProbitConfig(max_iter=3,
                                                     probit_var=0.5),
                              probs_t, vars_t, verbose=False)
assert np.isfinite(x).all() and len(hist) == 3
assert state.cov_eff.abs().max() > 0
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules
               if sys.modules[m] is not None)
assert not any(m == "gvamp_tpu" or m.startswith("gvamp_tpu.")
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("GVAMP_FUSED_GRAM", None)
    env.pop("GVAMP_NOISE_PASS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# an import of the JAX package or of JAX itself, at the start of a line
# (the indentation of a function-level import included)
_IMPORT_RE = re.compile(r"^\s*(from|import)\s+(gvamp_tpu|jax)(\.|\s|$)")


def test_port_sources_import_neither_jax_nor_the_jax_package():
    """No file of the port and no line of chip_smoke.py imports gvamp_tpu
    or jax, at any depth (the subprocess test above sees only what its
    run imports)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gvamp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    bad = [f"{f}:{i}: {line.strip()}" for f in files
           for i, line in enumerate(open(f), 1) if _IMPORT_RE.match(line)]
    assert not bad, bad
