"""The port's probit engine (gvamp_tpu_torch/probit.py, ops/special.py, the
covariate helpers of data.py and the CLI's --model bin_class) against the
JAX package: the special functions, the z-denoisers and the Newton
covariate solver, one step from a converted JAX state, and the 6-iteration
recipe of tests/test_probit.py:54 in f32 and f64, on complete genotypes and
with 2% missing calls, with and without covariates, through the two-pass
and the fused Gram.  JAX runs f32 through the Pallas kernels in interpret
mode and f64 through XLA.  Both sides get JAX's probe and JAX's initial p1
(jax.random cannot be reproduced in torch).

Under x64 (tests/conftest.py) the JAX package's probe is float64 (np.sqrt
promotes it), which makes its f32 engine's Onsager term alpha2 and that
term's clip (1 - 100 eps of alpha2's dtype, gvamp_tpu/probit.py:532) float64
too; the f32 runs here give JAX a float32 probe, the dtype it has on a TPU
without x64, so that both clip at the f32 bound."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import probit as jprobit
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink, vecio
from gvamp_tpu.linear import make_bern_probe as jax_bern_probe
from gvamp_tpu.ops import special as jspecial
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import sim as tsim
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.ops import special as tspecial
from test_data_layer import make_bed

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}

# The recipe of tests/test_probit.py:54-78, at 6 iterations
SEED, N, M, CV, H2, PV = 4, 1500, 300, 20, 0.9, 1.0
COV_EFF = np.array([0.25, -0.25])
CFG = dict(rho=0.3, seed=2, probit_var=PV)


# --------------------------------------------------------------------------
# special functions
# --------------------------------------------------------------------------

# over [-40, 40]: f64 within 1e-13 relative (erfc of the two libraries in
# the deep tail, measured 5.7e-14 near -35), f32 within 5e-6 (3.8e-6 near
# -11.9); values below 1000 normal-tiny are held absolutely to that bound;
# log Phi absolutely relative to max(1, |log Phi|) (log(1 - tiny) near 0);
# both sides overflow to inf at the same points (exp(x^2) beyond |x| ~ 26.6)
SPECIAL_TOL = {torch.float64: 1e-13, torch.float32: 5e-6}
SPECIAL_X = np.concatenate([np.linspace(-40, 40, 8001),
                            [-39.99, -25.3, -8.0001, -4.0, -3.9999, 3.9999,
                             4.0, 0.0, -1e-8, 1e-8]])


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["erfcx", "normal_cdf", "normal_logcdf",
                                  "phi_over_Phi"])
def test_special_functions_match_jax(name, dt):
    want = np.asarray(getattr(jspecial, name)(
        jnp.asarray(SPECIAL_X, JAX_DTYPE[dt])), np.float64)
    got = getattr(tspecial, name)(torch.tensor(SPECIAL_X, dtype=dt))
    assert got.dtype == dt
    got = got.double().numpy()
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    got, want = got[fin], want[fin]
    assert np.isfinite(got).all()
    tol = SPECIAL_TOL[dt]
    if name == "normal_logcdf":
        err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
        assert err.max() <= tol
        return
    tiny = 1e3 * np.finfo(np.float64 if dt == torch.float64
                          else np.float32).tiny
    big = np.abs(want) > tiny
    assert (np.abs(got - want)[big] <= tol * np.abs(want)[big]).all()
    assert (np.abs(got - want)[~big] <= tiny).all()


# --------------------------------------------------------------------------
# z-denoisers and the covariate solver
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_z_denoisers_match_jax(dt):
    rng = np.random.default_rng(1)
    n = 4000
    p = rng.normal(0, 3, n)
    p[:4] = [-30.0, 30.0, -12.0, 12.0]
    y = (rng.random(n) < 0.4).astype(np.float64)
    m_cov = rng.normal(0, 0.5, n)
    # f32: g1d cancels sgn c + ratio in the deep tail, where each side's
    # erfcx rounds differently: measured 7.9e-6 of max|g1d| (1e-12 in f64)
    tol = 1e-12 if dt == torch.float64 else 2e-5
    for tau1, pv in ((0.37, 1.0), (12.0, 0.5)):
        jargs = (jnp.asarray(p, JAX_DTYPE[dt]), jnp.asarray(tau1, JAX_DTYPE[dt]),
                 jnp.asarray(y, JAX_DTYPE[dt]), jnp.asarray(m_cov, JAX_DTYPE[dt]),
                 pv)
        targs = (torch.tensor(p, dtype=dt), torch.tensor(tau1, dtype=dt),
                 torch.tensor(y, dtype=dt), torch.tensor(m_cov, dtype=dt), pv)
        for fn in ("g1_bin_class", "g1d_bin_class"):
            want = np.asarray(getattr(jprobit, fn)(*jargs), np.float64)
            got = getattr(tprobit, fn)(*targs).double().numpy()
            np.testing.assert_allclose(got, want, rtol=tol,
                                       atol=tol * np.abs(want).max(),
                                       err_msg=fn)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_newton_cov_matches_jax(dt):
    """Pure-covariate probit data (tests/test_probit.py:42-52) with a
    genetic offset gg and 3% NA slots: the same effects (near the truth at
    probit_var 1), and the likelihood and its gradient at them, also at
    another probit_var (which only the line search reads)."""
    rng = np.random.default_rng(0)
    n, C = 4000, 3
    Z = rng.normal(size=(n, C))
    gg = rng.normal(0, 0.3, n)
    eta_true = np.array([0.5, -0.25, 0.8])
    y = (rng.random(n) < jsim_norm_cdf(Z @ eta_true + gg)).astype(np.float64)
    mask = (rng.random(n) > 0.03).astype(np.float64)
    jd = JAX_DTYPE[dt]
    t = [torch.tensor(a, dtype=dt) for a in (y, gg, Z, mask)]
    tol = 1e-10 if dt == torch.float64 else 2e-4
    for pv in (1.0, 0.7):
        want = np.asarray(jprobit.newton_cov(
            jnp.asarray(y, jd), jnp.asarray(gg, jd), jnp.asarray(Z, jd),
            jnp.zeros(C, jd), jnp.asarray(mask, jd), probit_var=pv))
        got = tprobit.newton_cov(t[0], t[1], t[2], torch.zeros(C, dtype=dt),
                                 t[3], probit_var=pv)
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_allclose(
        tprobit.newton_cov(t[0], t[1], t[2], torch.zeros(C, dtype=dt),
                           t[3]).numpy(), eta_true, atol=0.1)
    for fn in ("mlogL_probit", "grad_cov"):
        w = np.asarray(getattr(jprobit, fn)(
            jnp.asarray(y, jd), jnp.asarray(gg, jd), 0.7, jnp.asarray(Z, jd),
            jnp.asarray(want, jd), jnp.asarray(mask, jd)))
        g = getattr(tprobit, fn)(t[0], t[1], 0.7, t[2],
                                 torch.tensor(want, dtype=dt), t[3]).numpy()
        np.testing.assert_allclose(g, w, rtol=10 * tol, atol=10 * tol,
                                   err_msg=fn)


def jsim_norm_cdf(x):
    from scipy.stats import norm
    return norm.cdf(x)


def test_update_probit_var_matches_jax():
    """The probit-variance bisection (not called by the loop): with a huge
    eta the Monte-Carlo noise vanishes and both sides bisect the same
    function; a generator makes the port's draws reproducible."""
    rng = np.random.default_rng(2)
    n = 2000
    z_hat = rng.normal(0, 1.5, n)
    y = (rng.random(n) < 0.5).astype(np.float64)
    mask = np.ones(n)
    import jax
    want = float(jprobit.update_probit_var(
        jax.random.key(0), 1.0, 1e30, jnp.asarray(z_hat), jnp.asarray(y),
        jnp.asarray(mask)))
    gen = torch.Generator().manual_seed(0)
    got = float(tprobit.update_probit_var(
        gen, 1.0, 1e30, torch.tensor(z_hat), torch.tensor(y),
        torch.tensor(mask)))
    assert abs(got - want) <= 1e-9 * want
    a, b = (float(tprobit.update_probit_var(
        torch.Generator().manual_seed(5), 1.0, 4.0, torch.tensor(z_hat),
        torch.tensor(y), torch.tensor(mask))) for _ in range(2))
    assert a == b and 1e-10 < a < 1e10


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _make_problem(miss, n_cov):
    rng = np.random.default_rng(SEED)
    codes = jsim.random_genotypes(rng, M, N, miss_rate=miss)
    g = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=jnp.float64,
                             backend="xla")
    vars_t, probs_t = jsim.two_group_prior(M, CV, H2)
    beta = jsim.simulate_mixture(rng, M, vars_t, probs_t)
    covs = rng.normal(size=(N, 2)) if n_cov else None
    g.covs = covs
    y = jsim.simulate_probit_phenotype(g, beta, PV, rng,
                                       COV_EFF if n_cov else None)
    return codes, y, beta, vars_t, probs_t, covs


_PROBLEMS = {}


def _problem(miss, n_cov):
    key = (miss, n_cov)
    if key not in _PROBLEMS:
        _PROBLEMS[key] = _make_problem(miss, n_cov)
    return _PROBLEMS[key]


def _genos(prob, dt):
    codes, y, covs = prob[0], prob[1], prob[5]
    j = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    t = TGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=dt, device="cpu")
    for g in (j, t):
        g.covs = covs
        g.set_phen(y)
    return j, t


@pytest.fixture
def f32_probe(monkeypatch):
    """JAX's probe in the engine dtype (see the module docstring)."""
    monkeypatch.setattr(
        jprobit, "make_bern_probe",
        lambda g, seed, n=1: jax_bern_probe(g, seed, n).astype(g.dtype))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


STEP_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
SCALARS = ("gam1", "gam2", "tau1", "tau2", "alpha1", "alpha2", "beta1",
           "beta2")


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_one_step_from_converted_state(dt, f32_probe):
    """Two JAX iterations (covariate effects solved, tracked Gram and z2
    armed), then one step on each side from the same state, operator and
    probe, with covariates and 2% missing calls."""
    prob = _problem(0.02, 2)
    vars_t, probs_t = prob[3:5]
    j, _ = _genos(prob, dt)
    cfg_j = jprobit.ProbitConfig(max_iter=3, **CFG)
    aux_j = jprobit.make_aux(j, cfg_j)
    step_j = jprobit.make_step(j, cfg_j, n_cov=2)
    state0 = jprobit.init_state(j, cfg_j, probs_t, vars_t)
    for _ in range(2):
        state0, _ = step_j(state0, aux_j)
    state_j, m_j = step_j(state0, aux_j)
    t = convert.geno_from_numpy(np.asarray(j.words), prob[1], N=N, M=M,
                                standardize_phen=False,
                                mave=np.asarray(j.mave),
                                msig=np.asarray(j.msig), dtype=dt,
                                device="cpu")
    t.covs = prob[5]
    cfg_t = tprobit.ProbitConfig(max_iter=3, **CFG)
    aux_t = tprobit.make_aux(t, cfg_t, bern=np.asarray(aux_j.bern))
    st = convert.probit_state_from_numpy(
        {k: np.asarray(v) for k, v in state0._asdict().items()},
        device="cpu", dtype=dt)
    state_t, m_t = tprobit.make_step(t, cfg_t, n_cov=2)(st, aux_t)
    assert state_t.it == int(state_j.it) == 3
    assert int(m_t["cg_iters"]) == int(m_j["cg_iters"])
    for k in SCALARS:
        assert _rel(m_t[k].detach(), m_j[k]) < STEP_TOL[dt], k
    back = convert.state_to_numpy(state_t)
    assert set(back) == set(jprobit.ProbitState._fields)
    for k in ("x1", "x2", "r1", "z1", "z2", "p1", "gmu", "cov_eff"):
        assert _rel(back[k], getattr(state_j, k)) < STEP_TOL[dt], k


# f64: two true-f64 engines, x1 within 1e-8 of max|x1| and the same CG
# counts.  f32: the digit products agree to ~1e-7 and the solves amplify it:
# measured up to 4.0e-5 of max|x1| and 3.8e-5 relative on the scalars at
# these cases; limits 1e-4 and 5e-4.
RECIPE = [(torch.float64, miss, cov, "two-pass")
          for miss in (0.0, 0.02) for cov in (0, 2)]
RECIPE += [(torch.float32, miss, cov, route)
           for route in ("two-pass", "fused") for miss in (0.0, 0.02)
           for cov in (0, 2)]


@pytest.mark.parametrize("dt,miss,n_cov,route", RECIPE)
def test_six_iteration_recipe_matches_jax(dt, miss, n_cov, route, f32_probe,
                                          monkeypatch):
    prob = _problem(miss, n_cov)
    beta, vars_t, probs_t = prob[2:5]
    if route == "fused":
        monkeypatch.setenv("GVAMP_FUSED_GRAM", "1")
    j, t = _genos(prob, dt)
    assert t.geno_complete == (miss == 0.0)
    assert (t.fn_gram() is not None) == (route == "fused")
    assert (j.fn_gram() is not None) == (route == "fused")
    cfg_j = jprobit.ProbitConfig(max_iter=6, **CFG)
    cfg_t = tprobit.ProbitConfig(max_iter=6, **CFG)
    bern = np.asarray(jprobit.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    p1 = np.asarray(jprobit.init_state(j, cfg_j, probs_t, vars_t).p1)
    x_j, s_j, h_j = jprobit.infer(j, cfg_j, probs_t, vars_t,
                                  true_signal=beta, verbose=False)
    x_t, s_t, h_t = tprobit.infer(t, cfg_t, probs_t, vars_t,
                                  true_signal=beta, verbose=False, bern=bern,
                                  p1=p1)
    assert len(h_t) == len(h_j) == 6
    if dt == torch.float64:
        assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"])
                                                for h in h_j]
        assert _rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert _rel(x_t, x_j) < 1e-4
        rtol = 5e-4
    for k in ("gam1", "gam2", "tau1", "tau2", "alpha2", "corr_x1"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    if n_cov:
        np.testing.assert_allclose(np.asarray(h_t[-1]["cov_eff"]),
                                   np.asarray(h_j[-1]["cov_eff"]),
                                   rtol=rtol, atol=rtol)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.5
    assert all(h["host_syncs"] > 0 and "wall_ms" not in h for h in h_t)


def test_item_12_options_run():
    """The options that raised until the probe path and the driver options
    were ported run: red (probe columns only, as in JAX), use_slq=False,
    sync_every and phase_timers (their parity: tests/test_torch_probe.py,
    tests/test_torch_driver.py)."""
    prob = _problem(0.0, 0)
    vars_t, probs_t = prob[3:5]
    _, t = _genos(prob, torch.float64)
    for kw, opts in ((dict(red=True), {}), (dict(use_slq=False), {}),
                     ({}, dict(sync_every=2)), ({}, dict(phase_timers=True))):
        x, s, h = tprobit.infer(t, tprobit.ProbitConfig(max_iter=2, **kw),
                                probs_t, vars_t, verbose=False, **opts)
        assert np.isfinite(x).all() and len(h) == 2
        assert s.mu_probe.shape[1] == (1 if kw else 0)


def test_simulate_probit_phenotype_matches_jax():
    """The same genotypes, truth and generator state give the same binary
    phenotype through the port's simulation (f64 on both sides)."""
    prob = _problem(0.0, 2)
    j, t = _genos(prob, torch.float64)
    beta = prob[2]
    y_j = jsim.simulate_probit_phenotype(j, beta, PV,
                                         np.random.default_rng(7), COV_EFF)
    y_t = tsim.simulate_probit_phenotype(t, beta, PV,
                                         np.random.default_rng(7), COV_EFF)
    np.testing.assert_array_equal(y_t, y_j)
    assert 0.2 < y_t.mean() < 0.8


def test_covariate_helpers_match_jax(tmp_path):
    prob = _problem(0.0, 2)
    j, t = _genos(prob, torch.float64)
    path = str(tmp_path / "c.cov")
    plink.write_covariates(path, prob[5])
    j.read_covariates(path, 2)
    t.read_covariates(path, 2)
    np.testing.assert_array_equal(t.covs_np, j.covs_np)
    np.testing.assert_array_equal(t.covs_planar().numpy(),
                                  np.asarray(j.covs_planar()))
    eff = np.array([0.3, -1.2])
    np.testing.assert_allclose(t.zx(eff).numpy(), np.asarray(j.zx(eff)),
                               rtol=1e-15)


def test_cli_bin_class_matches_library(tmp_path):
    """--model bin_class with --cov-file / --C 2: the _probit_ dumps, the
    estimate equal to a library run on a container loaded the same way
    (phenotype not standardised, covariates read); --store-pip writes
    the final posterior inclusion probabilities under the _probit tag
    (held against JAX's in tests/test_torch_driver.py), and multi-trait
    bin_class (several
    --phen-files) runs since item 10 was (tests/test_torch_multi_zmodel.py),
    writing each trait's dumps."""
    codes, y, beta, vars_t, probs_t, covs = _problem(0.02, 2)
    bed, phen, cov = (str(tmp_path / f"d.{e}") for e in ("bed", "phen", "cov"))
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    plink.write_covariates(cov, covs)
    n_it = 3
    args = ["--device", "cpu", "--run-mode", "infere", "--model", "bin_class",
            "--bed-file", bed, "--phen-files", phen, "--cov-file", cov,
            "--C", "2", "--probit-var", str(PV), "--N", str(N), "--Mt",
            str(M), "--iterations", str(n_it), "--rho", "0.3",
            "--probs", ",".join(map(str, probs_t)),
            "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
            "--out-dir", str(tmp_path / "out")]
    tcli.main(args + ["--out-name", "run"])
    pre = str(tmp_path / "out" / "run")
    for it in range(1, n_it + 1):
        for name in (f"_probit_it_{it}.bin", f"_probit_r1_it_{it}.bin",
                     f"_probit_z1_it_{it}.csv", f"_probit_p1_it_{it}.csv"):
            assert os.path.getsize(pre + name) > 0
    g = TGenoBed.from_files(bed, phen, N=N, Mt=M, standardize_phen=False,
                            device="cpu")
    g.read_covariates(cov, 2)
    cfg = tprobit.ProbitConfig(max_iter=n_it, rho=0.3, probit_var=PV,
                               gam1_init=1e-8)
    x_lib, state, _ = tprobit.infer(g, cfg, probs_t, vars_t, verbose=False)
    dump = vecio.read_bin_shard(f"{pre}_probit_it_{n_it}.bin", M, 0)
    np.testing.assert_array_equal(dump,
                                  state.x1[:M].numpy() * (1 / np.sqrt(N)))
    np.testing.assert_allclose(dump, x_lib, rtol=2.0 ** -23)
    assert state.cov_eff.abs().max() > 0
    tcli.main(args + ["--out-name", "x", "--store-pip", "1"])
    p = vecio.read_bin_shard(str(tmp_path / "out" / "x_probit_pip.bin"),
                             M, 0)
    assert np.all((p >= 0) & (p <= 1))
    assert np.median(p[beta != 0]) > np.median(p[beta == 0])
    tcli.main(args + ["--out-name", "x", "--phen-files", f"{phen},{phen}"])
    for t in range(2):
        d = vecio.read_bin_shard(
            str(tmp_path / "out" / f"x_phen{t}_probit_it_{n_it}.bin"), M, 0)
        assert np.isfinite(d).all() and np.corrcoef(d, beta)[0, 1] > 0.5
