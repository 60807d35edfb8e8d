"""The port's multi-trait z-model engines (gvamp_tpu_torch/multi.py: probit
and Huber) against the JAX package's: one step from the same converted
state and a 6-iteration recipe each, f64 and f32.  Probit runs T=3 binary
traits with 2 covariates on tests/test_multi.py's genotypes (1% missing
calls, one trait with NA phenotypes); Huber T=2 heavy-tailed traits on
tests/test_robust.py's shape (N=1,500 x M=300, complete genotypes), the
stable recipe of tests/test_torch_robust.py, with JAX's Monte-Carlo draws
injected (rebuilt from the key sequence of gvamp_tpu/multi.py:1250-1251).
Both sides get JAX's probe in the engine dtype (under x64 JAX's probe is
float64, which would make its f32 engine's alpha2 clip a float64 one, as
tests/test_torch_probit.py explains)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import multi as jmulti
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu import sim as jsim
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import multi as tmulti
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
from test_torch_multi import (jax_geno, port_geno, port_mp_from_jax,
                              problem, rel, state_arrays)

torch.set_num_threads(1)

PV = 1.0
COV_EFF = np.array([0.25, -0.25])
P_CFG = dict(rho=0.3, seed=2, probit_var=PV, stop_criteria_thr=0.0)
H_CFG = dict(rho=0.3, seed=5, stop_criteria_thr=0.0)
# tests/test_robust.py:53-73's shape, two traits
H_SEED, H_N, H_M, H_T = 9, 1500, 300, 2


@pytest.fixture
def f32_probe(monkeypatch):
    """JAX's probe in the engine dtype (see the module docstring)."""
    real = jlinear.make_bern_probe
    monkeypatch.setattr(jlinear, "make_bern_probe",
                        lambda g, seed, n=1: real(g, seed, n).astype(g.dtype))


_PROBIT = {}


def probit_problem():
    """Binary traits (probit_var 1, covariate effects COV_EFF) on the multi
    recipe's genotypes with 1% missing calls; trait 1 gets NA phenotypes."""
    if not _PROBIT:
        codes, _, betas, _ = problem(0.01)
        n, m = len(codes[0]), len(codes)
        rng = np.random.default_rng(4)
        covs = rng.normal(size=(n, 2))
        g = jax_geno(codes, torch.float64, covs=covs)
        vars_t, probs_t = jsim.two_group_prior(m, 15, 0.6)
        ys = []
        for t, beta in enumerate(betas):
            y = jsim.simulate_probit_phenotype(g, beta, PV, rng, COV_EFF)
            if t == 1:
                y[rng.choice(n, 25, replace=False)] = np.nan
            ys.append(y)
        _PROBIT.update(codes=codes, ys=ys, betas=betas, covs=covs,
                       prior=(probs_t, vars_t))
    return _PROBIT


_HUBER = {}


def huber_problem():
    """tests/test_torch_robust.py's recipe (h2 0.9, y = A (sqrt(N) beta) +
    0.5 t(3)) for two traits on complete genotypes."""
    if not _HUBER:
        rng = np.random.default_rng(H_SEED)
        codes = jsim.random_genotypes(rng, H_M, H_N, miss_rate=0.0)
        g = jax_geno(codes, torch.float64, n=H_N)
        vars_t, probs_t = jsim.two_group_prior(H_M, 20, 0.9)
        ys, betas = [], []
        for _ in range(H_T):
            beta = jsim.simulate_mixture(rng, H_M, vars_t, probs_t)
            x = g.pad_m(beta * np.sqrt(H_N))
            ys.append(g.deplanarize(g.ax(jnp.asarray(x)))[:H_N]
                      + rng.standard_t(3.0, H_N) * 0.5)
            betas.append(beta)
        _HUBER.update(codes=codes, ys=ys, betas=betas,
                      prior=(probs_t, vars_t))
    return _HUBER


def jax_draws(jmp, cfg, n_it, start=0):
    """JAX's em_deltaH draws of iterations start+1 .. start+n_it as
    [T, mc, 4 Nb] blocks: key(seed + 2) split once per iteration, the
    subkey split into one key per trait (gvamp_tpu/multi.py:1195,
    1250-1251)."""
    key = jax.random.key(cfg.seed + 2)
    nb4 = int(np.prod(jmp.y.shape[:2]))
    out = []
    for i in range(start + n_it):
        key, sub = jax.random.split(key)
        if i >= start:
            keys = jax.random.split(sub, jmp.T)
            out.append(np.stack([np.asarray(jax.random.normal(
                keys[t], (cfg.mc_steps, nb4), jmp.geno.dtype))
                for t in range(jmp.T)]))
    return out


STEP_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
Z_SCALARS = ("gam1", "gam2", "tau1", "tau2", "alpha1", "alpha2", "beta1")


def _one_step(engine, dt, jmp, cfg_j, cfg_t, n_prior, covs=None):
    """Two JAX iterations, then one step on each side from the same state;
    returns (JAX state, JAX metrics, port state, port metrics)."""
    if engine == "probit":
        aux_j = jmulti.make_probit_aux(jmp, cfg_j)
        step_j = jmulti.make_probit_step(jmp, cfg_j, n_cov=2)
        state0 = jmulti.init_probit_state(jmp, cfg_j, *n_prior, n_cov=2)
    else:
        aux_j = jmulti.make_probit_aux(jmp, cfg_j)
        step_j = jmulti.make_huber_step(jmp, cfg_j)
        state0 = jmulti.init_huber_state(jmp, cfg_j, *n_prior)
    for _ in range(2):
        state0, _ = step_j(state0, aux_j)
    state_j, m_j = step_j(state0, aux_j)
    tmp = port_mp_from_jax(jmp, dt, covs=covs)
    aux_t = tmulti.make_probit_aux(tmp, cfg_t, bern=np.asarray(aux_j.bern))
    arrays = state_arrays(state0)
    if engine == "probit":
        st = convert.probit_multi_state_from_numpy(arrays, device="cpu",
                                                   dtype=dt)
        state_t, m_t = tmulti.make_probit_step(tmp, cfg_t, n_cov=2)(st, aux_t)
    else:
        st = convert.huber_multi_state_from_numpy(arrays, device="cpu",
                                                  dtype=dt, gen=cfg_t.seed)
        eps = jax_draws(jmp, cfg_j, 1, start=2)[0]
        state_t, m_t = tmulti.make_huber_step(tmp, cfg_t)(st, aux_t, eps)
    assert state_t.it == int(state_j.it) == 3
    return state_j, m_j, state_t, m_t


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_probit_one_step_from_converted_state(dt, f32_probe):
    """Covariate effects solved at iteration 1, tracked Gram armed; the
    step from JAX's iteration-2 state with 2 covariates and 1% missing
    calls."""
    pp = probit_problem()
    jmp = jmulti.MultiPhen.build(jax_geno(pp["codes"], dt, covs=pp["covs"]),
                                 pp["ys"], standardize=False)
    state_j, m_j, state_t, m_t = _one_step(
        "probit", dt, jmp, jprobit.ProbitConfig(max_iter=3, **P_CFG),
        tprobit.ProbitConfig(max_iter=3, **P_CFG), pp["prior"],
        covs=pp["covs"])
    np.testing.assert_array_equal(m_t["cg_iters"].numpy(),
                                  np.asarray(m_j["cg_iters"]))
    for k in Z_SCALARS + ("beta2",):
        assert rel(m_t[k], m_j[k]) < STEP_TOL[dt], k
    back = convert.state_to_numpy(state_t)
    assert set(back) == set(jmulti.ProbitMultiState._fields)
    for k in ("x1", "x2", "r1", "z1", "z2", "p1", "p2", "gmu", "cov_eff"):
        assert back[k].shape == np.asarray(getattr(state_j, k)).shape, k
        assert rel(back[k], getattr(state_j, k)) < STEP_TOL[dt], k


# f64: x within 1e-8 of max|x| and the same CG counts; f32: x within 1e-4
# of max|x| and the scalars within 5e-4 (the single-trait probit recipe's
# limits, tests/test_torch_probit.py)
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_probit_recipe_matches_jax(dt, f32_probe):
    pp = probit_problem()
    j = jax_geno(pp["codes"], dt, covs=pp["covs"])
    t = port_geno(pp["codes"], dt, covs=pp["covs"])
    jmp = jmulti.MultiPhen.build(j, pp["ys"], standardize=False)
    tmp = tmulti.MultiPhen.build(t, pp["ys"], standardize=False)
    cfg_j = jprobit.ProbitConfig(max_iter=6, **P_CFG)
    cfg_t = tprobit.ProbitConfig(max_iter=6, **P_CFG)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, s_j, h_j = jmulti.infer_probit(jmp, cfg_j, *pp["prior"],
                                        verbose=False)
    x_t, s_t, h_t = tmulti.infer_probit(tmp, cfg_t, *pp["prior"],
                                        verbose=False, bern=bern)
    assert len(h_t) == len(h_j) == 6
    if dt == torch.float64:
        for a, b in zip(h_t, h_j):
            np.testing.assert_array_equal(a["cg_iters"],
                                          np.asarray(b["cg_iters"]))
        assert rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert rel(x_t, x_j) < 1e-4
        rtol = 5e-4
    for k in ("gam1", "gam2", "tau1", "tau2", "alpha2"):
        np.testing.assert_allclose(h_t[-1][k], np.asarray(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(s_t.cov_eff.numpy(), np.asarray(s_j.cov_eff),
                               rtol=rtol, atol=rtol)
    for tr, beta in enumerate(pp["betas"]):
        assert np.corrcoef(x_t[:, tr], beta)[0, 1] > 0.5, tr
    assert all(h["host_syncs"] > 0 and "wall_ms" not in h for h in h_t)


def test_huber_one_step_from_converted_state(f32_probe):
    """The step from JAX's iteration-2 state with JAX's draws of iteration
    3; f64 on the stable recipe.  The port's state holds JAX's fields
    with ``gen`` for ``key``."""
    hp = huber_problem()
    dt = torch.float64
    jmp = jmulti.MultiPhen.build(jax_geno(hp["codes"], dt, n=H_N), hp["ys"])
    state_j, m_j, state_t, m_t = _one_step(
        "huber", dt, jmp, jrobust.RobustConfig(max_iter=3, **H_CFG),
        trobust.RobustConfig(max_iter=3, **H_CFG), hp["prior"])
    np.testing.assert_array_equal(m_t["cg_iters"].numpy(),
                                  np.asarray(m_j["cg_iters"]))
    np.testing.assert_array_equal(m_t["deltaH"].numpy(),
                                  np.asarray(m_j["deltaH"]))
    for k in Z_SCALARS:
        assert rel(m_t[k], m_j[k]) < STEP_TOL[dt], k
    back = convert.state_to_numpy(state_t)
    assert set(back) ^ set(jmulti.HuberMultiState._fields) == {"gen", "key"}
    for k in ("x1", "x2", "r1", "z1", "z2", "p1", "gmu", "deltaH"):
        assert rel(back[k], getattr(state_j, k)) < STEP_TOL[dt], k


# Six Huber iterations with JAX's draws: deltaH equal at every iteration,
# the same CG counts, and x1 at every iteration within the single-trait
# engine's complete-genotype limits (tests/test_torch_robust.py
# RECIPE_TOL): f64 1e-12 at iteration 1 and 1e-11 after, f32 1e-6 and
# 1e-4.  The scalars (gam1, tau1, tau2, alpha2): f64 within rtol 1e-10 at
# every iteration (measured 3.2e-12); f32 within 1e-4 at iterations 1-3
# (measured 2.2e-6, where JAX's own f32 run is within 1.2e-6 of its f64
# run).  From iteration 4 trait 0's gam2 falls to 1.5e-7 and alpha2
# towards its 1e-11 clip (trait 1's gam2 reaches the 1e-11 clamp at
# iteration 6), and JAX's own f32 run drifts 7.8e-4 (iteration 4) to 0.73
# (iteration 6) off its f64 run: past that point the f32 run is held on
# deltaH, the CG counts and x1 only.
H_RECIPE_TOL = {torch.float64: (1e-12, 1e-11, 1e-10, 6),
                torch.float32: (1e-6, 1e-4, 1e-4, 3)}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_huber_recipe_matches_jax(dt, f32_probe):
    hp = huber_problem()
    j, t = jax_geno(hp["codes"], dt, n=H_N), port_geno(hp["codes"], dt,
                                                        n=H_N)
    jmp = jmulti.MultiPhen.build(j, hp["ys"])
    tmp = tmulti.MultiPhen.build(t, hp["ys"])
    assert t.geno_complete
    cfg_j = jrobust.RobustConfig(max_iter=6, **H_CFG)
    cfg_t = trobust.RobustConfig(max_iter=6, **H_CFG)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x1s = {"jax": [], "port": []}

    def keep(side):
        def cb(it, state, m, g):
            x1s[side].append(np.asarray(
                state.x1.cpu() if isinstance(state.x1, torch.Tensor)
                else state.x1, np.float64))
        return cb

    _, _, h_j = jmulti.infer_huber(jmp, cfg_j, *hp["prior"], verbose=False,
                                   callbacks=[keep("jax")])
    x_t, _, h_t = tmulti.infer_huber(tmp, cfg_t, *hp["prior"], verbose=False,
                                     bern=bern,
                                     mc_draws=jax_draws(jmp, cfg_j, 6),
                                     callbacks=[keep("port")])
    assert len(h_t) == len(h_j) == 6
    x_first, x_rest, rtol, held = H_RECIPE_TOL[dt]
    for i, (a, b) in enumerate(zip(h_t, h_j)):
        np.testing.assert_array_equal(a["deltaH"], np.asarray(b["deltaH"]))
        np.testing.assert_array_equal(a["cg_iters"], np.asarray(b["cg_iters"]))
        for k in ("gam1", "tau1", "tau2", "alpha2")[:4 if i < held else 0]:
            np.testing.assert_allclose(a[k], np.asarray(b[k]), rtol=rtol,
                                       err_msg=f"{k} at iteration {i + 1}")
    for i, (xt, xj) in enumerate(zip(x1s["port"], x1s["jax"])):
        assert rel(xt, xj) < (x_first if i == 0 else x_rest), i
    assert np.isfinite(x_t).all()
    for tr, beta in enumerate(hp["betas"]):
        assert np.corrcoef(x_t[:, tr], beta)[0, 1] > 0.6, tr


def test_huber_generator_draws_are_reproducible():
    """Without injected draws the port draws T blocks per iteration from
    the state's generator: two runs give the same trajectory, the
    generator moves on by T blocks of [mc, 4 Nb] normals per iteration,
    and an earlier state keeps its own generator."""
    hp = huber_problem()
    tmp = tmulti.MultiPhen.build(port_geno(hp["codes"], torch.float32,
                                           n=H_N), hp["ys"])
    cfg = trobust.RobustConfig(max_iter=2, **H_CFG)
    states = []
    runs = [tmulti.infer_huber(tmp, cfg, *hp["prior"], verbose=False,
                               callbacks=[lambda it, s, m, g:
                                          states.append(s)])
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert np.isfinite(runs[0][0]).all()
    g0 = trobust.make_generator(cfg.seed + 2)
    nb4 = tmp.y.shape[0] * tmp.y.shape[1]
    for _ in range(H_T):
        torch.randn((cfg.mc_steps, nb4), generator=g0)
    assert torch.equal(states[0].gen.get_state(), g0.get_state())
    assert not torch.equal(states[0].gen.get_state(),
                           states[1].gen.get_state())
    assert torch.equal(states[1].gen.get_state(), states[3].gen.get_state())
