"""The probe path of every engine of the port (``use_slq=False``: the
Onsager traces from Hutchinson probe columns riding the block CG, JAX's
``gvamp_tpu/linear.py:821-861``) against the JAX package: the linear
engine primal (folded and explicit noise pass, complete and with missing
calls) and dual, one step from a converted state with probe columns, and
the probit and Huber engines (the multi-trait engines' probe path:
tests/test_torch_probe_multi.py).  The recipes and limits are those of
tests/test_torch_linear.py, test_torch_probit.py and test_torch_robust.py;
both sides get JAX's probe (and JAX's initial p1 and Monte-Carlo draws),
and the probe columns must exit at the same CG iteration on both sides
(``probe_iters``)."""

import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
import test_torch_linear as tl_
import test_torch_probit as tp_
import test_torch_robust as tr_

torch.set_num_threads(1)

NO_SLQ = dict(use_slq=False)


@pytest.fixture
def f32_probe(monkeypatch):
    """JAX's probe in the engine dtype wherever its engines draw it (see
    tests/test_torch_probit.py's docstring)."""
    real = jlinear.make_bern_probe

    def probe(g, seed, n=1):
        return real(g, seed, n).astype(g.dtype)

    for mod in (jlinear, jprobit, jrobust):
        monkeypatch.setattr(mod, "make_bern_probe", probe)


def _iters(h, key):
    return [int(np.asarray(m[key]).max()) for m in h]


# --------------------------------------------------------------------------
# the linear engine
# --------------------------------------------------------------------------

# (miss, dt, extra cfg): the folded noise pass (trace from the exit Gram
# identity) and the explicit one (trace <A u, A q> from one forward pass)
LINEAR = [(miss, dt, {}) for miss in (0.0, 0.02)
          for dt in (torch.float64, torch.float32)]
LINEAR += [(0.02, torch.float32, dict(fold_noise=False))]


@pytest.mark.parametrize("miss,dt,kw", LINEAR)
def test_linear_primal_recipe_matches_jax(miss, dt, kw, f32_probe):
    """Six iterations of tests/test_torch_linear.py's recipe on the probe
    path, to that recipe's limits: f64 the same CG and probe counts and x1
    within 1e-8 of max|x1|; f32 x1 within 5e-5 and the scalars within
    rtol 2e-4."""
    prob = tl_._make_problem(miss)
    beta, vars_t, probs_t = prob[2:5]
    j, t = tl_._genos(prob, dt)
    cfg_j = jlinear.VampConfig(max_iter=6, **tl_.CFG, **NO_SLQ, **kw)
    cfg_t = tlinear.VampConfig(max_iter=6, **tl_.CFG, **NO_SLQ, **kw)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, s_j, h_j = jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, s_t, h_t = tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                  bern=bern)
    assert len(h_t) == len(h_j) == 6
    assert s_t.mu_probe.shape == (t.Mpad, 1) and s_t.gmu.shape[1] == 2
    assert _iters(h_t, "cg_iters") == _iters(h_j, "cg_iters")
    assert _iters(h_t, "probe_iters") == _iters(h_j, "probe_iters")
    assert min(_iters(h_t, "probe_iters")) > 0
    if dt == torch.float64:
        assert tl_._rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert tl_._rel(x_t, x_j) < 5e-5
        rtol = 2e-4
    for k in ("gam1", "gam2", "gamw", "alpha2", "R2_train_2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.9


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_linear_one_step_with_probe_columns(dt, f32_probe):
    """Three JAX iterations on the probe path (probe warm starts, tracked
    Gram and secant pair armed), then one step on each side from the same
    converted state: STEP_TOL on the scalars, x1 and the probe columns'
    warm starts."""
    prob = tl_._make_problem(0.02)
    vars_t, probs_t = prob[3:5]
    j, _ = tl_._genos(prob, dt)
    cfg_j = jlinear.VampConfig(max_iter=4, **tl_.CFG, **NO_SLQ)
    aux_j = jlinear.make_aux(j, cfg_j)
    step_j = jlinear.make_step(j, cfg_j)
    state0 = jlinear.init_state(j, cfg_j, probs_t, vars_t)
    for _ in range(3):
        state0, _ = step_j(state0, aux_j)
    state_j, m_j = step_j(state0, aux_j)
    t = convert.geno_from_numpy(np.asarray(j.words), np.asarray(prob[1]),
                                N=tl_.N, M=tl_.M, standardize_phen=False,
                                mave=np.asarray(j.mave),
                                msig=np.asarray(j.msig), dtype=dt,
                                device="cpu")
    cfg_t = tlinear.VampConfig(max_iter=4, **tl_.CFG, **NO_SLQ)
    aux_t = convert.aux_from_numpy(t, cfg_t, np.asarray(aux_j.bern))
    assert aux_t.slq is None
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in state0._asdict().items()}, dtype=dt,
        device="cpu")
    state_t, m_t = tlinear.make_step(t, cfg_t)(st, aux_t)
    assert int(m_t["probe_iters"]) == int(m_j["probe_iters"])
    for k in tl_.SCALARS:
        assert tl_._rel(m_t[k], m_j[k]) < tl_.STEP_TOL[dt], k
    for k in ("x1", "mu_probe", "gmu", "mu_prevb"):
        assert tl_._rel(getattr(state_t, k), getattr(state_j, k)) \
            < tl_.STEP_TOL[dt], k


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_linear_dual_recipe_matches_jax(dt, f32_probe):
    """The dual solve with the probe columns z_u = A u in its N-space block
    CG (Woodbury alpha2 = 1 - gamw <z_u, Q_N^{-1} z_u>), six iterations
    on 2% missing calls, to tests/test_torch_linear.py's recipe limits."""
    prob = tl_._make_problem(0.02)
    beta, vars_t, probs_t = prob[2:5]
    j, t = tl_._genos(prob, dt)
    kw = dict(use_xxt=True, **NO_SLQ)
    cfg_j = jlinear.VampConfig(max_iter=6, **tl_.CFG, **kw)
    cfg_t = tlinear.VampConfig(max_iter=6, **tl_.CFG, **kw)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, s_j, h_j = jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, s_t, h_t = tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                  bern=bern)
    assert s_t.mu_probe_n.shape == tuple(t.y_planar.shape) + (1,)
    assert _iters(h_t, "cg_iters") == _iters(h_j, "cg_iters")
    if dt == torch.float64:
        assert _iters(h_t, "probe_iters") == _iters(h_j, "probe_iters")
        assert tl_._rel(x_t, x_j) < 1e-8
        assert tl_._rel(s_t.mu_probe_n, s_j.mu_probe_n) < 1e-8
        rtol = 1e-8
    else:
        assert tl_._rel(x_t, x_j) < 5e-5
        rtol = 2e-4
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.9


# --------------------------------------------------------------------------
# the probit and Huber engines
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_probit_recipe_matches_jax(dt, f32_probe):
    """tests/test_torch_probit.py's recipe with covariates and 2% missing
    calls on the probe path, to its limits (f64: the same CG counts, x1
    within 1e-8, scalars rtol 1e-8; f32: x1 within 1e-4, scalars 5e-4)."""
    prob = tp_._problem(0.02, 2)
    beta, vars_t, probs_t = prob[2:5]
    j, t = tp_._genos(prob, dt)
    cfg_j = jprobit.ProbitConfig(max_iter=6, **tp_.CFG, **NO_SLQ)
    cfg_t = tprobit.ProbitConfig(max_iter=6, **tp_.CFG, **NO_SLQ)
    bern = np.asarray(jprobit.make_bern_probe(j, cfg_j.seed, 1))
    p1 = np.asarray(jprobit.init_state(j, cfg_j, probs_t, vars_t).p1)
    x_j, s_j, h_j = jprobit.infer(j, cfg_j, probs_t, vars_t,
                                  true_signal=beta, verbose=False)
    x_t, s_t, h_t = tprobit.infer(t, cfg_t, probs_t, vars_t,
                                  true_signal=beta, verbose=False, bern=bern,
                                  p1=p1)
    assert s_t.mu_probe.shape == (t.Mpad, 1)
    assert len(h_t) == len(h_j) == 6
    if dt == torch.float64:
        assert _iters(h_t, "cg_iters") == _iters(h_j, "cg_iters")
        assert tp_._rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert tp_._rel(x_t, x_j) < 1e-4
        rtol = 5e-4
    for k in ("gam1", "gam2", "tau1", "tau2", "alpha2", "corr_x1"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.5


def _keep_x1(store):
    def cb(it, state, m, g):
        store.append(np.asarray(
            state.x1.cpu() if isinstance(state.x1, torch.Tensor)
            else state.x1, np.float64))
    return cb


def _held(jax32, jax64, rel, limit):
    """The f32 Huber runs on the probe path are held where JAX's own f32
    run follows its f64 run within the same limit: there the Hutchinson
    estimate's f32 rounding (alpha2 near its clip, gam1 = gam2 (1 -
    alpha2) / alpha2) has not yet grown past it.  On this recipe JAX's own
    f32 x1 is within 1.6e-6 of its f64 x1 through iteration 5 and 1.6e-3
    off at iteration 6; its multi-trait gam1 2.4e-4 off at iteration 2."""
    return rel(jax32, jax64) < limit


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_huber_recipe_matches_jax(dt, f32_probe):
    """tests/test_torch_robust.py's complete-genotype recipe on the probe
    path with JAX's draws: deltaH and the CG counts equal at every
    iteration; x1 within RECIPE_TOL at iteration 1 and after, and the
    scalars within its rtol, at every iteration in f64 and, in f32, at
    iterations 1-2 and wherever else JAX's own f32 run is within those
    limits of its f64 run (``_held``)."""
    prob = tr_._problem(0.0)
    beta, vars_t, probs_t = prob[2:5]
    runs = {}
    for side_dt in {dt, torch.float64}:
        j, t = tr_._genos(prob, side_dt)
        cfg_j = jrobust.RobustConfig(max_iter=6, **tr_.CFG, **NO_SLQ)
        x1_j = []
        _, _, h_j = jrobust.infer(j, cfg_j, probs_t, vars_t,
                                  true_signal=beta, verbose=False,
                                  callbacks=[_keep_x1(x1_j)])
        runs[side_dt] = (j, t, cfg_j, h_j, x1_j)
    j, t, cfg_j, h_j, x1_j = runs[dt]
    h_64, x1_64 = runs[torch.float64][3:]
    cfg_t = trobust.RobustConfig(max_iter=6, **tr_.CFG, **NO_SLQ)
    bern = np.asarray(jrobust.make_bern_probe(j, cfg_j.seed, 1))
    x1_t = []
    x_t, _, h_t = trobust.infer(t, cfg_t, probs_t, vars_t, true_signal=beta,
                                verbose=False, bern=bern,
                                mc_draws=tr_.jax_draws(j, cfg_j, 6),
                                callbacks=[_keep_x1(x1_t)])
    assert len(h_t) == len(h_j) == 6
    x_first, x_rest, rtol, keys = tr_.RECIPE_TOL[dt, 0.0]
    assert [float(h["deltaH"]) for h in h_t] == [float(h["deltaH"])
                                                 for h in h_j]
    assert _iters(h_t, "cg_iters") == _iters(h_j, "cg_iters")
    held = 0
    for i in range(6):
        lim = x_first if i == 0 else x_rest
        if _held(x1_j[i], x1_64[i], tr_._rel, lim):
            assert tr_._rel(x1_t[i], x1_j[i]) < lim, i
            held += 1
        for k in keys:
            # the scalars of iterations 1-2 are always held
            if i < 2 or _held(float(h_j[i][k]), float(h_64[i][k]),
                              tr_._rel, rtol):
                np.testing.assert_allclose(float(h_t[i][k]), float(h_j[i][k]),
                                           rtol=rtol, err_msg=(k, i))
    assert held >= 5
    assert np.isfinite(x_t).all() and np.corrcoef(x_t, beta)[0, 1] > 0.6
