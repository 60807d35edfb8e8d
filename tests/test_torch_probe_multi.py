"""The probe path (``use_slq=False``) of the port's three multi-trait
engines against the JAX package's: T*P probe columns in the joint block
CG, the T*P-wide z_bern set-up pass, and the Hutchinson alpha2 and trace
(``gvamp_tpu/multi.py:340-360, 540-590, 935-944``), on the recipes and
to the limits of tests/test_torch_multi.py and
test_torch_multi_zmodel.py; the single-trait engines' probe path is in
tests/test_torch_probe.py, whose helpers this file shares."""

import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import multi as jmulti
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import multi as tmulti
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
from test_torch_probe import NO_SLQ, _held, _keep_x1, f32_probe  # noqa: F401
import test_torch_multi as tm_
import test_torch_multi_zmodel as tz_

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the multi-trait engines
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_multi_linear_recipe_matches_jax(dt):
    """tests/test_torch_multi.py's recipe (T=3, 1% missing calls, one trait
    with NA phenotypes) on the probe path: T*P probe columns in the joint
    CG and the T*P-wide z_bern set-up pass, to that recipe's limits."""
    codes, ys, betas, priors = tm_.problem(0.01)
    probs_t, vars_t = priors[0]
    j, t = tm_.jax_geno(codes, dt), tm_.port_geno(codes, dt)
    jmp, tmp = jmulti.MultiPhen.build(j, ys), tmulti.MultiPhen.build(t, ys)
    cfg_j = jlinear.VampConfig(max_iter=6, **tm_.CFG, **NO_SLQ)
    cfg_t = tlinear.VampConfig(max_iter=6, **tm_.CFG, **NO_SLQ)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, s_j, h_j = jmulti.infer(jmp, cfg_j, probs_t, vars_t, verbose=False)
    x_t, s_t, h_t = tmulti.infer(tmp, cfg_t, probs_t, vars_t, verbose=False,
                                 bern=bern)
    assert s_t.mu_probe.shape == (t.Mpad, tm_.T)
    assert len(h_t) == len(h_j) == 6
    if dt == torch.float64:
        for a, b in zip(h_t, h_j):
            np.testing.assert_array_equal(a["cg_iters"],
                                          np.asarray(b["cg_iters"]))
        assert tm_.rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert tm_.rel(x_t, x_j) < 5e-5
        rtol = 2e-4
    for k in ("gam1", "gam2", "gamw", "alpha2", "R2_train_1"):
        np.testing.assert_allclose(h_t[-1][k], np.asarray(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    for tr in range(tm_.T):
        assert np.corrcoef(x_t[:, tr], betas[tr])[0, 1] > 0.5, tr


def test_multi_linear_explicit_pass_matches_jax():
    """The explicit noise pass of the multi-trait engine on the probe path
    (trace <A_t u, A_t q> from z_bern), f64, to the recipe's limits."""
    codes, ys, _, priors = tm_.problem(0.01)
    probs_t, vars_t = priors[0]
    dt = torch.float64
    j, t = tm_.jax_geno(codes, dt), tm_.port_geno(codes, dt)
    jmp, tmp = jmulti.MultiPhen.build(j, ys), tmulti.MultiPhen.build(t, ys)
    kw = dict(max_iter=4, fold_noise=False, **tm_.CFG, **NO_SLQ)
    bern = np.asarray(jlinear.make_bern_probe(j, 3, 1))
    x_j, _, h_j = jmulti.infer(jmp, jlinear.VampConfig(**kw), probs_t,
                               vars_t, verbose=False)
    x_t, _, h_t = tmulti.infer(tmp, tlinear.VampConfig(**kw), probs_t,
                               vars_t, verbose=False, bern=bern)
    assert tm_.rel(x_t, x_j) < 1e-8
    np.testing.assert_allclose(h_t[-1]["gamw"], np.asarray(h_j[-1]["gamw"]),
                               rtol=1e-8)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_multi_probit_recipe_matches_jax(dt, f32_probe):
    """tests/test_torch_multi_zmodel.py's probit recipe on the probe path,
    to its limits."""
    pp = tz_.probit_problem()
    j = tm_.jax_geno(pp["codes"], dt, covs=pp["covs"])
    t = tm_.port_geno(pp["codes"], dt, covs=pp["covs"])
    jmp = jmulti.MultiPhen.build(j, pp["ys"], standardize=False)
    tmp = tmulti.MultiPhen.build(t, pp["ys"], standardize=False)
    cfg_j = jprobit.ProbitConfig(max_iter=6, **tz_.P_CFG, **NO_SLQ)
    cfg_t = tprobit.ProbitConfig(max_iter=6, **tz_.P_CFG, **NO_SLQ)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, s_j, h_j = jmulti.infer_probit(jmp, cfg_j, *pp["prior"],
                                        verbose=False)
    x_t, s_t, h_t = tmulti.infer_probit(tmp, cfg_t, *pp["prior"],
                                        verbose=False, bern=bern)
    assert s_t.mu_probe.shape == (t.Mpad, tmp.T)
    if dt == torch.float64:
        for a, b in zip(h_t, h_j):
            np.testing.assert_array_equal(a["cg_iters"],
                                          np.asarray(b["cg_iters"]))
        assert tm_.rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert tm_.rel(x_t, x_j) < 1e-4
        rtol = 5e-4
    for k in ("gam1", "gam2", "tau1", "tau2", "alpha2"):
        np.testing.assert_allclose(h_t[-1][k], np.asarray(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_multi_huber_recipe_matches_jax(dt, f32_probe):
    """tests/test_torch_multi_zmodel.py's Huber recipe on the probe path
    with JAX's draws: deltaH and the CG counts equal at every iteration,
    x1 within H_RECIPE_TOL, and the scalars within its rtol at every
    iteration in f64 and, in f32, where JAX's own f32 run is within that
    limit of its f64 run (``_held``)."""
    hp = tz_.huber_problem()
    runs = {}
    for side_dt in {dt, torch.float64}:
        j = tm_.jax_geno(hp["codes"], side_dt, n=tz_.H_N)
        jmp = jmulti.MultiPhen.build(j, hp["ys"])
        cfg_j = jrobust.RobustConfig(max_iter=6, **tz_.H_CFG, **NO_SLQ)
        x1_j = []
        _, _, h_j = jmulti.infer_huber(jmp, cfg_j, *hp["prior"],
                                       verbose=False,
                                       callbacks=[_keep_x1(x1_j)])
        runs[side_dt] = (j, jmp, cfg_j, h_j, x1_j)
    j, jmp, cfg_j, h_j, x1_j = runs[dt]
    h_64, x1_64 = runs[torch.float64][3:]
    t = tm_.port_geno(hp["codes"], dt, n=tz_.H_N)
    tmp = tmulti.MultiPhen.build(t, hp["ys"])
    cfg_t = trobust.RobustConfig(max_iter=6, **tz_.H_CFG, **NO_SLQ)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x1_t = []
    x_t, _, h_t = tmulti.infer_huber(tmp, cfg_t, *hp["prior"], verbose=False,
                                     bern=bern,
                                     mc_draws=tz_.jax_draws(jmp, cfg_j, 6),
                                     callbacks=[_keep_x1(x1_t)])
    x_first, x_rest, rtol, _ = tz_.H_RECIPE_TOL[dt]
    held = 0
    for i, (a, b, c) in enumerate(zip(h_t, h_j, h_64)):
        np.testing.assert_array_equal(a["deltaH"], np.asarray(b["deltaH"]))
        np.testing.assert_array_equal(a["cg_iters"], np.asarray(b["cg_iters"]))
        for k in ("gam1", "tau1", "tau2", "alpha2"):
            # per trait: the traits' scalars differ by orders of magnitude
            for tr in range(tmp.T):
                if _held(b[k][tr], c[k][tr], tm_.rel, rtol):
                    np.testing.assert_allclose(
                        a[k][tr], np.asarray(b[k][tr]), rtol=rtol,
                        err_msg=f"{k} of trait {tr} at iteration {i + 1}")
                    held += 1
        lim = x_first if i == 0 else x_rest
        if _held(x1_j[i], x1_64[i], tm_.rel, lim):
            assert tm_.rel(x1_t[i], x1_j[i]) < lim, i
    assert held >= 24
    assert np.isfinite(x_t).all()
