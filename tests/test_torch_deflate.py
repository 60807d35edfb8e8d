"""Spectral deflation of the port (gvamp_tpu_torch/cg.py: top_eigs,
make_deflated_precond and solve_block's precond; the linear and probit
engines with deflate_k > 0) against the JAX package.  Both sides start
top_eigs from JAX's block, rebuilt here from the key of
gvamp_tpu/linear.py:394 (jax.random cannot be reproduced in torch); the
bases are compared as the projector V V^T and the eigenvalues, never as
V, whose column signs depend on the QR library.  JAX runs f32 through the
Pallas kernels in interpret mode and f64 through XLA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import cg as jcg
from gvamp_tpu import linear as jlinear
from gvamp_tpu import probit as jprobit
from gvamp_tpu.probit import _gram_mult as jax_gram_mult
from gvamp_tpu_torch import cg as tcg
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import probit as tprobit
from test_torch_linear import CFG as LIN_CFG
from test_torch_linear import _genos as lin_genos
from test_torch_linear import _make_problem as lin_problem
from test_torch_probit import CFG as PROBIT_CFG
from test_torch_probit import _genos as probit_genos
from test_torch_probit import _problem as probit_problem

torch.set_num_threads(1)

K = 8


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


def jax_v0(j, seed, k=K):
    """JAX's start block of top_eigs: normal(fold_in(key(seed), 7))."""
    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed), 7), (j.Mpad, k), j.dtype))


_LIN = {}


def _lin(miss):
    if miss not in _LIN:
        _LIN[miss] = lin_problem(miss)
    return _LIN[miss]


# The same block power iteration in both libraries from the same block,
# relative to the largest entry: f64 the projector within 1e-12 and the
# eigenvalues within 1e-13 (measured 1.7e-15 / 5.9e-16, rounding and QR
# signs only); f32 within 1e-5 and 5e-6 (measured 6.1e-7 / 4.1e-7, the
# digit products' ~1e-7 through nine passes)
TOP_EIGS_TOL = {torch.float64: (1e-12, 1e-13), torch.float32: (1e-5, 5e-6)}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("miss", [0.0, 0.02])
def test_top_eigs_matches_jax(miss, dt):
    j, t = lin_genos(_lin(miss), dt)
    V_j, lam_j = jcg.top_eigs(jax_gram_mult(j), j.Mpad, K,
                              jax.random.fold_in(jax.random.key(5), 7),
                              n_iter=8, dtype=j.dtype, op=j.op)
    mult, op = tprobit._gram_mult(t), t.op
    V_t, lam_t = tcg.top_eigs(lambda X: mult(op, X), t.Mpad, K, n_iter=8,
                              dtype=dt, device="cpu", V0=jax_v0(j, 5))
    V_j, lam_j = np.asarray(V_j, np.float64), np.asarray(lam_j, np.float64)
    V_t, lam_t = V_t.double().numpy(), lam_t.double().numpy()
    ptol, ltol = TOP_EIGS_TOL[dt]
    assert _rel(V_t @ V_t.T, V_j @ V_j.T) < ptol
    assert _rel(lam_t, lam_j) < ltol
    np.testing.assert_allclose(V_t.T @ V_t, np.eye(K), atol=1e-5)
    # the port's own start block comes from its seeded generator: the same
    # basis twice, orthonormal, its Rayleigh values positive and below the
    # largest eigenvalue (eight rounds do not converge on this flat
    # spectrum, from either start)
    V_d, lam_d = tcg.top_eigs(lambda X: mult(op, X), t.Mpad, K, seed=5,
                              n_iter=8, dtype=dt, device="cpu")
    V_e, lam_e = tcg.top_eigs(lambda X: mult(op, X), t.Mpad, K, seed=5,
                              n_iter=8, dtype=dt, device="cpu")
    assert torch.equal(V_d, V_e) and torch.equal(lam_d, lam_e)
    np.testing.assert_allclose(V_d.double().T @ V_d.double(), np.eye(K),
                               atol=1e-5)
    lam_top = np.linalg.eigvalsh(V_j.T @ np.asarray(
        mult(op, torch.tensor(V_j, dtype=dt)), np.float64)).max()
    assert (lam_d > 0).all() and float(lam_d.max()) <= 1.01 * lam_top


@pytest.mark.parametrize("per_column", [False, True])
def test_deflated_precond_matches_jax(per_column):
    """M^{-1} r for scalar (tau, gam2) and for per-column [B] ones, f64
    within 1e-12; and on span(V) it is the exact inverse of
    tau S + gam2 I."""
    rng = np.random.default_rng(4)
    m, B = 300, 3
    V, _ = np.linalg.qr(rng.normal(size=(m, K)))
    lam = np.sort(rng.uniform(1, 50, K))[::-1].copy()
    r = rng.normal(size=(m, B))
    if per_column:
        tau, gam2 = rng.uniform(0.5, 4, B), rng.uniform(0.1, 2, B)
    else:
        tau, gam2 = 2.5, 0.7
    diag = 3.1
    want = np.asarray(jcg.make_deflated_precond(
        jnp.asarray(V), jnp.asarray(lam), jnp.asarray(tau),
        jnp.asarray(gam2), diag)(jnp.asarray(r)))
    f64 = dict(dtype=torch.float64)
    got = tcg.make_deflated_precond(
        torch.tensor(V), torch.tensor(lam), torch.tensor(tau, **f64),
        torch.tensor(gam2, **f64), diag)(torch.tensor(r)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    # on span(V): M^{-1} (tau S + gam2 I) V c = V c
    c = rng.normal(size=(K, B))
    tau_b = np.broadcast_to(tau, (B,))
    gam_b = np.broadcast_to(gam2, (B,))
    qv = V @ (c * (tau_b[None, :] * lam[:, None] + gam_b[None, :]))
    back = tcg.make_deflated_precond(
        torch.tensor(V), torch.tensor(lam), torch.tensor(tau, **f64),
        torch.tensor(gam2, **f64), diag)(torch.tensor(qv)).numpy()
    np.testing.assert_allclose(back, V @ c, rtol=1e-12, atol=1e-12)


def test_solve_block_precond_replaces_jacobi():
    """solve_block with the deflated preconditioner solves the same
    system as without it, in fewer iterations on a spectrum with a few
    large eigenvalues."""
    rng = np.random.default_rng(6)
    m = 400
    Q, _ = np.linalg.qr(rng.normal(size=(m, m)))
    ev = np.concatenate([np.geomspace(1e4, 1e2, K), rng.uniform(1, 2, m - K)])
    S = torch.tensor((Q * ev) @ Q.T)
    tau, gam2 = 1.0, 0.5
    V = torch.tensor(rng.normal(size=(m, 2)))

    def mult(P):
        return tau * (S @ P) + gam2 * P

    diag = float(tau * torch.diagonal(S).mean() + gam2)
    kw = dict(modes=(0, 0), err_tol=1e-10)
    plain = tcg.solve_block(mult, V, torch.zeros_like(V), diag, gam2, 500,
                            **kw)
    pre = tcg.make_deflated_precond(torch.tensor(Q[:, :K]),
                                    torch.tensor(ev[:K]), tau, gam2, diag)
    defl = tcg.solve_block(mult, V, torch.zeros_like(V), diag, gam2, 500,
                           precond=pre, **kw)
    want = torch.linalg.solve(tau * S + gam2 * torch.eye(m), V)
    for sol in (plain, defl):
        assert _rel(sol.mu, want) < 1e-8
    assert int(defl.iters.max()) < int(plain.iters.max())


# deflate_k = 8 through the engines, 6 iterations, JAX's probe and start
# block on both sides: the limits of the undeflated recipes
# (tests/test_torch_linear.py, tests/test_torch_probit.py), which the
# deflated runs meet as they stand
ENGINE_CASES = [("linear", torch.float64, 0.0), ("linear", torch.float32, 0.0),
                ("linear", torch.float64, 0.02),
                ("probit", torch.float64, 0.02),
                ("probit", torch.float32, 0.0)]


@pytest.fixture
def f32_probit_probe(monkeypatch):
    """JAX's probit probe in the engine dtype (tests/test_torch_probit.py)."""
    monkeypatch.setattr(
        jprobit, "make_bern_probe",
        lambda g, seed, n=1: jlinear.make_bern_probe(g, seed, n).astype(
            g.dtype))


@pytest.mark.parametrize("engine,dt,miss", ENGINE_CASES)
def test_deflated_engines_match_jax(engine, dt, miss, f32_probit_probe):
    if engine == "linear":
        prob = _lin(miss)
        beta, vars_t, probs_t = prob[2:5]
        j, t = lin_genos(prob, dt)
        cfg_j = jlinear.VampConfig(max_iter=6, deflate_k=K, **LIN_CFG)
        cfg_t = tlinear.VampConfig(max_iter=6, deflate_k=K, **LIN_CFG)
        bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed,
                                                  cfg_j.n_probes))
        x_j, _, h_j = jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False)
        x_t, _, h_t = tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                    bern=bern, defl_v0=jax_v0(j, cfg_j.seed))
        keys, xtol, rtol = (("gam1", "gam2", "gamw", "alpha2"),
                            (1e-8, 5e-5), (1e-8, 2e-4))
    else:
        prob = probit_problem(miss, 0)
        beta, vars_t, probs_t = prob[2:5]
        j, t = probit_genos(prob, dt)
        cfg_j = jprobit.ProbitConfig(max_iter=6, deflate_k=K, **PROBIT_CFG)
        cfg_t = tprobit.ProbitConfig(max_iter=6, deflate_k=K, **PROBIT_CFG)
        bern = np.asarray(jprobit.make_bern_probe(j, cfg_j.seed,
                                                  cfg_j.n_probes))
        p1 = np.asarray(jprobit.init_state(j, cfg_j, probs_t, vars_t).p1)
        x_j, _, h_j = jprobit.infer(j, cfg_j, probs_t, vars_t, verbose=False)
        x_t, _, h_t = tprobit.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                    bern=bern, p1=p1,
                                    defl_v0=jax_v0(j, cfg_j.seed))
        keys, xtol, rtol = (("gam1", "gam2", "tau1", "tau2", "alpha2"),
                            (1e-8, 1e-4), (1e-8, 5e-4))
    f64 = dt == torch.float64
    assert len(h_t) == len(h_j) == 6
    if f64:
        assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"])
                                                for h in h_j]
    assert _rel(x_t, x_j) < xtol[0 if f64 else 1]
    for k in keys:
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol[0 if f64 else 1], err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.5
