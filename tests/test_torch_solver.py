"""The port's solver core (prior, CG, SLQ) against the JAX package's, in
f64 on the same inputs.  Models: tests/test_prior.py, test_cg.py,
test_slq.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import cg as jcg
from gvamp_tpu import prior as jprior
from gvamp_tpu import slq as jslq
from gvamp_tpu_torch import cg as tcg
from gvamp_tpu_torch import prior as tprior
from gvamp_tpu_torch import slq as tslq

torch.set_num_threads(1)

# Both sides evaluate the same closed forms in f64 with another operation
# order: agreement to ~1e-12 relative, except where a recursion (CG, EM)
# compounds the rounding, held to 1e-10.
TIGHT = 1e-12
LOOSE = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _priors(probs, vars_):
    return (jprior.Prior(jnp.asarray(probs), jnp.asarray(vars_)),
            tprior.Prior(_t(probs), _t(vars_)))


def test_denoisers_match_jax():
    probs = np.array([0.85, 0.1, 0.04, 0.01])
    vars_ = np.array([0.0, 0.5, 5.0, 40.0])
    jp, tp = _priors(probs, vars_)
    r = np.linspace(-9, 9, 301)
    for gam1 in (1e-8, 0.3, 2.5, 1e4):
        _close(tprior.g1(_t(r), _t(gam1), tp), jprior.g1(jnp.asarray(r), gam1, jp),
               TIGHT, 1e-300)
        _close(tprior.g1d(_t(r), _t(gam1), tp),
               jprior.g1d(jnp.asarray(r), gam1, jp), TIGHT, 1e-300)
        _close(tprior.pip(_t(r), _t(gam1), tp),
               jprior.pip(jnp.asarray(r), gam1, jp), TIGHT, 1e-300)


@pytest.mark.parametrize("em_max_iter,vars_", [
    (2, [0.0, 0.8, 6.0, 6.2]),     # slots 2 and 3 merge
    (5, [0.0, 0.8, 6.0, 30.0]),    # EM early stop decides the count
    (0, [0.0, 1.0, 1.01, 9.0]),    # merge-only pass
])
def test_update_prior_matches_jax(em_max_iter, vars_):
    rng = np.random.default_rng(0)
    M, pad = 400, 112
    probs = np.array([0.85, 0.08, 0.05, 0.02])
    r1 = np.concatenate([rng.normal(0, 2.0, M), np.full(pad, 7.7)])
    mask = np.concatenate([np.ones(M), np.zeros(pad)])
    jp, tp = _priors(probs, np.array(vars_))
    want = jprior.update_prior(jnp.asarray(r1), 1.3, jp, jnp.asarray(mask),
                               float(M), em_max_iter=em_max_iter)
    got = tprior.update_prior(_t(r1), _t(1.3), tp, _t(mask), float(M),
                              em_max_iter=em_max_iter)
    _close(got.probs, want.probs, LOOSE, 1e-300)
    _close(got.vars, want.vars, LOOSE, 1e-300)


def test_initialize_prior_matches_jax():
    for args in ((None, None, 1000, 100_000), ([0.9, 0.1], [0.0, 0.2], 10, 20)):
        for got, want in zip(tprior.initialize_prior(*args),
                             jprior.initialize_prior(*args)):
            np.testing.assert_array_equal(got, want)


def _spd(n, seed, cond):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.logspace(0, -np.log10(cond), n)) @ Q.T


@pytest.mark.parametrize("cond,plateau,max_iter", [
    (1e1, 0, 60),      # every column converges: residual and onsager exits
    (1e3, 4, 80),      # hard spectrum: the plateau exit freezes columns
])
def test_solve_block_matches_jax(cond, plateau, max_iter):
    """Mixed exit modes, the rider on iteration 1 and the plateau freeze:
    per-column iteration counts equal, solutions to 1e-10."""
    n, B = 96, 3
    rng = np.random.default_rng(1)
    Q = _spd(n, 2, cond)
    A = rng.standard_normal((40, n))
    V = rng.standard_normal((n, B))
    mu0 = 0.1 * rng.standard_normal((n, B))
    X = rng.standard_normal((n, 2))
    diag = np.diag(Q) + 0.01
    modes = (0, 1, 1)
    kw = dict(modes=modes, err_tol=1e-9, onsager_tol=1e-9, plateau=plateau)
    jQ, jA = jnp.asarray(Q), jnp.asarray(A)
    want = jcg.solve_block(lambda P: jQ @ P, jnp.asarray(V), jnp.asarray(mu0),
                           jnp.asarray(diag), 0.7, max_iter,
                           rider=jnp.asarray(X),
                           rider_mult=lambda P, Xr: (jQ @ P, jA @ Xr), **kw)
    tQ, tA = _t(Q), _t(A)
    got = tcg.solve_block(lambda P: tQ @ P, _t(V), _t(mu0), _t(diag), 0.7,
                          max_iter, rider=_t(X),
                          rider_mult=lambda P, Xr: (tQ @ P, tA @ Xr), **kw)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(want.iters))
    assert int(got.iters.max()) < max_iter or plateau == 0
    scale = np.abs(np.asarray(want.mu)).max()
    _close(got.mu, want.mu, 0, LOOSE * scale)
    _close(got.r, want.r, 0, LOOSE * np.abs(V).max())
    _close(got.rel_err, want.rel_err, 1e-8)
    _close(got.rider_out, want.rider_out, TIGHT)


def test_warm_start_helpers_match_jax():
    rng = np.random.default_rng(3)
    n, B = 64, 2
    V, mu1, g1_, mu2, g2 = (rng.standard_normal((n, B)) for _ in range(5))
    gam2 = np.array([0.4, 0.9])
    for args in ((V, mu1, g1_, mu2, g2, 1.7, gam2),
                 (V, mu1, g1_, np.zeros((n, B)), g2, 1.7, gam2)):
        got = tcg.extrapolate_pair(*[_t(a) for a in args])
        want = jcg.extrapolate_pair(*[jnp.asarray(a) for a in args])
        for g, w in zip(got, want):
            _close(g, w, TIGHT)

    Q = _spd(n, 4, 10.0)

    def jmult(P):
        return jnp.asarray(Q) @ P

    def tmult(P):
        return _t(Q) @ P

    # refresh tick (true mult), tracked product, cold start, zero start
    for it, gmu in ((8, g1_), (3, g1_), (3, np.zeros((n, B)))):
        for mu in (mu1, np.zeros((n, B))):
            got = tcg.tracked_warm_start(_t(V), _t(mu), _t(gmu), _t(1.5),
                                         _t(1.5), _t(gam2), it, 8, tmult)
            want = jcg.tracked_warm_start(jnp.asarray(V), jnp.asarray(mu),
                                          jnp.asarray(gmu), 1.5, 1.5,
                                          jnp.asarray(gam2), it, 8, jmult)
            for g, w in zip(got, want):
                _close(g, w, TIGHT, 1e-300)

    sol_t = tcg.CGResult(mu=_t(mu1), iters=None, rel_err=None, r=_t(mu2))
    sol_j = jcg.CGResult(mu=jnp.asarray(mu1), iters=None, rel_err=None,
                         r=jnp.asarray(mu2))
    _close(tcg.gram_from_exit(_t(V), sol_t, 1.7, _t(gam2)),
           jcg.gram_from_exit(jnp.asarray(V), sol_j, 1.7, jnp.asarray(gam2)),
           TIGHT)
    assert tcg.jacobi_diag(2.0, 0.5, 100.0) == jcg.jacobi_diag(2.0, 0.5, 100.0)


@pytest.mark.parametrize("rank_frac", [0.4, 2.5])
def test_slq_matches_jax(rank_frac):
    """Lanczos basis and quadratures on a dense Gram (tests/test_slq.py's
    setting), two probe columns."""
    n, k = 96, 40
    rng = np.random.default_rng(5)
    Araw = rng.standard_normal((n, int(n * rank_frac)))
    G = Araw @ Araw.T / n
    U = np.where(rng.random((n, 2)) > 0.5, 1.0, -1.0) / np.sqrt(n)
    jb = jslq.build(lambda X: jnp.asarray(G) @ X, jnp.asarray(U), k)
    tb = tslq.build(lambda X: _t(G) @ X, _t(U), k)
    _close(tb.unorm2, jb.unorm2, TIGHT)
    for tau, gam2 in [(1.0, 1.0), (2.3, 1e-3), (1e3, 1e-2)]:
        _close(tslq.quad_inv(tb, tau, gam2), jslq.quad_inv(jb, tau, gam2),
               LOOSE)
        _close(tslq.quad_ratio(tb, tau, gam2), jslq.quad_ratio(jb, tau, gam2),
               LOOSE)
