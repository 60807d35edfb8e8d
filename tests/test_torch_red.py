"""``--red`` in the port: the windowed products
(``GenoBed.window_fns_multi``, the digit products on a word-row window of
the packed matrix) against their plain versions on the sliced words and
against the JAX package's ``window_fns_multi`` (Pallas in interpret mode
in f32, XLA in f64), and the linear engine's reduced-subset solves on
JAX's recipe of tests/test_round3.py:285-311 (N=8,192 x M=100) with JAX's
window starts, iteration by iteration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.ops import matvec as tmv
from helpers import random_dataset
from test_data_layer import make_bed
from test_torch_data import PRODUCT_TOL, _close, _pair

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}


def jax_window_starts(seed: int, S: int, nw: int, lbw: int, n_it: int):
    """JAX's window start of iterations 1..n_it: randint over
    fold_in(fold_in(key(seed + 3), S), it), times 32
    (gvamp_tpu/linear.py:739-742)."""
    out = []
    for it in range(1, n_it + 1):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.key(seed + 3), S), it)
        out.append(int(jax.random.randint(key, (), 0,
                                          (nw - lbw) // 32 + 1)) * 32)
    return out


# --------------------------------------------------------------------------
# the windowed products
# --------------------------------------------------------------------------

# N = 2,100: 160 word rows, the window 32 of them; starts 0, one inside and
# the last legal one
WIN_N, WIN_M, WIN_B = 2100, 72, 3


@pytest.mark.parametrize("miss", [0.0, 0.05])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_window_products_match_jax(dt, miss):
    rng = np.random.default_rng(41)
    codes, y = random_dataset(rng, WIN_N, WIN_M, miss_geno=miss)
    if miss == 0.0:
        codes[codes == 1] = 0
    j, t = _pair(codes, y, WIN_N, dt)
    assert t.geno_complete == (miss == 0.0)
    nw = t.layout.n_words
    lbw = tlinear.red_window_words(nw)
    assert (nw, lbw) == (160, 32)
    axm_w, atxm_w = t.window_fns_multi(lbw)
    jaxm_w, jatxm_w = j.window_fns_multi(lbw)
    m_mask = t.m_mask.numpy()
    X = rng.normal(size=(t.Mpad, WIN_B)) * m_mask[:, None]
    V = rng.normal(size=(4, 4 * lbw, WIN_B))
    jd, tol = JAX_DTYPE[dt], PRODUCT_TOL[dt]
    for sbw in (0, 64, nw - lbw):
        z = axm_w(t.op, torch.as_tensor(X, dtype=dt), sbw)
        assert z.shape == (4, 4 * lbw, WIN_B)
        _close(z, jaxm_w(j.op, jnp.asarray(X, jd), jnp.asarray(sbw)), tol)
        _close(atxm_w(t.op, torch.as_tensor(V, dtype=dt), sbw),
               jatxm_w(j.op, jnp.asarray(V, jd), jnp.asarray(sbw)), tol)


@pytest.mark.parametrize("miss", [0.0, 0.05])
def test_window_products_equal_plain_versions_on_sliced_words(miss):
    """In f32 the window runs the digit products on the row view
    words[sbw:sbw + lbw]: bit for bit the plain versions (axm_i8a_ref /
    atxm_i8a_ref on complete genotypes, axm_i8_ref / atxm_i8_ref with
    missing calls) on a copy of the sliced words, with the full data's
    marker statistics, the window's NA mask and the scale
    1/sqrt(16 lbw)."""
    rng = np.random.default_rng(43)
    codes, y = random_dataset(rng, WIN_N, WIN_M, miss_geno=miss)
    if miss == 0.0:
        codes[codes == 1] = 0
    t = TGenoBed.from_arrays(make_bed(codes), y, N=WIN_N, device="cpu")
    lbw = 32
    axm_w, atxm_w = t.window_fns_multi(lbw)
    X = torch.as_tensor(rng.normal(size=(t.Mpad, 2)) * t.m_mask.numpy()[:, None],
                        dtype=torch.float32)
    V = torch.as_tensor(rng.normal(size=(4, 4 * lbw, 2)), dtype=torch.float32)
    op, scale = t.op, 1.0 / np.sqrt(16 * lbw)
    for sbw in (32, 128):
        g = t.words[sbw:sbw + lbw].clone()
        na = t.na_planar[:, 4 * sbw:4 * (sbw + lbw)][:, :, None]
        W = op.msig[:, None] * X
        U = op.mave[:, None] * W
        v = V * na
        if miss == 0.0:
            z = (tmv.axm_i8a_ref(g, W) - U.sum(dim=0)[None, None, :]) * na
            av = tmv.atxm_i8a_ref(g, v)
            a = av - op.mave[:, None] * v.sum(dim=(0, 1))[None, :]
        else:
            z = tmv.axm_i8_ref(g, W, U) * na
            av, bv = tmv.atxm_i8_ref(g, v)
            a = av - op.mave[:, None] * bv
        np.testing.assert_array_equal(axm_w(op, X, sbw).numpy(),
                                      (z * scale).numpy())
        np.testing.assert_array_equal(atxm_w(op, V, sbw).numpy(),
                                      (a * op.msig[:, None] * scale).numpy())
    for bad in (16, -32, 160):
        with pytest.raises(ValueError, match="window start"):
            axm_w(op, X, bad)


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

# tests/test_round3.py:285-311: big enough that the window (at least 32
# word rows) is a tenth of the samples
RED_SEED, RED_N, RED_M = 17, 8192, 100
RED_CFG = dict(max_iter=5, rho=0.3, seed=3, red=True)
_RED = {}


def red_problem(miss):
    if miss not in _RED:
        rng = np.random.default_rng(RED_SEED)
        codes = jsim.random_genotypes(rng, RED_M, RED_N, miss_rate=miss)
        g = JGenoBed.from_arrays(make_bed(codes), np.zeros(RED_N), N=RED_N,
                                 standardize_phen=False, dtype=jnp.float64,
                                 backend="xla")
        vars_t, probs_t = jsim.two_group_prior(RED_M, 10, 0.8)
        beta = jsim.simulate_mixture(rng, RED_M, vars_t, probs_t)
        y = jsim.simulate_linear_phenotype(g, beta, 5.0, rng)
        _RED[miss] = (codes, y, beta, vars_t, probs_t)
    return _RED[miss]


def red_genos(miss, dt):
    codes, y = red_problem(miss)[:2]
    j = JGenoBed.from_arrays(make_bed(codes), np.zeros(RED_N), N=RED_N,
                             standardize_phen=False, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    t = TGenoBed.from_arrays(make_bed(codes), np.zeros(RED_N), N=RED_N,
                             standardize_phen=False, dtype=dt, device="cpu")
    for g in (j, t):
        g.set_phen(y)
    return j, t


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


# f64: the same CG and probe counts, x1 within 1e-8 of max|x1|, scalars
# rtol 1e-8; f32: x1 within 5e-5, scalars 2e-4 (the linear recipe's limits,
# tests/test_torch_linear.py)
@pytest.mark.parametrize("dt,miss", [(torch.float64, 0.0),
                                     (torch.float32, 0.0),
                                     (torch.float32, 0.02)])
def test_red_recipe_matches_jax(dt, miss):
    beta, vars_t, probs_t = red_problem(miss)[2:5]
    j, t = red_genos(miss, dt)
    assert t.geno_complete == (miss == 0.0)
    nw = t.layout.n_words
    lbw = tlinear.red_window_words(nw)
    assert (nw, lbw) == (512, 32)
    sbw = jax_window_starts(3, 0, nw, lbw, 5)
    assert len(set(sbw)) > 1
    bern = np.asarray(jlinear.make_bern_probe(j, 3, 1))
    x_j, _, h_j = jlinear.infer(j, jlinear.VampConfig(**RED_CFG), probs_t,
                                vars_t, verbose=False)
    x_t, s_t, h_t = tlinear.infer(t, tlinear.VampConfig(**RED_CFG), probs_t,
                                  vars_t, verbose=False, bern=bern,
                                  red_sbw=sbw)
    assert [h["red_sbw"] for h in h_t] == sbw
    assert len(h_t) == len(h_j) == 5
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    if dt == torch.float64:
        assert [h["probe_iters"] for h in h_t] == [int(h["probe_iters"])
                                                   for h in h_j]
        assert _rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert _rel(x_t, x_j) < 5e-5
        rtol = 2e-4
    for k in ("gam1", "gam2", "gamw", "alpha2", "R2_train_1", "R2_train_2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    # red keeps no tracked Gram product and no secant pair
    assert not s_t.gmu.any() and not s_t.mu_prevb.any()
    assert np.corrcoef(x_t, beta)[0, 1] > 0.8


def test_red_window_starts_drawn_on_the_host(monkeypatch):
    """Without ``red_sbw`` each iteration's start comes from a CPU
    generator seeded by (seed + 3, S, it): a multiple of 32 in
    [0, nw - lbw], the same in every run, no device value read for it.
    Under GVAMP_FUSED_GRAM=1 the window never reaches the fused Gram: no
    gram_i8a call, and the run equals the two-pass one bit for bit."""
    _, t = red_genos(0.0, torch.float32)
    vars_t, probs_t = red_problem(0.0)[3:5]
    nw, lbw = t.layout.n_words, tlinear.red_window_words(t.layout.n_words)
    starts = [tlinear.red_window_start(3, 0, it, nw, lbw)
              for it in range(1, 6)]
    assert all(s % 32 == 0 and 0 <= s <= nw - lbw for s in starts)
    assert starts == [tlinear.red_window_start(3, 0, it, nw, lbw)
                      for it in range(1, 6)]
    cfg = tlinear.VampConfig(**RED_CFG)
    x0, _, h0 = tlinear.infer(t, cfg, probs_t, vars_t, verbose=False)
    assert [h["red_sbw"] for h in h0] == starts
    calls = {"gram_i8a": 0}
    real = tmv.gram_i8a

    def counted(*a):
        calls["gram_i8a"] += 1
        return real(*a)

    monkeypatch.setattr(tmv, "gram_i8a", counted)
    monkeypatch.setenv("GVAMP_FUSED_GRAM", "1")
    assert t.fn_gram() is not None
    x1, _, h1 = tlinear.infer(t, cfg, probs_t, vars_t, verbose=False)
    assert calls["gram_i8a"] == 0
    np.testing.assert_array_equal(x1, x0)
    assert [h["host_syncs"] for h in h1] == [h["host_syncs"] for h in h0]


def test_red_with_the_dual_solve_matches_jax():
    """red together with use_xxt runs the dual solve on the probe path,
    with no window, as JAX's engine does (its noise update tests use_xxt
    before red): f64, the same CG and probe counts, x1 within 1e-8 of
    max|x1|, scalars rtol 1e-8, and no window start in the history."""
    beta, vars_t, probs_t = red_problem(0.0)[2:5]
    j, t = red_genos(0.0, torch.float64)
    kw = dict(RED_CFG, use_xxt=True)
    bern = np.asarray(jlinear.make_bern_probe(j, 3, 1))
    x_j, _, h_j = jlinear.infer(j, jlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False)
    x_t, _, h_t = tlinear.infer(t, tlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False, bern=bern)
    assert len(h_t) == len(h_j) == 5
    assert all("red_sbw" not in h for h in h_t)
    for k in ("cg_iters", "probe_iters"):
        assert [int(h[k]) for h in h_t] == [int(h[k]) for h in h_j], k
    assert _rel(x_t, x_j) < 1e-8
    for k in ("gam1", "gam2", "gamw", "alpha2", "R2_train_1", "R2_train_2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=1e-8, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.8
