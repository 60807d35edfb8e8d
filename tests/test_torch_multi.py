"""The port's multi-trait linear engine (gvamp_tpu_torch/multi.py) against
the JAX package's (gvamp_tpu/multi.py): one step from the same converted
state, the 6-iteration recipe of tests/test_multi.py:15-31 (N=500 x M=256,
T=3 traits, one with NA phenotypes), deflation from JAX's start block, a
trait that stops while the others continue, the fused primal Gram against
the two-pass route, and the joint run against T single-trait runs of the
port.  JAX runs f32 through the Pallas kernels in interpret mode and f64
through XLA; both sides get JAX's probe (jax.random cannot be reproduced
in torch).  The helpers here also serve tests/test_torch_multi_zmodel.py
and tests/test_torch_multi_cli.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import multi as jmulti
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import multi as tmulti
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from test_data_layer import make_bed

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}

# The recipe of tests/test_multi.py:15-31 (1% missing calls there; also
# run here on complete genotypes), every trait under trait 0's prior
SEED, N, M, T, H2S = 23, 500, 256, 3, (0.8, 0.5, 0.3)
CFG = dict(rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=3,
           stop_criteria_thr=0.0)
SCALARS = ("gam1", "gam2", "gamw", "alpha1", "alpha2", "R2_train_1",
           "R2_train_2")


def _make_problem(miss):
    rng = np.random.default_rng(SEED)
    codes = jsim.random_genotypes(rng, M, N, miss_rate=miss)
    g = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=jnp.float64,
                             backend="xla")
    ys, betas, priors = [], [], []
    for t in range(T):
        vars_t, probs_t = jsim.two_group_prior(M, 15, H2S[t])
        beta = jsim.simulate_mixture(rng, M, vars_t, probs_t)
        y = jsim.simulate_linear_phenotype(g, beta, 1 / (1 - H2S[t]), rng)
        if t == 1:  # one trait gets missing phenotypes
            y[rng.choice(N, 25, replace=False)] = np.nan
        ys.append(y)
        betas.append(beta)
        priors.append((probs_t, vars_t))
    return codes, ys, betas, priors


_PROBLEMS = {}


def problem(miss):
    """(codes, ys, betas, priors) of the recipe, cached per missing share."""
    if miss not in _PROBLEMS:
        _PROBLEMS[miss] = _make_problem(miss)
    return _PROBLEMS[miss]


def jax_geno(codes, dt, n=N, covs=None):
    g = JGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                             standardize_phen=False, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    g.covs = covs
    return g


def port_geno(codes, dt, n=N, covs=None):
    g = TGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                             standardize_phen=False, dtype=dt, device="cpu")
    g.covs = covs
    return g


def port_mp_from_jax(jmp, dt, covs=None):
    """The port's MultiPhen over JAX's words and JAX's per-trait statistics,
    NA masks and phenotypes, so that a step is the only difference."""
    j = jmp.geno
    g = convert.geno_from_numpy(np.asarray(j.words), np.zeros(j.N), N=j.N,
                                M=j.M, standardize_phen=False,
                                mave=np.asarray(j.mave),
                                msig=np.asarray(j.msig), dtype=dt,
                                device="cpu")
    g.covs = covs

    def t_(a):
        return torch.tensor(np.asarray(a), dtype=dt)

    return tmulti.MultiPhen(geno=g, T=jmp.T, mave=t_(jmp.mave),
                            msig=t_(jmp.msig), na=t_(jmp.na), y=t_(jmp.y),
                            nonas=jmp.nonas, intercepts=jmp.intercepts,
                            scales=jmp.scales)


def state_arrays(state) -> dict:
    """A JAX state's fields as arrays, without the Huber state's PRNG key
    (the port's generator replaces it)."""
    return {k: np.asarray(v) for k, v in state._asdict().items()
            if k != "key"}


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


def jax_defl_v0(j, cfg):
    """JAX's start block of top_eigs: normal(fold_in(key(seed), 7))."""
    return np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.key(cfg.seed), 7),
        (j.Mpad, cfg.deflate_k), j.dtype))


# One step from the same state, operator and probe: f64 agrees to 1e-9
# (two true-f64 engines, rounding order only); f32 to 1e-4 (the digit
# products agree to ~1e-7 and the CG solve amplifies that by its
# conditioning): the single-trait engines' STEP_TOL.
STEP_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


@pytest.mark.parametrize("miss", [0.0, 0.01])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_one_step_from_converted_state(dt, miss):
    """Three JAX iterations (tracked Gram and secant pair armed), then one
    step on each side; the port's state holds JAX's fields, ``stopped``
    as bool."""
    codes, ys, _, priors = problem(miss)
    probs_t, vars_t = priors[0]
    jmp = jmulti.MultiPhen.build(jax_geno(codes, dt), ys)
    cfg_j = jlinear.VampConfig(max_iter=4, **CFG)
    aux_j = jmulti.make_aux(jmp, cfg_j)
    step_j = jmulti.make_step(jmp, cfg_j)
    state0 = jmulti.init_state(jmp, cfg_j, probs_t, vars_t)
    for _ in range(3):
        state0, _ = step_j(state0, aux_j)
    state_j, m_j = step_j(state0, aux_j)

    tmp = port_mp_from_jax(jmp, dt)
    assert tmp.geno.geno_complete == (miss == 0.0)
    cfg_t = tlinear.VampConfig(max_iter=4, **CFG)
    aux_t = tmulti.make_aux(tmp, cfg_t, bern=np.asarray(aux_j.bern))
    st = convert.multi_state_from_numpy(state_arrays(state0), device="cpu",
                                        dtype=dt)
    assert st.stopped.dtype == torch.bool and st.it == 3
    state_t, m_t = tmulti.make_step(tmp, cfg_t)(st, aux_t)
    assert state_t.it == int(state_j.it) == 4
    for k in SCALARS:
        assert rel(m_t[k], m_j[k]) < STEP_TOL[dt], k
    back = convert.state_to_numpy(state_t)
    assert set(back) == set(jmulti.MultiState._fields)
    for k in ("x1", "x2", "r1", "r2", "z1", "gmu", "mu_prevb"):
        assert back[k].shape == np.asarray(getattr(state_j, k)).shape, k
        assert rel(back[k], getattr(state_j, k)) < STEP_TOL[dt], k
    np.testing.assert_array_equal(back["stopped"],
                                  np.asarray(state_j.stopped))


# Six iterations: f64, the same CG counts per trait and x within 1e-8 of
# max|x|; f32, x within 5e-5 of max|x| and the last iteration's scalars
# within rtol 2e-4 (the single-trait engine's f32 recipe limits,
# tests/test_torch_linear.py).
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_six_iteration_recipe_matches_jax(dt):
    codes, ys, betas, priors = problem(0.01)
    probs_t, vars_t = priors[0]
    j, t = jax_geno(codes, dt), port_geno(codes, dt)
    jmp, tmp = jmulti.MultiPhen.build(j, ys), tmulti.MultiPhen.build(t, ys)
    assert not t.geno_complete
    np.testing.assert_allclose(tmp.mave.numpy(), np.asarray(jmp.mave),
                               rtol=1e-6 if dt == torch.float32 else 1e-12)
    cfg_j = jlinear.VampConfig(max_iter=6, **CFG)
    cfg_t = tlinear.VampConfig(max_iter=6, **CFG)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, _, h_j = jmulti.infer(jmp, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = tmulti.infer(tmp, cfg_t, probs_t, vars_t, verbose=False,
                               bern=bern)
    assert x_t.shape == x_j.shape == (M, T)
    assert len(h_t) == len(h_j) == 6
    if dt == torch.float64:
        for a, b in zip(h_t, h_j):
            np.testing.assert_array_equal(a["cg_iters"],
                                          np.asarray(b["cg_iters"]))
        assert rel(x_t, x_j) < 1e-8
        rtol = 1e-8
    else:
        assert rel(x_t, x_j) < 5e-5
        rtol = 2e-4
    for k in ("gam1", "gam2", "gamw", "alpha2", "R2_train_1"):
        np.testing.assert_allclose(h_t[-1][k], np.asarray(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    for tr in range(T):
        assert np.corrcoef(x_t[:, tr], betas[tr])[0, 1] > 0.5, tr
    assert all(h["host_syncs"] > 0 and "wall_ms" not in h for h in h_t)


def test_deflation_with_jax_start_block():
    """deflate_k = 8: the shared basis from trait 0's Gram, JAX's start
    block injected; f64, the recipe's limits."""
    codes, ys, _, priors = problem(0.01)
    probs_t, vars_t = priors[0]
    dt = torch.float64
    j, t = jax_geno(codes, dt), port_geno(codes, dt)
    jmp, tmp = jmulti.MultiPhen.build(j, ys), tmulti.MultiPhen.build(t, ys)
    cfg_j = jlinear.VampConfig(max_iter=4, deflate_k=8, **CFG)
    cfg_t = tlinear.VampConfig(max_iter=4, deflate_k=8, **CFG)
    _, lam_j = jmulti._make_defl(jmp, cfg_j)
    _, lam_t = tmulti.make_deflation(tmp, cfg_t, jax_defl_v0(j, cfg_j))
    np.testing.assert_allclose(lam_t.numpy(), np.asarray(lam_j), rtol=1e-10)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    x_j, _, h_j = jmulti.infer(jmp, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = tmulti.infer(tmp, cfg_t, probs_t, vars_t, verbose=False,
                               bern=bern, defl_v0=jax_defl_v0(j, cfg_j))
    for a, b in zip(h_t, h_j):
        np.testing.assert_array_equal(a["cg_iters"], np.asarray(b["cg_iters"]))
    assert rel(x_t, x_j) < 1e-8


def test_trait_stops_while_others_continue():
    """stop_criteria_thr = 0.2: trait 1 stops at iteration 4 (rel_change
    0.196), traits 0 and 2 at 5, where the run ends.  The stopped trait's
    columns stay frozen bit for bit while the others move, the stopping
    pattern is JAX's, and the live traits follow the run without a stop
    (f64)."""
    codes, ys, _, priors = problem(0.01)
    probs_t, vars_t = priors[0]
    dt = torch.float64
    j, t = jax_geno(codes, dt), port_geno(codes, dt)
    jmp, tmp = jmulti.MultiPhen.build(j, ys), tmulti.MultiPhen.build(t, ys)
    kw = dict(CFG, stop_criteria_thr=0.2)
    bern = np.asarray(jlinear.make_bern_probe(j, kw["seed"], 1))
    states = {}
    _, _, h_j = jmulti.infer(jmp, jlinear.VampConfig(max_iter=8, **kw),
                             probs_t, vars_t, verbose=False)
    x_t, _, h_t = tmulti.infer(
        tmp, tlinear.VampConfig(max_iter=8, **kw), probs_t, vars_t,
        verbose=False, bern=bern,
        callbacks=[lambda it, s, m, g: states.__setitem__(it, s)])
    assert len(h_t) == len(h_j) == 5
    np.testing.assert_array_equal([h["stopped"] for h in h_t],
                                  [np.asarray(h["stopped"]) for h in h_j])
    np.testing.assert_array_equal(h_t[3]["stopped"], [False, True, False])
    assert h_t[4]["stopped"].all()
    s4, s5 = states[4], states[5]
    for f in ("x1", "x2", "r1", "r2", "mu_cg", "gmu", "mu_prevb",
              "gmu_prev"):
        assert torch.equal(getattr(s5, f)[:, 1], getattr(s4, f)[:, 1]), f
        assert not torch.equal(getattr(s5, f)[:, 0], getattr(s4, f)[:, 0]), f
    assert torch.equal(s5.z1[..., 1], s4.z1[..., 1])
    for f in ("gam1", "gam2", "gamw", "eta2", "alpha2", "tau_gmu"):
        assert getattr(s5, f)[1] == getattr(s4, f)[1], f
    assert torch.equal(s5.probs[1], s4.probs[1])
    x_free, _, _ = tmulti.infer(tmp, tlinear.VampConfig(max_iter=5, **CFG),
                                probs_t, vars_t, verbose=False, bern=bern)
    assert rel(x_t[:, [0, 2]], x_free[:, [0, 2]]) < 1e-12
    assert not np.array_equal(x_t[:, 1], x_free[:, 1])


@pytest.mark.parametrize("miss", [0.0, 0.01])
def test_fused_gram_against_two_pass(miss, monkeypatch):
    """Under GVAMP_FUSED_GRAM=1 every CG product and the SLQ set-up run
    through the fused Gram (gram_i8a / gram_i8 with per-column [4, Nb, B]
    NA masks, their plain versions here) and the noise update takes the
    explicit pass; six f32 iterations against the two-pass route: x within
    5e-5 of max|x| and the scalars within 2e-4 (chip_smoke's FUSED_XTOL /
    FUSED_RTOL: z is quantised per band in one and per column in the
    other)."""
    from gvamp_tpu_torch.ops import matvec as tmv
    codes, ys, _, priors = problem(miss)
    probs_t, vars_t = priors[0]
    cfg = tlinear.VampConfig(max_iter=6, **CFG)
    tmp = tmulti.MultiPhen.build(port_geno(codes, torch.float32), ys)
    x_two, _, h_two = tmulti.infer(tmp, cfg, probs_t, vars_t, verbose=False)
    name = "gram_i8a" if miss == 0.0 else "gram_i8"
    masks = []
    fn = getattr(tmv, name)

    def counted(words, W, *a):
        masks.append(tuple((a[0] if name == "gram_i8a" else a[1]).shape))
        return fn(words, W, *a)

    monkeypatch.setattr(tmv, name, counted)
    monkeypatch.setenv("GVAMP_FUSED_GRAM", "1")
    assert tmp.fn_gram() is not None
    x_f, _, h_f = tmulti.infer(tmp, cfg, probs_t, vars_t, verbose=False)
    cg_total = sum(int(h["cg_iters"].max()) for h in h_f)
    assert len(masks) >= cfg.slq_k + cg_total
    assert (4, tmp.y.shape[1], T) in masks
    assert rel(x_f, x_two) < 5e-5
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(h_f[-1][k], h_two[-1][k], rtol=2e-4,
                                   err_msg=k)


def test_multi_equals_single_trait_runs():
    """The joint run against T single-trait runs of the port (f64, every
    trait under trait 0's prior), rtol 1e-6: tests/test_multi.py:33-51's
    test, in the port."""
    codes, ys, _, priors = problem(0.01)
    probs_t, vars_t = priors[0]
    cfg = tlinear.VampConfig(max_iter=5, **CFG)
    t = port_geno(codes, torch.float64)
    x_m, _, h_m = tmulti.infer(tmulti.MultiPhen.build(t, ys,
                                                      standardize=False),
                               cfg, probs_t, vars_t, verbose=False)
    for tr, y in enumerate(ys):
        g = TGenoBed.from_arrays(make_bed(codes), y, N=N,
                                 standardize_phen=False,
                                 dtype=torch.float64, device="cpu")
        x_s, _, h_s = tlinear.infer(g, cfg, probs_t, vars_t, verbose=False)
        np.testing.assert_allclose(x_m[:, tr], x_s, rtol=1e-6, atol=1e-10)
        for k in ("gam1", "gamw"):
            np.testing.assert_allclose(h_m[-1][k][tr], float(h_s[-1][k]),
                                       rtol=1e-6, err_msg=k)
        assert [int(h["cg_iters"][tr]) for h in h_m] == [h["cg_iters"]
                                                         for h in h_s]


def test_sync_every_equals_single_steps():
    """sync_every=2 at max_iter=3 (a chunk of two, then a single step)
    equals single steps bit for bit in the three engines, f64
    (tests/test_round3.py:488-510; no exit inside a chunk, where stopped
    traits stay frozen)."""
    codes, ys, _, priors = problem(0.0)
    tmp = tmulti.MultiPhen.build(port_geno(codes, torch.float64), ys)
    from gvamp_tpu_torch import probit as tprobit, robust as trobust
    for run, cfg_cls in ((tmulti.infer, tlinear.VampConfig),
                         (tmulti.infer_probit, tprobit.ProbitConfig),
                         (tmulti.infer_huber, trobust.RobustConfig)):
        cfg = cfg_cls(max_iter=3, **CFG)
        x1, s1, h1 = run(tmp, cfg, *priors[0], verbose=False)
        x2, s2, h2 = run(tmp, cfg, *priors[0], verbose=False, sync_every=2)
        assert s2.it == s1.it == 3 and len(h2) == len(h1) == 3
        np.testing.assert_array_equal(x2, x1)
        for a, b in zip(h2, h1):
            np.testing.assert_array_equal(a["gam1"], b["gam1"])
