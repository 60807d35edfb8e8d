"""The port's dual (XXT, N-space) LMMSE path against the JAX package's:
one step from a converted JAX dual state, a 4-iteration recipe (complete
genotypes and 2% missing calls; f32 through the fused dual Gram on both
sides, JAX's Pallas kernels in interpret mode; f64 through the dense
two-pass form), the Woodbury identity against the port's own primal solve,
the tracked N-space warm start, gamma_damp, the fused Gram against the
two-pass form, and the CLI's --use-XXT-denoiser 1.  Both sides get JAX's
probe (jax.random cannot be reproduced in torch)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink, vecio
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.ops import matvec as tmv
from test_data_layer import make_bed

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}
SCALARS = ("gam1", "gam2", "gamw", "alpha1", "alpha2")

# N < M, as dual mode is meant for; Mpad = 512 is eight 64-marker stripes
SEED, N, M, CV, H2 = 37, 300, 512, 20, 0.6
CFG = dict(rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=3, use_xxt=True)
ITERS = 4

# One step from the same state, probe and Jacobi base: f64 to 1e-9 (two
# true-f64 engines, rounding order only); f32 to 1e-4 (the dual Grams
# quantise W on other stripes, ~1e-7, which the CG amplifies by its
# conditioning), as tests/test_torch_linear.py holds the primal step.
STEP_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


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
def problems():
    return {0.0: _make_problem(0.0), 0.02: _make_problem(0.02)}


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


_JAX_RUNS = {}


def _jax_run(problems, miss, dt):
    """JAX's dual engine, ITERS steps: (geno pair, aux, states, metrics),
    computed once per case for the one-step and the recipe tests."""
    key = (miss, dt)
    if key not in _JAX_RUNS:
        vars_t, probs_t = problems[miss][3:5]
        j, t = _genos(problems[miss], dt)
        cfg = jlinear.VampConfig(max_iter=ITERS, **CFG)
        aux = jlinear.make_aux(j, cfg)
        step = jlinear.make_step(j, cfg)
        states = [jlinear.init_state(j, cfg, probs_t, vars_t)]
        hist = []
        for _ in range(ITERS):
            s, m = step(states[-1], aux)
            states.append(s)
            hist.append({k: np.asarray(v) for k, v in m.items()})
        _JAX_RUNS[key] = (j, t, aux, states, hist)
    return _JAX_RUNS[key]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


CASES = [(0.0, torch.float64), (0.0, torch.float32), (0.02, torch.float64),
         (0.02, torch.float32)]


@pytest.mark.parametrize("miss,dt", CASES)
def test_dual_one_step_from_converted_state(problems, miss, dt):
    """The port's dual step from JAX's state after ITERS - 1 steps (which
    carries the tracked gmu_n and the warm start mu_cg_n), with JAX's
    probe, statistics and Jacobi base; the state converts both ways."""
    j, _, aux_j, states, hist = _jax_run(problems, miss, dt)
    t = convert.geno_from_numpy(np.asarray(j.words),
                                np.asarray(problems[miss][1]), N=N, M=M,
                                standardize_phen=False, dtype=dt,
                                mave=np.asarray(j.mave),
                                msig=np.asarray(j.msig), device="cpu")
    cfg = tlinear.VampConfig(max_iter=ITERS, **CFG)
    aux_t = convert.aux_from_numpy(t, cfg, np.asarray(aux_j.bern),
                                   xxt_diag_base=np.asarray(
                                       aux_j.xxt_diag_base))
    st = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in states[-2]._asdict().items()}, dtype=dt,
        device="cpu")
    assert st.gmu_n.abs().max() > 0 and st.mu_cg_n.abs().max() > 0
    state_t, m_t = tlinear.make_step(t, cfg)(st, aux_t)
    state_j, m_j = states[-1], hist[-1]
    assert state_t.it == int(state_j.it) == ITERS
    for k in SCALARS:
        assert _rel(m_t[k].detach(), m_j[k]) < STEP_TOL[dt], k
    for k in ("x1", "x2", "r1", "mu_cg_n", "gmu_n", "z1"):
        assert _rel(getattr(state_t, k), getattr(state_j, k)) < STEP_TOL[dt], k
    # the primal carry stays as it was in dual mode, as in JAX
    for k in ("mu_cg", "gmu", "mu_prevb", "gmu_prev"):
        np.testing.assert_array_equal(getattr(state_t, k).numpy(),
                                      getattr(st, k).numpy())
    back = convert.state_to_numpy(state_t)
    assert set(jlinear.LinState._fields) == set(back)
    assert back["mu_cg_n"].shape == np.asarray(state_j.mu_cg_n).shape


@pytest.mark.parametrize("miss,dt", CASES)
def test_dual_recipe_matches_jax(problems, miss, dt):
    """ITERS iterations of linear.infer in dual mode from scratch against
    JAX's: f64 with equal CG counts and x1 within 1e-8 of max|x1|; f32
    within 5e-5 of max|x1| and rtol 2e-4 on the scalars (the fused-Gram
    tolerances of tests/test_xxt.py:95-99)."""
    beta, vars_t, probs_t = problems[miss][2:5]
    j, t, aux_j, states, hist = _jax_run(problems, miss, dt)
    assert t.geno_complete == (miss == 0.0)
    x_t, state_t, h_t = tlinear.infer(t, tlinear.VampConfig(
        max_iter=ITERS, **CFG), probs_t, vars_t, verbose=False,
        bern=np.asarray(aux_j.bern))
    x_j = np.asarray(states[-1].x1)[:M] / np.sqrt(N)
    assert len(h_t) == ITERS
    if dt == torch.float64:
        assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"])
                                                for h in hist]
        assert _rel(x_t, x_j) < 1e-8
    else:
        assert _rel(x_t, x_j) < 5e-5
        for k in ("gam1", "gam2", "gamw", "alpha2"):
            np.testing.assert_allclose(float(h_t[-1][k]), float(hist[-1][k]),
                                       rtol=2e-4, err_msg=k)
    for k in ("R2_train_1", "R2_train_2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(hist[-1][k]),
                                   rtol=1e-4, err_msg=k)
    assert np.corrcoef(x_t, beta)[0, 1] > 0.85


def _port_geno(problem, dt=torch.float64):
    codes, y = problem[:2]
    t = TGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=dt,
                             device="cpu")
    t.set_phen(y)
    return t


def test_dual_equals_primal_woodbury(problems):
    """Woodbury: at tight CG tolerances the port's dual solve reproduces its
    primal solve (tests/test_xxt.py:34-48), in f64."""
    vars_t, probs_t = problems[0.02][3:5]
    t = _port_geno(problems[0.02])
    kw = dict(max_iter=4, rho=0.3, cg_max_iter=400, cg_err_tol=1e-10)
    x_p, _, h_p = tlinear.infer(t, tlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False)
    x_d, _, h_d = tlinear.infer(t, tlinear.VampConfig(
        use_xxt=True, cg_err_tol_xxt=1e-10, **kw), probs_t, vars_t,
        verbose=False)
    np.testing.assert_allclose(x_d, x_p, rtol=1e-5, atol=1e-8)
    for k in ("gam1", "gam2", "gamw"):
        np.testing.assert_allclose(float(h_d[-1][k]), float(h_p[-1][k]),
                                   rtol=1e-5)


def test_dual_tracking_matches_true_init_mult(problems):
    """The tracked N-space warm start (gmu_n, gram_refresh=8) against the
    true init mult every iteration (gram_refresh=1), 8 iterations in f64,
    to the tolerances of tests/test_xxt.py:102-116."""
    vars_t, probs_t = problems[0.0][3:5]
    t = _port_geno(problems[0.0])
    base = dict(max_iter=8, rho=0.3, use_xxt=True, seed=3)
    x_t, _, h_t = tlinear.infer(t, tlinear.VampConfig(gram_refresh=1, **base),
                                probs_t, vars_t, verbose=False)
    x_k, s_k, h_k = tlinear.infer(t, tlinear.VampConfig(gram_refresh=8,
                                                        **base),
                                  probs_t, vars_t, verbose=False)
    assert s_k.gmu_n.abs().max() > 0
    np.testing.assert_allclose(x_k, x_t, rtol=0,
                               atol=1e-4 * (np.abs(x_t).max() + 1e-30))
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_k[-1][k]), float(h_t[-1][k]),
                                   rtol=5e-4)


def test_dual_honors_gamma_damp(problems):
    """gamma_damp builds the dual operator as it does the primal one: the
    same damped trajectory (tests/test_xxt.py:119-135), in f64."""
    vars_t, probs_t = problems[0.0][3:5]
    t = _port_geno(problems[0.0])
    kw = dict(max_iter=4, rho=0.3, cg_max_iter=400, cg_err_tol=1e-10,
              gamma_damp=0.5)
    x_p, _, h_p = tlinear.infer(t, tlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False)
    x_d, _, h_d = tlinear.infer(t, tlinear.VampConfig(
        use_xxt=True, cg_err_tol_xxt=1e-10, **kw), probs_t, vars_t,
        verbose=False)
    np.testing.assert_allclose(x_d, x_p, rtol=1e-5, atol=1e-8)
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_d[-1][k]), float(h_p[-1][k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("miss", [0.0, 0.02])
def test_fused_dual_gram_matches_two_pass(problems, miss, monkeypatch):
    """f32 dual mode through the fused dual Gram (gram_aat_i8a on complete
    genotypes, gram_aat_i8 on missing calls) against GVAMP_NO_FUSED_GRAM=1
    (the two-pass form), to tests/test_xxt.py:95-99's tolerances."""
    vars_t, probs_t = problems[miss][3:5]
    cfg = tlinear.VampConfig(max_iter=3, **CFG)
    used = {"gram_aat_i8a": 0, "gram_aat_i8": 0}
    for name, fn in ((n, getattr(tmv, n)) for n in list(used)):
        def spy(*a, _n=name, _f=fn):
            used[_n] += 1
            return _f(*a)
        monkeypatch.setattr(tmv, name, spy)
    t = _port_geno(problems[miss], torch.float32)
    x_f, _, h_f = tlinear.infer(t, cfg, probs_t, vars_t, verbose=False)
    fused = "gram_aat_i8a" if miss == 0.0 else "gram_aat_i8"
    other = "gram_aat_i8" if miss == 0.0 else "gram_aat_i8a"
    assert used[fused] > 0 and used[other] == 0
    monkeypatch.setenv("GVAMP_NO_FUSED_GRAM", "1")
    n_fused = dict(used)
    x_t, _, h_t = tlinear.infer(_port_geno(problems[miss], torch.float32),
                                cfg, probs_t, vars_t, verbose=False)
    assert used == n_fused
    np.testing.assert_allclose(x_f, x_t, rtol=0,
                               atol=5e-5 * (np.abs(x_t).max() + 1e-30))
    for k in ("gam1", "gam2", "gamw", "alpha2"):
        np.testing.assert_allclose(float(h_f[-1][k]), float(h_t[-1][k]),
                                   rtol=2e-4)


def test_cli_infere_xxt_matches_library(problems, tmp_path):
    """--use-XXT-denoiser 1 runs the dual solve: the dumps equal a library
    infer in dual mode; gvamp_tpu.options keeps refusing it beside an
    explicit --cg-extrapolate 1 or --red."""
    codes, y, _, vars_t, probs_t = problems[0.02]
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    n_it = 3
    args = ["--device", "cpu", "--run-mode", "infere", "--model", "linear",
            "--bed-file", bed, "--phen-files", phen, "--N", str(N),
            "--Mt", str(M), "--iterations", str(n_it), "--rho", "0.3",
            "--probs", ",".join(map(str, probs_t)),
            "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
            "--use-XXT-denoiser", "1", "--out-dir", str(tmp_path / "out"),
            "--out-name", "run"]
    tcli.main(args)
    pre = str(tmp_path / "out" / "run")
    g = TGenoBed.from_files(bed, phen, N=N, Mt=M, device="cpu")
    _, state, _ = tlinear.infer(g, tlinear.VampConfig(
        max_iter=n_it, rho=0.3, use_xxt=True), probs_t, vars_t, verbose=False)
    dump = vecio.read_bin_shard(f"{pre}_it_{n_it}.bin", M, 0)
    np.testing.assert_array_equal(dump, state.x1[:M].numpy() * (1 / np.sqrt(N)))
    x2 = vecio.read_bin_shard(f"{pre}_it_{n_it}_x2_hat.bin", M, 0)
    np.testing.assert_array_equal(x2, state.x2[:M].numpy() * (1 / np.sqrt(N)))
    for name in ("_gam1s.csv", "_gam2s.csv", "_R2trains.csv",
                 f"_z1_it_{n_it}.csv"):
        assert os.path.getsize(pre + name) > 0
    for extra in (["--cg-extrapolate", "1"], ["--red", "1"]):
        with pytest.raises(SystemExit, match="XXT"):
            tcli.main(args + extra)
