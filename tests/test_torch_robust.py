"""The port's Huber engine (gvamp_tpu_torch/robust.py, the robust branch of
cli.py and convert.robust_state_from_numpy) against the JAX package: the
proximal functions, the loss and the deltaH grid search with injected
draws, one step from a converted JAX state, and the 6-iteration recipe of
tests/test_robust.py:53 (N=1,500 x M=300, Student-t(3) noise) in f64 and
f32, on complete genotypes and with 2% missing calls.  JAX runs f32
through the Pallas kernels in interpret mode and f64 through XLA.  Both
sides get JAX's probe and JAX's Monte-Carlo draws, rebuilt here from the
key sequence of gvamp_tpu/robust.py:182, 302 (jax.random cannot be
reproduced in torch).

Under x64 (tests/conftest.py) the JAX package's probe is float64, which
would make its f32 engine's alpha2 clip (gvamp_tpu/robust.py:382-383) a
float64 one; the f32 runs give JAX a float32 probe, the dtype it has
without x64, as tests/test_torch_probit.py does."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import robust as jrobust
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink, vecio
from gvamp_tpu.linear import make_bern_probe as jax_bern_probe
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import convert
from gvamp_tpu_torch import robust as trobust
from gvamp_tpu_torch import slq as tslq
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from test_data_layer import make_bed

torch.set_num_threads(1)

JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
JAX_BACKEND = {torch.float32: "pallas", torch.float64: "xla"}

# The recipe of tests/test_robust.py:53-73, at 6 iterations
SEED, N, M, CV, H2 = 9, 1500, 300, 20, 0.9
CFG = dict(rho=0.3, seed=5)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


# --------------------------------------------------------------------------
# the proximal functions, the loss and the grid search
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["g1_huber", "g1d_huber", "g1d_huber_der",
                                  "huber_loss"])
def test_huber_functions_match_jax(name):
    """f64, rtol 1e-12, over both branches of |w| and of |p1| (the
    reference's derivative branches on |p1|, as JAX's does)."""
    rng = np.random.default_rng(3)
    n = 5000
    p1 = rng.normal(0, 2, n)
    y = p1 + rng.standard_t(2.0, n)
    for tau1, delta in ((0.4, 0.2), (3.0, 1.5), (25.0, 1e-3)):
        if name == "huber_loss":
            want = np.asarray(jrobust.huber_loss(jnp.asarray(p1), delta,
                                                 jnp.asarray(y)))
            got = trobust.huber_loss(torch.tensor(p1), delta,
                                     torch.tensor(y)).numpy()
        else:
            want = np.asarray(getattr(jrobust, name)(
                jnp.asarray(p1), jnp.asarray(tau1), delta, jnp.asarray(y)))
            got = getattr(trobust, name)(
                torch.tensor(p1), torch.tensor(tau1, dtype=torch.float64),
                delta, torch.tensor(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if name == "g1d_huber_der":
        # every branch taken: the linear region on |p1| and both tails
        assert {1.0, -1.0} <= set(np.unique(got)) and (np.abs(got) < 1).any()


# (tau1, outlier share, outlier scale): heavy tails pick a small delta,
# Gaussian residuals a large one, so the cases cover several grid points
EM_CASES = [(25.0, 0.1, 10.0), (4.0, 0.0, 1.0), (0.5, 0.02, 3.0),
            (100.0, 0.0, 0.05)]


@pytest.mark.parametrize("tau1,share,scale", EM_CASES)
def test_em_deltaH_matches_jax(tau1, share, scale):
    """The grid point from JAX's key equals the port's from the same draws
    (JAX's eps rebuilt from that key), with an NA mask; f64."""
    rng = np.random.default_rng(0)
    n, mc = 2000, 100
    p1 = rng.normal(size=n)
    y = p1 + np.where(rng.random(n) < share, rng.standard_cauchy(n) * scale,
                      rng.normal(size=n) * scale)
    mask = (rng.random(n) > 0.05).astype(np.float64)
    key = jax.random.key(11)
    want = float(jrobust.em_deltaH(key, jnp.asarray(p1), jnp.asarray(tau1),
                                   jnp.asarray(y), jnp.asarray(mask),
                                   num_mc=mc))
    eps = np.asarray(jax.random.normal(key, (mc, n), jnp.float64))
    got = trobust.em_deltaH(torch.tensor(eps), torch.tensor(p1),
                            torch.tensor(tau1, dtype=torch.float64),
                            torch.tensor(y),
                            torch.tensor(mask))
    assert float(got) == want
    if share == 0.1:
        assert want <= 0.4


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------


def _make_problem(miss):
    rng = np.random.default_rng(SEED)
    codes = jsim.random_genotypes(rng, M, N, miss_rate=miss)
    g = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=jnp.float64,
                             backend="xla")
    vars_t, probs_t = jsim.two_group_prior(M, CV, H2)
    beta = jsim.simulate_mixture(rng, M, vars_t, probs_t)
    x = g.pad_m(beta * np.sqrt(N))
    y = g.deplanarize(g.ax(jnp.asarray(x)))[:N] + rng.standard_t(3.0, N) * 0.5
    return codes, y, beta, vars_t, probs_t


_PROBLEMS = {}


def _problem(miss):
    if miss not in _PROBLEMS:
        _PROBLEMS[miss] = _make_problem(miss)
    return _PROBLEMS[miss]


def _genos(prob, dt):
    codes, y = prob[:2]
    j = JGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    t = TGenoBed.from_arrays(make_bed(codes), np.zeros(N), N=N,
                             standardize_phen=False, dtype=dt, device="cpu")
    for g in (j, t):
        g.set_phen(y)
    return j, t


def jax_draws(j, cfg, n_it, start=0):
    """JAX's em_deltaH draws of iterations start+1 .. start+n_it: key(seed
    + 2) split once per iteration (gvamp_tpu/robust.py:182, 302)."""
    key = jax.random.key(cfg.seed + 2)
    nb4 = int(np.prod(j.y_planar.shape))
    out = []
    for i in range(start + n_it):
        key, sub = jax.random.split(key)
        if i >= start:
            out.append(np.asarray(jax.random.normal(
                sub, (cfg.mc_steps, nb4), j.dtype)))
    return out


@pytest.fixture
def f32_probe(monkeypatch):
    """JAX's probe in the engine dtype (see the module docstring)."""
    monkeypatch.setattr(
        jrobust, "make_bern_probe",
        lambda g, seed, n=1: jax_bern_probe(g, seed, n).astype(g.dtype))


SCALARS = ("gam1", "gam2", "tau1", "tau2", "alpha1", "alpha2", "beta1")


def test_one_step_from_converted_state():
    """Two JAX iterations (tracked Gram and z2 armed), then one step on
    each side from the same state, operator, probe and draws; f64,
    complete genotypes (with missing calls the recipe enters the regime
    where 1 - alpha2 ~ 1e-12 at iteration 2, see RECIPE_TOL); the port's
    state holds JAX's fields with ``gen`` for ``key``."""
    prob = _problem(0.0)
    vars_t, probs_t = prob[3:5]
    j, _ = _genos(prob, torch.float64)
    cfg_j = jrobust.RobustConfig(max_iter=3, **CFG)
    aux_j = jrobust.make_aux(j, cfg_j)
    step_j = jrobust.make_step(j, cfg_j)
    state0 = jrobust.init_state(j, cfg_j, probs_t, vars_t)
    for _ in range(2):
        state0, _ = step_j(state0, aux_j)
    state_j, m_j = step_j(state0, aux_j)
    t = convert.geno_from_numpy(np.asarray(j.words), prob[1], N=N, M=M,
                                standardize_phen=False,
                                mave=np.asarray(j.mave),
                                msig=np.asarray(j.msig), dtype=torch.float64,
                                device="cpu")
    cfg_t = trobust.RobustConfig(max_iter=3, **CFG)
    aux_t = trobust.make_aux(t, cfg_t, bern=np.asarray(aux_j.bern))
    st = convert.robust_state_from_numpy(
        {k: np.asarray(v) for k, v in state0._asdict().items()
         if k != "key"}, device="cpu", dtype=torch.float64, gen=cfg_t.seed)
    eps = jax_draws(j, cfg_j, 1, start=2)[0]
    state_t, m_t = trobust.make_step(t, cfg_t)(st, aux_t, eps)
    assert state_t.it == int(state_j.it) == 3
    assert int(m_t["cg_iters"]) == int(m_j["cg_iters"])
    assert float(m_t["deltaH"]) == float(m_j["deltaH"])
    for k in SCALARS:
        assert _rel(m_t[k].detach(), m_j[k]) < 1e-9, k
    back = convert.state_to_numpy(state_t)
    assert set(back) ^ set(jrobust.RobustState._fields) == {"gen", "key"}
    again = convert.robust_state_from_numpy(back, device="cpu",
                                            dtype=torch.float64)
    assert torch.equal(again.gen.get_state(), state_t.gen.get_state())
    for k in ("x1", "x2", "r1", "z1", "z2", "p1", "gmu"):
        assert _rel(back[k], getattr(state_j, k)) < 1e-9, k


# Six iterations, x1 and deltaH compared at every iteration; deltaH must
# pick the same grid point on both sides, and the CG counts must agree.
# Per (dtype, missing share): the limit on max|dx1| / max|x1| at iteration
# 1 and from iteration 2 on, the relative limit on the last iteration's
# scalars, and which scalars.  Measured (this recipe, port against JAX):
#  - complete, f64: 1.0e-13 on x1, 1.8e-12 on alpha2;
#  - complete, f32: 2.5e-5 on x1, 4.2e-4 on alpha2 (JAX's own f32 run is
#    8.1e-6 and 1.3e-4 off its f64 run);
#  - 2% missing: the trajectory reaches tau1 = GAMMA_MAX and alpha2 =
#    1 - 1e-12 at iteration 2, where gam1 = gam2 (1 - alpha2) / alpha2 and
#    beta2 = Mt/N (1 - alpha2) keep about 4 significant digits in f64: x1
#    agrees to 1.8e-15 at iteration 2, then 5.4e-4 to 3.3e-3 (f64) and
#    6.7e-3 to 8.3e-3 (f32), where JAX's own f32 run is 0.27-0.39 off its
#    f64 run and gam1 a factor 6.6e9; gam1 is not compared there, tau2 and
#    corr(x1, truth) agree to 4.0e-4 and 1.4e-4.
_ALL = ("gam1", "tau1", "tau2", "alpha2", "corr_x1")
RECIPE_TOL = {(torch.float64, 0.0): (1e-12, 1e-11, 1e-10, _ALL),
              (torch.float32, 0.0): (1e-6, 1e-4, 2e-3, _ALL),
              (torch.float64, 0.02): (1e-12, 1e-2, 2e-3,
                                      ("tau1", "tau2", "corr_x1")),
              (torch.float32, 0.02): (1e-5, 3e-2, 2e-3,
                                      ("tau1", "tau2", "corr_x1"))}


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("miss", [0.0, 0.02])
def test_six_iteration_recipe_matches_jax(dt, miss, f32_probe):
    prob = _problem(miss)
    beta, vars_t, probs_t = prob[2:5]
    j, t = _genos(prob, dt)
    assert t.geno_complete == (miss == 0.0)
    cfg_j = jrobust.RobustConfig(max_iter=6, **CFG)
    cfg_t = trobust.RobustConfig(max_iter=6, **CFG)
    bern = np.asarray(jrobust.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    x1s = {"jax": [], "port": []}

    def keep(side):
        def cb(it, state, m, g):
            x1s[side].append(np.asarray(
                state.x1.cpu() if isinstance(state.x1, torch.Tensor)
                else state.x1, np.float64))
        return cb

    x_j, _, h_j = jrobust.infer(j, cfg_j, probs_t, vars_t, true_signal=beta,
                                verbose=False, callbacks=[keep("jax")])
    x_t, _, h_t = trobust.infer(t, cfg_t, probs_t, vars_t, true_signal=beta,
                                verbose=False, bern=bern,
                                mc_draws=jax_draws(j, cfg_j, 6),
                                callbacks=[keep("port")])
    assert len(h_t) == len(h_j) == 6
    assert [float(h["deltaH"]) for h in h_t] == [float(h["deltaH"])
                                                 for h in h_j]
    x_first, x_rest, rtol, keys = RECIPE_TOL[dt, miss]
    for i, (xt, xj) in enumerate(zip(x1s["port"], x1s["jax"])):
        assert _rel(xt, xj) < (x_first if i == 0 else x_rest), i
    assert _rel(x_t, x_j) < x_rest
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    for k in keys:
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=rtol, err_msg=k)
    assert np.isfinite(x_t).all()
    assert np.corrcoef(x_t, beta)[0, 1] > 0.6
    assert all(h["host_syncs"] > 0 and "wall_ms" not in h for h in h_t)


def test_generator_draws_are_reproducible():
    """Without injected draws the port draws from its own generator: two
    runs give the same trajectory, and the generator moves on each
    iteration (an earlier state keeps its own)."""
    prob = _problem(0.0)
    vars_t, probs_t = prob[3:5]
    _, t = _genos(prob, torch.float32)
    cfg = trobust.RobustConfig(max_iter=3, **CFG)
    states = []
    runs = [trobust.infer(t, cfg, probs_t, vars_t, verbose=False,
                          callbacks=[lambda it, s, m, g: states.append(s)])
            for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert np.isfinite(runs[0][0]).all()
    gens = [s.gen.get_state() for s in states[:3]]
    assert not torch.equal(gens[0], gens[1])
    assert torch.equal(states[0].gen.get_state(),
                       states[3].gen.get_state())


def test_item_12_options_run():
    """The options that raised until the probe path and the driver options
    were ported run: red (probe columns only, as in JAX), use_slq=False,
    sync_every and phase_timers (their parity: tests/test_torch_probe.py,
    tests/test_torch_driver.py)."""
    prob = _problem(0.0)
    vars_t, probs_t = prob[3:5]
    _, t = _genos(prob, torch.float64)
    for kw, opts in ((dict(red=True), {}), (dict(use_slq=False), {}),
                     ({}, dict(sync_every=2)), ({}, dict(phase_timers=True))):
        x, s, h = trobust.infer(t, trobust.RobustConfig(max_iter=2, **kw),
                                probs_t, vars_t, verbose=False, **opts)
        assert np.isfinite(x).all() and len(h) == 2
        assert s.mu_probe.shape[1] == (1 if kw else 0)


def test_cli_robust_matches_library(tmp_path):
    """--model robust: the _robust_ dumps, the estimate equal to a library
    run on a container loaded the same way (phenotype standardised);
    several --phen-files run the multi-trait Huber engine, ported since
    (tests/test_torch_multi_zmodel.py), writing each trait's dumps."""
    codes, y, beta, vars_t, probs_t = _problem(0.0)
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    n_it = 3
    args = ["--device", "cpu", "--run-mode", "infere", "--model", "robust",
            "--bed-file", bed, "--phen-files", phen, "--N", str(N), "--Mt",
            str(M), "--iterations", str(n_it), "--rho", "0.3", "--seed", "5",
            "--probs", ",".join(map(str, probs_t)),
            "--vars", ",".join(map(str, vars_t)), "--verbosity", "0",
            "--out-dir", str(tmp_path / "out")]
    tcli.main(args + ["--out-name", "run"])
    pre = str(tmp_path / "out" / "run")
    for it in range(1, n_it + 1):
        for name in (f"_robust_it_{it}.bin", f"_robust_r1_it_{it}.bin",
                     f"_robust_z1_it_{it}.csv", f"_robust_p1_it_{it}.csv"):
            assert os.path.getsize(pre + name) > 0
    g = TGenoBed.from_files(bed, phen, N=N, Mt=M, device="cpu")
    cfg = trobust.RobustConfig(max_iter=n_it, rho=0.3, seed=5)
    x_lib, state, _ = trobust.infer(g, cfg, probs_t, vars_t, verbose=False)
    dump = vecio.read_bin_shard(f"{pre}_robust_it_{n_it}.bin", M, 0)
    np.testing.assert_array_equal(dump,
                                  state.x1[:M].numpy() * (1 / np.sqrt(N)))
    np.testing.assert_allclose(dump, x_lib, rtol=2.0 ** -23)
    tcli.main(args + ["--out-name", "x", "--phen-files", f"{phen},{phen}"])
    for t in range(2):
        for it in range(1, n_it + 1):
            d = vecio.read_bin_shard(
                f"{tmp_path}/out/x_phen{t}_robust_it_{it}.bin", M, 0)
            assert np.isfinite(d).all()
        assert np.corrcoef(d, beta)[0, 1] > 0.6


def test_slq_nodes_weights_run_in_float64():
    """The SLQ quadrature's k x k eigendecomposition runs in float64 for a
    float32 basis (CUDA's float32 eigh moved the Huber engine's first
    alpha2 on the card 4.4e-6 off the CPU's): the float32 nodes and weights
    are the float64 ones rounded, and the quadrature of a float32 Lanczos
    run stays within 1e-5 of float64's (measured 1.8e-6, the float32
    recurrence's own error)."""
    rng = np.random.default_rng(12)
    n, C, k = 400, 2, 32
    A = rng.normal(size=(n, n)) / np.sqrt(n)
    G = A.T @ A
    U = rng.choice([-1.0, 1.0], size=(n, C)) / np.sqrt(n)
    a, b, _ = tslq.lanczos_block(lambda X: torch.tensor(G, dtype=X.dtype) @ X,
                                 torch.tensor(U, dtype=torch.float32), k)
    lam, wts = tslq.nodes_weights(a, b)
    lam64, wts64 = tslq.nodes_weights(a.double(), b.double())
    assert lam.dtype == wts.dtype == torch.float32
    assert torch.equal(lam, lam64.float()) and torch.equal(wts, wts64.float())
    b32 = tslq.build(lambda X: torch.tensor(G, dtype=X.dtype) @ X,
                     torch.tensor(U, dtype=torch.float32), k)
    b64 = tslq.build(lambda X: torch.tensor(G) @ X, torch.tensor(U), k)
    for tau, gam2 in ((1.0, 4.0), (30.0, 0.2)):
        q32 = tslq.quad_inv(b32, tau, gam2).double().numpy()
        q64 = tslq.quad_inv(b64, tau, gam2).numpy()
        np.testing.assert_allclose(q32, q64, rtol=1e-5)


def test_profile_huber_runs_on_cpu(capsys):
    """The Huber time-split tool (gvamp_tpu_torch/tools/profile_huber.py)
    on the CPU at a small size: one split per deflate_k, whose timed parts
    include the CG and em_deltaH, the draw times and the SLQ node check."""
    from gvamp_tpu_torch.tools import profile_huber
    assert profile_huber.main(["2048", "512", "2", "--deflate-k", "0", "8",
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("iterations") == 2 and "deflate_k=8" in out
    for part in ("CG solve", "em_deltaH grid", "EM prior update", "rest",
                 "draw [100, 2048]", "SLQ eigh float32 on cpu"):
        assert part in out, part
