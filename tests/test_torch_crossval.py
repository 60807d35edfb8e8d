"""The port's cross-validation damping tuner and state evolution against the
JAX package: GenoBed.sample_window against JAX's view, the cross-validated
linear run per iteration with JAX's probe (the same accept / retry
decisions in f64), checkpoints with and without cv_r2 resumed, and
state_evolution from JAX's draws.  JAX runs f32 through the Pallas kernels
in interpret mode and f64 through XLA."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import ckpt as jckpt
from gvamp_tpu import linear as jlinear
from gvamp_tpu import sim as jsim
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.prior import Prior as JPrior
from gvamp_tpu_torch import ckpt as tckpt
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.prior import Prior as TPrior
from test_data_layer import make_bed
from test_torch_data import PRODUCT_TOL
from test_torch_linear import JAX_BACKEND, JAX_DTYPE, STEP_TOL

torch.set_num_threads(1)

# A recipe whose held-out R2 falls within N_IT iterations, so that the
# tuner rejects tries (JAX's runs: every one of the 25 tries rejected,
# rho_cross = 0.9 * 0.9^25, from iteration 5 on complete genotypes, from
# iteration 3 with 2% missing calls): N=600 x M=300, h2 0.5.
SEED, N, M, CV, H2 = 2, 600, 300, 20, 0.5
N_IT = 6
CFG = dict(rho=0.9, gam1_init=1e-8, gamw_init=2.0, seed=5,
           use_cross_val=True, stop_criteria_thr=0.0)
CFG_TRIES = jlinear.VampConfig().cv_max_retry


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


_PROBLEMS = {}


def _problem(miss):
    if miss not in _PROBLEMS:
        _PROBLEMS[miss] = _make_problem(miss)
    return _PROBLEMS[miss]


def _genos(miss, dt):
    """(JAX, port) containers with the standardised phenotype, as the CLI
    loads them."""
    codes, y = _problem(miss)[:2]
    j = JGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=JAX_DTYPE[dt],
                             backend=JAX_BACKEND[dt])
    t = TGenoBed.from_arrays(make_bed(codes), y, N=N, dtype=dt, device="cpu")
    return j, t


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_sample_window_matches_jax(dt):
    """The masked view (tests/test_linear_vamp.py:94): its N, offset, NA
    count and completeness, and its products within PRODUCT_TOL of JAX's
    window; deplanarize puts the window's people at the origin."""
    j, t = _genos(0.02, dt)
    rng = np.random.default_rng(4)
    for sb, lb in ((8, 24), (140, 10)):
        jw, tw = j.sample_window(sb, lb), t.sample_window(sb, lb)
        assert (tw.N, tw.n_offset, tw.nonas) == (jw.N, jw.n_offset, jw.nonas)
        assert tw.geno_complete == t.geno_complete is False
        assert t.N == N and t.n_offset == 0  # the parent is untouched
        x = rng.normal(size=t.Mpad) * t.m_mask.numpy()
        z_t = tw.ax(torch.tensor(x, dtype=dt))
        z_j = jw.ax(jnp.asarray(x, JAX_DTYPE[dt]))
        assert _rel(z_t, z_j) < PRODUCT_TOL[dt]
        np.testing.assert_array_equal(tw.deplanarize(z_t)[: tw.N],
                                      t.deplanarize(z_t)[4 * sb:4 * sb + tw.N])
        v = rng.normal(size=(4, t.layout.n_bytes))
        assert _rel(tw.atx(torch.tensor(v, dtype=dt)),
                    jw.atx(jnp.asarray(v, JAX_DTYPE[dt]))) < PRODUCT_TOL[dt]
        # the statistics stay the full data's, the scale the window's
        assert torch.equal(tw.mave, t.mave) and tw.inv_sqrt_n == 1 / np.sqrt(
            tw.N)


def _x1_cb(store):
    def cb(it, state, metrics, g):
        store.append(np.asarray(state.x1, np.float64).copy())
    return cb


def _runs(miss, dt, n_it=N_IT):
    vars_t, probs_t = _problem(miss)[3:5]
    j, t = _genos(miss, dt)
    bern = np.asarray(jlinear.make_bern_probe(j, CFG["seed"], 1))
    xs_j, xs_t = [], []
    _, _, h_j = jlinear.infer(j, jlinear.VampConfig(max_iter=n_it, **CFG),
                              probs_t, vars_t, verbose=False,
                              callbacks=[_x1_cb(xs_j)])
    _, _, h_t = tlinear.infer(t, tlinear.VampConfig(max_iter=n_it, **CFG),
                              probs_t, vars_t, verbose=False, bern=bern,
                              callbacks=[_x1_cb(xs_t)])
    return (xs_j, h_j), (xs_t, h_t)


@pytest.mark.parametrize("miss", [0.0, 0.02])
@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_cross_val_run_matches_jax(miss, dt):
    """N_IT cross-validated iterations from scratch on both sides with
    JAX's probe: per iteration x1, cv_r2 and rho_cross within STEP_TOL
    (1e-9 f64, 1e-4 f32); in f64 the tuner's decisions (rho_cross, which
    encodes the rejected tries) equal JAX's, rejections included; each
    rejected try costs the port one host sync."""
    (xs_j, h_j), (xs_t, h_t) = _runs(miss, dt)
    assert len(h_t) == len(h_j) == N_IT
    for it, (a, b, xa, xb) in enumerate(zip(h_t, h_j, xs_t, xs_j), 1):
        assert _rel(xa, xb) < STEP_TOL[dt], it
        for k in ("cv_r2", "rho_cross"):
            assert abs(float(a[k]) - float(b[k])) <= STEP_TOL[dt] * max(
                1.0, abs(float(b[k]))), (it, k)
    rho_j = [float(h["rho_cross"]) for h in h_j]
    if dt == torch.float64:
        assert [float(h["rho_cross"]) for h in h_t] == rho_j
    # the recipe's tuner rejects tries: each one a host sync of the port's
    tries = [round(np.log(r / 0.9) / np.log(0.9)) for r in rho_j]
    assert max(tries) == CFG_TRIES and tries[0] == 0
    assert all(h["host_syncs"] >= k for h, k in zip(h_t, tries))


def test_cross_val_resume_is_bit_for_bit(tmp_path):
    """Three cross-validated iterations with a checkpoint, resumed for three
    more, equal bit for bit to six in one run (f32, the state's cv_r2 and
    rho carrying the tuner)."""
    vars_t, probs_t = _problem(0.0)[3:5]
    _, t = _genos(0.0, torch.float32)
    path = str(tmp_path / "cv.npz")
    cfg3 = tlinear.VampConfig(max_iter=3, **CFG)

    def save(it, state, metrics, g):
        tckpt.save_state(path, state, it=it, model="linear",
                         cfg=dataclasses.asdict(cfg3))

    tlinear.infer(t, cfg3, probs_t, vars_t, verbose=False, callbacks=[save])
    st, meta = tckpt.load_state(path, tlinear.LinState, device="cpu")
    assert "cv_r2" in meta["fields"] and float(st.cv_r2) > -1
    cfg6 = tlinear.VampConfig(max_iter=N_IT, **CFG)
    x_r, _, h_r = tlinear.infer(t, cfg6, probs_t, vars_t, verbose=False,
                                resume_state=st)
    x_6, _, h_6 = tlinear.infer(t, cfg6, probs_t, vars_t, verbose=False)
    np.testing.assert_array_equal(x_r, x_6)
    for a, b in zip(h_r, h_6[3:]):
        for k in ("cv_r2", "rho_cross", "gam1", "gamw"):
            assert float(a[k]) == float(b[k]), k


def test_jax_checkpoint_with_cv_r2_resumed(tmp_path):
    """A JAX cross-validated checkpoint at iteration 3 (its cv_r2 among the
    fields) resumed by the port and by JAX for three more, f64, JAX's
    probe: cv_r2 read back, the decisions equal, x1 within 1e-8."""
    vars_t, probs_t = _problem(0.0)[3:5]
    j, t = _genos(0.0, torch.float64)
    path = str(tmp_path / "j.npz")
    jcfg3 = jlinear.VampConfig(max_iter=3, **CFG)
    dump = jckpt.IterDumper(str(tmp_path / "j"), model="linear",
                            checkpoint=path,
                            meta={"cfg": dataclasses.asdict(jcfg3)})
    jlinear.infer(j, jcfg3, probs_t, vars_t, verbose=False, callbacks=[dump])
    js, _ = jckpt.load_state(path, jlinear.LinState)
    x_j, _, h_j = jlinear.infer(j, jlinear.VampConfig(max_iter=N_IT, **CFG),
                                probs_t, vars_t, verbose=False,
                                resume_state=js)
    ts, meta = tckpt.load_state(path, tlinear.LinState, device="cpu",
                                dtype=torch.float64)
    assert "cv_r2" in meta["fields"]
    assert float(ts.cv_r2) == float(js.cv_r2) > -1
    bern = np.asarray(jlinear.make_bern_probe(j, CFG["seed"], 1))
    x_t, _, h_t = tlinear.infer(t, tlinear.VampConfig(max_iter=N_IT, **CFG),
                                probs_t, vars_t, verbose=False,
                                resume_state=ts, bern=bern)
    assert len(h_t) == len(h_j) == N_IT - 3
    assert [float(h["rho_cross"]) for h in h_t] == [
        float(h["rho_cross"]) for h in h_j]
    assert _rel(x_t, x_j) < 1e-8


def test_port_checkpoint_without_cv_r2_resumed(tmp_path):
    """A checkpoint of the port from before it ran the tuner (no cv_r2
    field) loads with cv_r2 = -1, a fresh state's value, and its linear run
    resumes equal bit for bit to an uninterrupted one."""
    vars_t, probs_t = _problem(0.0)[3:5]
    _, t = _genos(0.0, torch.float32)
    kw = {k: v for k, v in CFG.items() if k != "use_cross_val"}
    cfg3 = tlinear.VampConfig(max_iter=3, **kw)
    path, old = str(tmp_path / "p.npz"), str(tmp_path / "old.npz")

    def save(it, state, metrics, g):
        tckpt.save_state(path, state, it=it, model="linear",
                         cfg=dataclasses.asdict(cfg3))

    tlinear.infer(t, cfg3, probs_t, vars_t, verbose=False, callbacks=[save])
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files if k != "f_cv_r2"}
    meta = tckpt.read_meta(path)
    meta["fields"] = [f for f in meta["fields"] if f != "cv_r2"]
    arrs["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(old, **arrs)
    st, _ = tckpt.load_state(old, tlinear.LinState, device="cpu")
    assert float(st.cv_r2) == -1.0 and st.cv_r2.dtype == torch.float32
    cfg6 = tlinear.VampConfig(max_iter=N_IT, **kw)
    x_r, _, _ = tlinear.infer(t, cfg6, probs_t, vars_t, verbose=False,
                              resume_state=st)
    x_6, _, _ = tlinear.infer(t, cfg6, probs_t, vars_t, verbose=False)
    np.testing.assert_array_equal(x_r, x_6)


# state_evolution_from_draws against JAX's state_evolution on the same
# draws: f64 to 1e-12 (a mean of Mt derivatives, rounding order only); f32
# (the port in float32 on JAX's draws) to 1e-6 of JAX's f64 values
SE_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}


def _jax_draws(key, prior, prior_b, n_mc):
    """JAX's four draws, made with state_evolution's own key splits
    (gvamp_tpu/linear.py:1205-1214), before the noise scaling."""
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)

    def mix(kc, kn, pr):
        comp = jax.random.categorical(kc, jnp.log(pr.probs), shape=(n_mc,))
        return jax.random.normal(kn, (n_mc,)) * jnp.sqrt(pr.vars[comp])

    return (mix(k1, k2, prior), mix(k3, k4, prior_b),
            jax.random.normal(k5, (n_mc,)), jax.random.normal(k6, (n_mc,)))


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
def test_state_evolution_from_jax_draws(dt):
    probs, vars_ = np.array([0.95, 0.04, 0.01]), np.array([0.0, 2.0, 40.0])
    probs_b, vars_b = np.array([0.9, 0.08, 0.02]), np.array([0.0, 1.5, 30.0])
    pj, pj_b = JPrior(jnp.asarray(probs), jnp.asarray(vars_)), JPrior(
        jnp.asarray(probs_b), jnp.asarray(vars_b))
    gam1, rho, gam1_b, mt = 3.7, 0.4, 2.2, 5000
    key = jax.random.fold_in(jax.random.key(1 + 11), 3)
    want = jlinear.state_evolution(key, pj, gam1, rho, pj_b, gam1_b, mt)
    draws = [torch.tensor(np.asarray(d), dtype=dt)
             for d in _jax_draws(key, pj, pj_b, mt)]
    pt = TPrior(torch.tensor(probs, dtype=dt), torch.tensor(vars_, dtype=dt))
    pt_b = TPrior(torch.tensor(probs_b, dtype=dt),
                  torch.tensor(vars_b, dtype=dt))
    got = tlinear.state_evolution_from_draws(*draws, pt, gam1, rho, pt_b,
                                             gam1_b)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= SE_TOL[dt] * abs(float(w))
    # the port's own draws: the same predictions up to Monte-Carlo error,
    # the same stream on every call
    own = tlinear.state_evolution(1, 3, pt, gam1, rho, pt_b, gam1_b, mt)
    again = tlinear.state_evolution(1, 3, pt, gam1, rho, pt_b, gam1_b, mt)
    assert [float(v) for v in own] == [float(v) for v in again]
    assert abs(float(own[0]) - float(want[0])) < 0.05 * float(want[0])
