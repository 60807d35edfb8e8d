"""The engines of the port on a 4-shard marker mesh against the JAX
package's engines on a 4-device mesh (tests/conftest.py's virtual CPU
devices), in float64, every iteration: the linear engine primal and dual,
probit with 2 covariates, Huber (at N > M, its stable range), a 2-trait
multi-trait run and the dense ``--type-data meth`` container; and the
port's 1-shard run against its 4-shard run on the same padded markers.
Both sides get JAX's probe (and, for probit and Huber, JAX's p1 and
Monte-Carlo draws), as the single-device parity tests pass them; x1 and
the scalars are held within rtol 1e-8, atol 1e-12 at every iteration, the
JAX package's own shard-count limit (tests/test_linear_vamp.py:48-61)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import multi as jmulti
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.data import GenoDense as JGenoDense
from gvamp_tpu_torch import dist
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import multi as tmulti
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.data import GenoDense as TGenoDense
from test_data_layer import make_bed
import test_torch_linear as tl_
import test_torch_meth as tme_
import test_torch_multi as tm_
import test_torch_probit as tp_
import test_torch_robust as tr_

torch.set_num_threads(1)

K = 4
TOL = dict(rtol=1e-8, atol=1e-12)
F64 = torch.float64


def _jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:K]), ("m",))


def _bed_pair(codes, n, covs=None, y=None):
    """JAX's f64 container on the 4-device mesh, the port's on 4 shards."""
    j = JGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                             standardize_phen=False, dtype=jnp.float64,
                             backend="xla", mesh=_jmesh())
    t = TGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                             standardize_phen=False, dtype=F64, device="cpu",
                             mesh=dist.Mesh(K, "cpu"))
    for g in (j, t):
        g.covs = covs
        if y is not None:
            g.set_phen(y)
    assert j.Mpad == t.Mpad and len(t.words) == K
    return j, t


def _keep(store, keys):
    """A callback keeping each iteration's x1, on the stored scale (x1 /
    sqrt(N), the scale of the estimates that tests/test_linear_vamp.py
    holds to these limits), and the named metrics."""
    def cb(it, state, metrics, g):
        x1 = state.x1.cpu() if isinstance(state.x1, torch.Tensor) else \
            state.x1
        store.append((np.asarray(x1, np.float64) / np.sqrt(g.N),
                      {k: np.asarray(metrics[k].cpu() if isinstance(
                          metrics[k], torch.Tensor) else metrics[k],
                          np.float64) for k in keys}))
    return cb


def _same_run(got, want, n_it):
    assert len(got) == len(want) == n_it
    for i, ((xt, mt), (xj, mj)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(xt, xj, err_msg=f"x1 at iteration {i + 1}",
                                   **TOL)
        for k in mt:
            np.testing.assert_allclose(mt[k], mj[k], **TOL,
                                       err_msg=f"{k} at iteration {i + 1}")


LIN_KEYS = ("gam1", "gam2", "gamw", "alpha1", "alpha2")


def _linear(use_xxt):
    if use_xxt:
        import test_torch_xxt as tx_
        codes, y = tx_._make_problem(0.02)[:2]
        n, cfg_kw = tx_.N, tx_.CFG
        priors = tx_._make_problem(0.02)[3:5]
    else:
        prob = tl_._make_problem(0.02)
        codes, y, priors, n = prob[0], prob[1], prob[3:5], tl_.N
        cfg_kw = tl_.CFG
    j, t = _bed_pair(codes, n, y=y)
    n_it = 4
    vars_t, probs_t = priors
    cfg_j = jlinear.VampConfig(max_iter=n_it, **cfg_kw)
    cfg_t = tlinear.VampConfig(max_iter=n_it, **cfg_kw)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    got, want = [], []
    jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False,
                  callbacks=[_keep(want, LIN_KEYS)])
    tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False, bern=bern,
                  callbacks=[_keep(got, LIN_KEYS)])
    return got, want, n_it


def _probit():
    prob = tp_._problem(0.02, 2)
    codes, y, beta, vars_t, probs_t, covs = prob
    j, t = _bed_pair(codes, tp_.N, covs=covs, y=y)
    n_it = 4
    cfg_j = jprobit.ProbitConfig(max_iter=n_it, **tp_.CFG)
    cfg_t = tprobit.ProbitConfig(max_iter=n_it, **tp_.CFG)
    bern = np.asarray(jprobit.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    p1 = np.asarray(jprobit.init_state(j, cfg_j, probs_t, vars_t).p1)
    keys = ("gam1", "gam2", "tau1", "tau2", "alpha2")
    got, want = [], []
    jprobit.infer(j, cfg_j, probs_t, vars_t, verbose=False,
                  callbacks=[_keep(want, keys)])
    tprobit.infer(t, cfg_t, probs_t, vars_t, verbose=False, bern=bern, p1=p1,
                  callbacks=[_keep(got, keys)])
    return got, want, n_it


def _robust():
    # complete genotypes at N = 1,500 > M = 300: the stable range of the
    # Huber dynamics (ROADMAP.md Queue 3)
    codes, y, beta, vars_t, probs_t = tr_._problem(0.0)
    j, t = _bed_pair(codes, tr_.N, y=y)
    n_it = 4
    cfg_j = jrobust.RobustConfig(max_iter=n_it, **tr_.CFG)
    cfg_t = trobust.RobustConfig(max_iter=n_it, **tr_.CFG)
    bern = np.asarray(jrobust.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    keys = ("gam1", "tau1", "tau2", "alpha2", "deltaH")
    got, want = [], []
    jrobust.infer(j, cfg_j, probs_t, vars_t, verbose=False,
                  callbacks=[_keep(want, keys)])
    trobust.infer(t, cfg_t, probs_t, vars_t, verbose=False, bern=bern,
                  mc_draws=tr_.jax_draws(j, cfg_j, n_it),
                  callbacks=[_keep(got, keys)])
    return got, want, n_it


def _multi():
    codes, ys, _, priors = tm_.problem(0.01)
    ys = ys[:2]
    j, t = _bed_pair(codes, tm_.N)
    jmp, tmp = jmulti.MultiPhen.build(j, ys), tmulti.MultiPhen.build(t, ys)
    np.testing.assert_allclose(tmp.mave.numpy(), np.asarray(jmp.mave),
                               rtol=1e-12)
    n_it = 4
    cfg_j = jlinear.VampConfig(max_iter=n_it, **tm_.CFG)
    cfg_t = tlinear.VampConfig(max_iter=n_it, **tm_.CFG)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, 1))
    got, want = [], []
    jmulti.infer(jmp, cfg_j, *priors[0], verbose=False,
                 callbacks=[_keep(want, LIN_KEYS)])
    tmulti.infer(tmp, cfg_t, *priors[0], verbose=False, bern=bern,
                 callbacks=[_keep(got, LIN_KEYS)])
    return got, want, n_it


def _meth():
    X, y, beta, vars_t, probs_t = tme_.PROBLEM
    n = tme_.N
    j = JGenoDense.from_arrays(X, y, N=n, dtype=jnp.float64, mesh=_jmesh())
    t = TGenoDense.from_arrays(X, y, N=n, dtype=F64, device="cpu",
                               mesh=dist.Mesh(K, "cpu"))
    assert j.Mpad == t.Mpad == 96 and len(t.X) == K
    np.testing.assert_allclose(t.mave.numpy(), np.asarray(j.mave), rtol=1e-12)
    np.testing.assert_allclose(t.msig.numpy(), np.asarray(j.msig), rtol=1e-12)
    n_it = 4
    kw = dict(max_iter=n_it, rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=5)
    bern = np.asarray(jlinear.make_bern_probe(j, 5, 1))
    got, want = [], []
    jlinear.infer(j, jlinear.VampConfig(**kw), probs_t, vars_t,
                  verbose=False, callbacks=[_keep(want, LIN_KEYS)])
    tlinear.infer(t, tlinear.VampConfig(**kw), probs_t, vars_t,
                  verbose=False, bern=bern, callbacks=[_keep(got, LIN_KEYS)])
    return got, want, n_it


# JAX compiles each engine's step under the mesh in 5-30 s on the CPU, so
# the runs are spread over this file and tests/test_torch_dist_dual.py and
# tests/test_torch_dist_zmodel.py, each under a minute
RUNS = {"linear": lambda: _linear(False), "linear_dual": lambda: _linear(True),
        "probit_2cov": _probit, "huber": _robust, "multi_2trait": _multi,
        "meth": _meth}


@pytest.mark.parametrize("run", ["linear", "meth"])
def test_engine_on_mesh_matches_jax_mesh(run):
    _same_run(*RUNS[run]())


def test_one_shard_equals_four_shards():
    """The port's linear engine on one device and on a 4-shard mesh over
    the same padded markers (Mpad 2,048 on both), with the port's own
    probe: the same trajectory to rtol 1e-8 at every iteration, the same
    CG counts, and the probe's real rows do not depend on Mpad."""
    prob = tl_._make_problem(0.02)
    codes, y, beta, vars_t, probs_t = prob
    n = tl_.N
    one = TGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                               standardize_phen=False, dtype=F64,
                               device="cpu", marker_align=512 * K)
    four = TGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                                standardize_phen=False, dtype=F64,
                                device="cpu", mesh=dist.Mesh(K, "cpu"))
    small = TGenoBed.from_arrays(make_bed(codes), np.zeros(n), N=n,
                                 standardize_phen=False, dtype=F64,
                                 device="cpu")
    for g in (one, four, small):
        g.set_phen(y)
    assert one.Mpad == four.Mpad == 2048 and small.Mpad == 512
    m = tl_.M
    u_small = tlinear.make_bern_probe(small, 5, 2)
    u_four = tlinear.make_bern_probe(four, 5, 2)
    assert torch.equal(u_small[:m], u_four[:m]) and not u_four[m:].any()
    cfg = tlinear.VampConfig(max_iter=4, **tl_.CFG)
    got, want = [], []
    _, _, h1 = tlinear.infer(one, cfg, probs_t, vars_t, verbose=False,
                             callbacks=[_keep(want, LIN_KEYS)])
    _, _, h4 = tlinear.infer(four, cfg, probs_t, vars_t, verbose=False,
                             callbacks=[_keep(got, LIN_KEYS)])
    _same_run(got, want, 4)
    assert [h["cg_iters"] for h in h4] == [h["cg_iters"] for h in h1]
    # a mesh adds no host sync to an iteration
    assert [h["host_syncs"] for h in h4] == [h["host_syncs"] for h in h1]
