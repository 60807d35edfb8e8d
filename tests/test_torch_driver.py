"""The port's driver options and the CLI flags of the probe path: chunked
runs (``sync_every``) against single steps, phase timers against the
untimed step, ``--sync-every`` / ``--phase-timers`` / ``--store-pip`` /
``--profile-dir`` through the CLI (the pip file against the JAX CLI's
``_store_pip`` on the same state), and checkpoints with probe columns:
a JAX checkpoint from before the SLQ traces resumed by the port against
JAX's own resume, and ``--use-slq 0 --checkpoint`` then ``restart
--resume`` equal bit for bit to an uninterrupted run."""

import dataclasses
import json
import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import ckpt as jckpt
from gvamp_tpu import cli as jcli
from gvamp_tpu import linear as jlinear
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu.io import vecio
from gvamp_tpu_torch import ckpt as tckpt
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import multi as tmulti
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
import test_torch_ckpt as tc_
import test_torch_linear as tl_
import test_torch_multi as tm_
import test_torch_multi_zmodel as tz_

torch.set_num_threads(1)


def _same_history(a, b):
    """Two histories equal in every metric but the sync count."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            if k != "host_syncs":
                np.testing.assert_array_equal(np.asarray(x[k]),
                                              np.asarray(y[k]), err_msg=k)


def _same_state(a, b):
    for name, u, v in zip(a._fields, a, b):
        if isinstance(u, torch.Generator):
            assert torch.equal(u.get_state(), v.get_state()), name
        elif isinstance(u, torch.Tensor):
            assert torch.equal(u, v), name
        else:
            assert u == v, name


def _linear(sync_every=1, **kw):
    prob = tl_._make_problem(0.02)
    _, t = tl_._genos(prob, torch.float32)
    cfg = tlinear.VampConfig(max_iter=4, stop_criteria_thr=0.0, **tl_.CFG)
    return tlinear.infer(t, cfg, *prob[4:2:-1], verbose=False,
                         sync_every=sync_every, **kw)


def _probit(sync_every=1, **kw):
    import test_torch_probit as tp_
    prob = tp_._problem(0.02, 2)
    _, t = tp_._genos(prob, torch.float32)
    cfg = tprobit.ProbitConfig(max_iter=4, stop_criteria_thr=0.0, **tp_.CFG)
    return tprobit.infer(t, cfg, prob[4], prob[3], verbose=False,
                         sync_every=sync_every, **kw)


def _robust(sync_every=1, **kw):
    import test_torch_robust as tr_
    prob = tr_._problem(0.0)
    _, t = tr_._genos(prob, torch.float32)
    cfg = trobust.RobustConfig(max_iter=4, stop_criteria_thr=0.0, **tr_.CFG)
    return trobust.infer(t, cfg, prob[4], prob[3], verbose=False,
                         sync_every=sync_every, **kw)


def _multi(engine):
    def run(sync_every=1, **kw):
        if engine == "linear":
            codes, ys, _, priors = tm_.problem(0.01)
            mp = tmulti.MultiPhen.build(tm_.port_geno(codes, torch.float32),
                                        ys)
            cfg = tlinear.VampConfig(max_iter=4, **tm_.CFG)
            return tmulti.infer(mp, cfg, *priors[0], verbose=False,
                                sync_every=sync_every, **kw)
        if engine == "probit":
            pp = tz_.probit_problem()
            mp = tmulti.MultiPhen.build(
                tm_.port_geno(pp["codes"], torch.float32, covs=pp["covs"]),
                pp["ys"], standardize=False)
            cfg = tprobit.ProbitConfig(max_iter=4, **tz_.P_CFG)
            return tmulti.infer_probit(mp, cfg, *pp["prior"], verbose=False,
                                       sync_every=sync_every, **kw)
        hp = tz_.huber_problem()
        mp = tmulti.MultiPhen.build(
            tm_.port_geno(hp["codes"], torch.float32, n=tz_.H_N), hp["ys"])
        cfg = trobust.RobustConfig(max_iter=4, **tz_.H_CFG)
        return tmulti.infer_huber(mp, cfg, *hp["prior"], verbose=False,
                                  sync_every=sync_every, **kw)
    return run


RUNS = {"linear": _linear, "bin_class": _probit, "robust": _robust,
        "multi_linear": _multi("linear"), "multi_bin_class": _multi("probit"),
        "multi_robust": _multi("robust")}


@pytest.mark.parametrize("engine", list(RUNS))
def test_sync_every_equals_single_steps(engine):
    """Four iterations as one chunk of 3 and a single last step equal four
    single steps bit for bit (state, estimate and every metric), in every
    engine: the state stops exactly at max_iter (tests/test_round3.py:
    488-510).  The callbacks run once per chunk, at iterations 3 and 4,
    and the chunk fetches its metrics once, which saves two counted
    syncs."""
    run = RUNS[engine]
    seen = []
    x1, s1, h1 = run(1)
    x3, s3, h3 = run(3, callbacks=[lambda it, s, m, g: seen.append(it)])
    assert s3.it == s1.it == 4 and len(h3) == 4
    assert seen == [3, 4]
    np.testing.assert_array_equal(x3, x1)
    _same_state(s3, s1)
    _same_history(h3, h1)
    assert (sum(h["host_syncs"] for h in h1)
            - sum(h["host_syncs"] for h in h3)) == 2
    # the chunk's one fetch is counted on its last step
    assert [h["host_syncs"] for h in h3] == [
        h["host_syncs"] - (i < 2) for i, h in enumerate(h1)]


# (engine, extra cfg) of the timed runs, and JAX's phase names for each
TIMED = [("linear", {}), ("linear", dict(use_xxt=True)),
         ("linear", dict(use_slq=False, fold_noise=False)),
         ("bin_class", {}), ("robust", dict(use_slq=False))]


@pytest.mark.parametrize("engine,kw", TIMED)
def test_phase_timers_equal_the_untimed_step(engine, kw):
    """phase_timers: each history entry gets phase_ms_<name> under JAX's
    phase names (its make_step(phased=True)), and the numbers equal the
    untimed run bit for bit."""
    jmod, tmod = {"linear": (jlinear, tlinear),
                  "bin_class": (jprobit, tprobit),
                  "robust": (jrobust, trobust)}[engine]
    prob = tc_._problem(engine)
    j, t = tc_._genos(engine, torch.float32)
    cfg_cls = tc_.ENGINES[engine][1]
    ckw = dict(tc_.ENGINES[engine][4], max_iter=3, stop_criteria_thr=0.0,
               **kw)
    names = [nm for nm, _ in jmod.make_step(
        j, getattr(jmod, cfg_cls.__name__)(**ckw), phased=True)]
    cfg = cfg_cls(**ckw)
    x0, s0, h0 = tmod.infer(t, cfg, prob[4], prob[3], verbose=False)
    x1, s1, h1 = tmod.infer(t, cfg, prob[4], prob[3], verbose=False,
                            phase_timers=True, sync_every=3)
    np.testing.assert_array_equal(x1, x0)
    _same_state(s1, s0)
    for h in h1:
        assert [k[len("phase_ms_"):] for k in h
                if k.startswith("phase_ms_")] == names
        assert all(h[f"phase_ms_{n}"] >= 0 for n in names)
    _same_history([{k: v for k, v in h.items()
                    if not k.startswith("phase_ms_")} for h in h1], h0)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


def test_cli_sync_every_and_phase_timers(tmp_path, capsys):
    """--sync-every 3 at 4 iterations (the stopping test off) writes the
    same iteration-4 dump as --sync-every 1, and dumps only at the chunk
    ends; --phase-timers 1 prints one line of JAX's phase names per
    iteration and writes the same estimate."""
    pre = str(tmp_path / "out")
    runs = {"one": [], "three": ["--sync-every", "3"],
            "timed": ["--phase-timers", "1"]}
    for name, extra in runs.items():
        tcli.main(["--run-mode", "infere"]
                  + tc_._cli_args("linear", tmp_path, 4, name) + extra
                  + ["--verbosity", "1"])
    out = capsys.readouterr().out
    m = tl_.M
    want = vecio.read_bin_shard(f"{pre}/one_it_4.bin", m, 0)
    for name in ("three", "timed"):
        np.testing.assert_array_equal(
            vecio.read_bin_shard(f"{pre}/{name}_it_4.bin", m, 0), want)
    assert os.path.exists(f"{pre}/three_it_3.bin")
    assert not os.path.exists(f"{pre}/three_it_2.bin")
    assert os.path.exists(f"{pre}/timed_it_2.bin")
    lines = [ln for ln in out.splitlines() if "lmmse_cg=" in ln]
    assert len(lines) == 4
    for nm in ("denoise", "z1_project", "lmmse_cg", "noise_em", "finish"):
        assert f"{nm}=" in lines[0]


def _jax_pip(opt, geno_t, state, tag="", T=0):
    """JAX's _store_pip on the port's final state."""
    def j(x):
        return jnp.asarray(x.cpu().numpy())

    st = SimpleNamespace(r1=j(state.r1), gam1=j(state.gam1),
                         probs=j(state.probs), vars=j(state.vars))
    jcli._store_pip(opt, SimpleNamespace(M=geno_t.M, S=geno_t.S), st,
                    tag=tag, T=T)


@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_cli_store_pip_matches_jax(model, tmp_path):
    """--store-pip 1: the file holds each marker's posterior inclusion
    probability at the final iterate, in [0, 1], the causal markers
    higher; equal (f64 run, 1e-12) to JAX's _store_pip on the same state;
    with two phenotypes one file per trait."""
    codes, y, beta = tc_._problem(model)[:3]
    ck = str(tmp_path / "ck.npz")
    args = tc_._cli_args(model, tmp_path, 3, "pip") + [
        "--dtype", "float64", "--store-pip", "1"]
    tcli.main(["--run-mode", "infere", "--checkpoint", ck] + args)
    tag = tcli._TAGS[model]
    pre = str(tmp_path / "out" / "pip")
    got = vecio.read_bin_shard(f"{pre}{tag}_pip.bin", codes.shape[0], 0)
    assert np.all((got >= 0) & (got <= 1))
    assert np.median(got[beta != 0]) > np.median(got[beta == 0])
    # the final state, from the checkpoint written at the last iteration
    state, meta = tckpt.load_state(ck, tc_.ENGINES[model][2], device="cpu")
    assert meta["it"] == 3
    jopt = SimpleNamespace(out_prefix=str(tmp_path / "jax"))
    _jax_pip(jopt, SimpleNamespace(M=codes.shape[0], S=0), state, tag)
    want = vecio.read_bin_shard(f"{jopt.out_prefix}{tag}_pip.bin",
                                codes.shape[0], 0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    # several phenotypes: {out}_phen{t}{tag}_pip.bin per trait
    phen = str(tmp_path / "d.phen")
    two = list(args)
    two[two.index("--phen-files") + 1] = f"{phen},{phen}"
    two[two.index("--out-name") + 1] = "two"
    tcli.main(["--run-mode", "infere"] + two)
    for t in range(2):
        p = vecio.read_bin_shard(
            str(tmp_path / "out" / f"two_phen{t}{tag}_pip.bin"),
            codes.shape[0], 0)
        assert np.all((p >= 0) & (p <= 1))
        assert np.median(p[beta != 0]) > np.median(p[beta == 0])


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """--profile-dir on the CPU: the run mode under torch.profiler, its
    Chrome trace in DIR/trace.json naming the port's products, and the
    run's dumps as without it."""
    prof = str(tmp_path / "prof")
    tcli.main(["--run-mode", "infere", "--profile-dir", prof]
              + tc_._cli_args("linear", tmp_path, 2, "p"))
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert len(names) > 10
    assert os.path.exists(str(tmp_path / "out" / "p_it_2.bin"))


# --------------------------------------------------------------------------
# checkpoints with probe columns
# --------------------------------------------------------------------------


def test_jax_pre_slq_checkpoint_resumed_by_port(tmp_path, monkeypatch):
    """A JAX linear checkpoint from before the SLQ traces (its cfg without
    use_slq, its state with one probe column): the port's CLI resume
    restores use_slq=False (gvamp_tpu/cli.py:479-489), continues the probe
    path and matches JAX's own resume of the same checkpoint, f64, JAX's
    probe on both sides: the f64 recipe's limits."""
    model = "linear"
    vars_t, probs_t = tc_._problem(model)[3:5]
    j, _ = tc_._genos(model, torch.float64)
    # JAX runs on the phenotype the CLI loads (standardised)
    args = tc_._cli_args(model, tmp_path, 3, "re") + ["--dtype", "float64"]
    g = tcli._load_geno(tcli.Options.from_args(args[2:]), "cpu")
    j.set_phen(np.asarray(g.deplanarize(g.y_planar))[:g.N])
    kw = dict(tc_.ENGINES[model][4], stop_criteria_thr=0.0)
    cfg3 = jlinear.VampConfig(max_iter=3, use_slq=False, **kw)
    path = str(tmp_path / "pre.npz")
    _, js, _ = jlinear.infer(j, cfg3, probs_t, vars_t, verbose=False)
    cfg_d = dataclasses.asdict(cfg3)
    del cfg_d["use_slq"]
    jckpt.save_state(path, js, it=3, model=model, cfg=cfg_d)
    js3, meta = jckpt.load_state(path, jlinear.LinState)
    assert js3.mu_probe.shape[1] == 1
    cfg6 = jlinear.VampConfig(**dict(cfg_d, max_iter=6, use_slq=False))
    x_j, _, h_j = jlinear.infer(j, cfg6, probs_t, vars_t, verbose=False,
                                resume_state=js3)
    bern = np.asarray(jlinear.make_bern_probe(j, kw["seed"], 1))
    monkeypatch.setattr(tlinear, "make_bern_probe",
                        lambda g, seed, n=1: torch.tensor(bern,
                                                          dtype=g.dtype))
    tcli.main(["--run-mode", "restart", "--resume", path] + args)
    m = tc_._problem(model)[0].shape[0]
    got = vecio.read_bin_shard(str(tmp_path / "out" / "re_it_6.bin"), m, 0)
    assert tc_._rel(got, x_j) < 1e-8
    # the checkpoint without its probe warm starts zero-fills one column
    old = str(tmp_path / "old.npz")
    tc_._drop_fields(path, old, {"mu_probe", "gmu"})
    got_t, _ = tckpt.load_state(old, tlinear.LinState, device="cpu")
    want_t, _ = jckpt.load_state(old, jlinear.LinState)
    assert got_t.mu_probe.shape == tuple(want_t.mu_probe.shape) == (j.Mpad, 1)
    assert got_t.gmu.shape == tuple(want_t.gmu.shape)


@pytest.mark.parametrize("model", tc_.MODELS)
def test_cli_probe_path_resume_equals_uninterrupted(model, tmp_path):
    """--use-slq 0 --checkpoint for 3 iterations, then restart --resume
    for 3 more: the iteration-6 dump equals a 6-iteration run's bit for
    bit, and the checkpoint carries the probe column."""
    tag = tcli._TAGS[model]
    ck = str(tmp_path / "ck.npz")
    slq0 = ["--use-slq", "0"]
    tcli.main(["--run-mode", "infere"]
              + tc_._cli_args(model, tmp_path, 6, "full") + slq0)
    tcli.main(["--run-mode", "infere", "--checkpoint", ck]
              + tc_._cli_args(model, tmp_path, 3, "part") + slq0)
    meta = tckpt.read_meta(ck)
    assert meta["cfg"]["use_slq"] is False
    st, _ = tckpt.load_state(ck, tc_.ENGINES[model][2], device="cpu")
    assert st.mu_probe.shape[1] == 1 and st.mu_probe.abs().max() > 0
    tcli.main(["--run-mode", "restart", "--resume", ck]
              + tc_._cli_args(model, tmp_path, 3, "part"))
    pre = str(tmp_path / "out")
    m = tc_._problem(model)[0].shape[0]
    np.testing.assert_array_equal(
        vecio.read_bin_shard(f"{pre}/part{tag}_it_6.bin", m, 0),
        vecio.read_bin_shard(f"{pre}/full{tag}_it_6.bin", m, 0))
