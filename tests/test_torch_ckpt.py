"""Full-state checkpoints of the port (gvamp_tpu_torch/ckpt.py) and the
CLI's --checkpoint / --run-mode restart, for the linear, probit and Huber
engines: round trips, a resumed run equal bit for bit to an uninterrupted
one, checkpoints written by the JAX package resumed by the port against
JAX's own resume, the checkpoints the port refuses, and both forms of
restart through the CLI."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gvamp_tpu import ckpt as jckpt
from gvamp_tpu import linear as jlinear
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu.io import plink, vecio
from gvamp_tpu_torch import ckpt as tckpt
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
from test_torch_linear import _genos as lin_genos
from test_torch_linear import _make_problem as lin_problem
from test_torch_probit import _genos as probit_genos
from test_torch_probit import _problem as probit_problem
from test_torch_robust import _genos as robust_genos
from test_torch_robust import _problem as robust_problem

torch.set_num_threads(1)

# engine -> (port module, config, state class, JAX module, config kwargs)
ENGINES = {
    "linear": (tlinear, tlinear.VampConfig, tlinear.LinState, jlinear,
               dict(rho=0.3, gam1_init=1e-8, gamw_init=2.0, seed=5)),
    "bin_class": (tprobit, tprobit.ProbitConfig, tprobit.ProbitState,
                  jprobit, dict(rho=0.3, seed=2, probit_var=1.0)),
    "robust": (trobust, trobust.RobustConfig, trobust.RobustState, jrobust,
               dict(rho=0.3, seed=5)),
}
MODELS = tuple(ENGINES)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-300))


_LIN = {}


def _problem(model, miss=0.0):
    """(codes, y, beta, vars_t, probs_t) of each engine's parity recipe."""
    if model == "linear":
        if miss not in _LIN:
            _LIN[miss] = lin_problem(miss)
        return _LIN[miss]
    if model == "bin_class":
        return probit_problem(miss, 0)[:5]
    return robust_problem(miss)


def _genos(model, dt, miss=0.0):
    """(JAX container, port container) with the engine's phenotype."""
    if model == "linear":
        return lin_genos(_problem(model, miss), dt)
    if model == "bin_class":
        return probit_genos(probit_problem(miss, 0), dt)
    return robust_genos(_problem(model, miss), dt)


def _run(model, g, n_it, resume=None, callbacks=()):
    mod, cfg_cls, _, _, kw = ENGINES[model]
    vars_t, probs_t = _problem(model)[3:5]
    cfg = cfg_cls(max_iter=n_it, stop_criteria_thr=0.0, **kw)
    return mod.infer(g, cfg, probs_t, vars_t, verbose=False,
                     resume_state=resume, callbacks=list(callbacks)), cfg


def _fields_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        if isinstance(u, torch.Generator):
            assert torch.equal(u.get_state(), v.get_state()), name
        elif isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v), name
        else:
            assert u == v and isinstance(v, int), name


@pytest.mark.parametrize("model", MODELS)
def test_round_trip(model, tmp_path):
    """save_state then load_state gives every field back equal, the
    generator's bytes included, with the metadata."""
    _, t = _genos(model, torch.float32)
    (_, state, _), cfg = _run(model, t, 2)
    path = str(tmp_path / "s.npz")
    tckpt.save_state(path, state, it=state.it, model=model,
                     cfg=dataclasses.asdict(cfg))
    meta = tckpt.read_meta(path)
    assert meta["fields"] == list(ENGINES[model][2]._fields)
    assert (meta["it"], meta["model"]) == (2, model)
    assert meta["gen_fields"] == (["gen"] if model == "robust" else [])
    back, meta2 = tckpt.load_state(path, ENGINES[model][2], device="cpu")
    assert meta2 == meta
    _fields_equal(state, back)


@pytest.mark.parametrize("model", MODELS)
def test_resume_equals_uninterrupted(model, tmp_path):
    """On the CPU, 6 iterations in one run equal, bit for bit, 3
    iterations, a checkpoint, and 3 more from it (the Huber draws come
    from the generator the checkpoint carries)."""
    _, t = _genos(model, torch.float32)
    (x6, s6, h6), _ = _run(model, t, 6)
    path = str(tmp_path / "s.npz")

    def ck(it, state, m, g):
        tckpt.save_state(path, state, it=it, model=model)

    _run(model, t, 3, callbacks=[ck])
    resumed, _ = tckpt.load_state(path, ENGINES[model][2], device="cpu")
    assert resumed.it == 3
    (x, s, h), _ = _run(model, t, 6, resume=resumed)
    assert len(h) == 3 and len(h6) == 6
    np.testing.assert_array_equal(x, x6)
    _fields_equal(s, s6)
    for a, b in zip(h, h6[3:]):
        for k, v in a.items():
            if k != "host_syncs":
                np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]),
                                              err_msg=k)


# A JAX checkpoint at iteration 3, resumed by JAX and by the port for 3
# more, f64, JAX's probe on both sides: the limits of the 6-iteration f64
# recipes (tests/test_torch_linear.py, tests/test_torch_probit.py)
@pytest.mark.parametrize("model", ("linear", "bin_class"))
def test_jax_checkpoint_resumed_by_port(model, tmp_path):
    mod, cfg_cls, state_cls, jmod, kw = ENGINES[model]
    vars_t, probs_t = _problem(model)[3:5]
    j, t = _genos(model, torch.float64, 0.02)
    jcfg_cls = jlinear.VampConfig if model == "linear" else \
        jprobit.ProbitConfig
    path = str(tmp_path / "j.npz")
    cfg3 = jcfg_cls(max_iter=3, **kw)
    dump = jckpt.IterDumper(str(tmp_path / "j"), model=model, checkpoint=path,
                            meta={"cfg": dataclasses.asdict(cfg3)})
    jmod.infer(j, cfg3, probs_t, vars_t, verbose=False, callbacks=[dump])
    cfg6 = jcfg_cls(max_iter=6, **kw)
    js, _ = jckpt.load_state(path, jmod.__dict__[state_cls.__name__])
    x_j, _, h_j = jmod.infer(j, cfg6, probs_t, vars_t, verbose=False,
                             resume_state=js)
    ts, meta = tckpt.load_state(path, state_cls, device="cpu",
                                dtype=torch.float64)
    assert ts.it == 3 and meta["model"] == model
    if model == "linear":
        assert "cv_r2" in meta["fields"]
        assert float(ts.cv_r2) == float(js.cv_r2) == -1
    bern = np.asarray(jlinear.make_bern_probe(j, kw["seed"], 1))
    x_t, _, h_t = mod.infer(t, cfg_cls(max_iter=6, **kw), probs_t, vars_t,
                            verbose=False, resume_state=ts, bern=bern)
    assert len(h_t) == len(h_j) == 3
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    assert _rel(x_t, x_j) < 1e-8
    for k in ("gam1", "gam2", "alpha2"):
        np.testing.assert_allclose(float(h_t[-1][k]), float(h_j[-1][k]),
                                   rtol=1e-8, err_msg=k)


def _drop_fields(path, out, drop):
    """Rewrite an npz checkpoint without the fields ``drop``."""
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files if k[2:] not in drop}
        meta = tckpt.read_meta(path)
    meta["fields"] = [f for f in meta["fields"] if f not in drop]
    arrs["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(out, **arrs)


@pytest.mark.parametrize("model", ("linear", "bin_class"))
def test_missing_warm_start_fields_zero_filled_as_jax(model, tmp_path):
    """A checkpoint without the warm-start fields loads with the zeros
    (and shapes) the JAX package's load_state gives them."""
    _, _, state_cls, jmod, kw = ENGINES[model]
    vars_t, probs_t = _problem(model)[3:5]
    j, _ = _genos(model, torch.float64)
    jcfg = (jlinear.VampConfig if model == "linear"
            else jprobit.ProbitConfig)(max_iter=2, **kw)
    _, js, _ = jmod.infer(j, jcfg, probs_t, vars_t, verbose=False)
    full, old = str(tmp_path / "full.npz"), str(tmp_path / "old.npz")
    jckpt.save_state(full, js, it=2, model=model,
                     cfg=dataclasses.asdict(jcfg))
    drop = {"gmu", "mu_cg", "mu_probe"}
    drop |= ({"gmu_n", "mu_probe_n", "mu_prevb", "gmu_prev"}
             if model == "linear" else {"tau_gmu"})
    _drop_fields(full, old, drop)
    want, _ = jckpt.load_state(old, type(js))
    got, _ = tckpt.load_state(old, state_cls, device="cpu")
    for f in drop:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any(), f
    np.testing.assert_array_equal(got.x1.numpy(), np.asarray(want.x1))


def test_unresumable_checkpoints_raise(tmp_path):
    """A JAX Huber checkpoint (a threefry key) raises ValueError naming
    why, from load_state and from the CLI's resume.  A checkpoint whose cfg
    lacks use_slq predates the SLQ traces and resumes on the probe path
    (tests/test_torch_driver.py): one written with SLQ on and its cfg's
    use_slq removed loads, and its resume under that path raises on the
    probe-column width, as JAX's (gvamp_tpu/linear.py:219-233)."""
    vars_t, probs_t = _problem("robust")[3:5]
    j, _ = _genos("robust", torch.float64)
    jcfg = jrobust.RobustConfig(max_iter=1, rho=0.3, seed=5)
    _, js, _ = jrobust.infer(j, jcfg, probs_t, vars_t, verbose=False)
    huber = str(tmp_path / "huber.npz")
    jckpt.save_state(huber, js, it=1, model="robust",
                     cfg=dataclasses.asdict(jcfg))
    with pytest.raises(ValueError, match="threefry key"):
        tckpt.load_state(huber, trobust.RobustState, device="cpu")
    jl, _ = _genos("linear", torch.float64)
    lcfg = jlinear.VampConfig(max_iter=1)
    lvars, lprobs = _problem("linear")[3:5]
    _, ls, _ = jlinear.infer(jl, lcfg, lprobs, lvars, verbose=False)
    cfg_d = dataclasses.asdict(lcfg)
    del cfg_d["use_slq"]
    pre = str(tmp_path / "pre.npz")
    jckpt.save_state(pre, ls, it=1, model="linear", cfg=cfg_d)
    st, meta = tckpt.load_state(pre, tlinear.LinState, device="cpu")
    assert st.mu_probe.shape[1] == 0 and "use_slq" not in meta["cfg"]
    jl_t = _genos("linear", torch.float64)[1]
    with pytest.raises(ValueError, match="probe column"):
        tlinear.infer(jl_t, tlinear.VampConfig(max_iter=2, use_slq=False),
                      lprobs, lvars, verbose=False, resume_state=st)
    codes, y = _problem("robust")[:2]
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    plink.write_bed(bed, codes)
    plink.write_phen(phen, y)
    base = ["--device", "cpu", "--run-mode", "restart", "--bed-file", bed,
            "--phen-files", phen, "--N", str(j.N), "--Mt", str(j.M),
            "--verbosity", "0", "--out-dir", str(tmp_path / "out")]
    with pytest.raises(ValueError, match="threefry key"):
        tcli.main(base + ["--model", "robust", "--resume", huber])
    with pytest.raises(SystemExit):
        tcli.main(base + ["--model", "linear", "--resume", huber])


def _cli_args(model, tmp_path, n_it, name):
    codes, y, _, vars_t, probs_t = _problem(model)
    bed, phen = str(tmp_path / "d.bed"), str(tmp_path / "d.phen")
    if not os.path.exists(bed):
        plink.write_bed(bed, codes)
        plink.write_phen(phen, y)
    kw = ENGINES[model][4]
    args = ["--device", "cpu", "--model", model, "--bed-file", bed,
            "--phen-files", phen, "--N", str(len(y)),
            "--Mt", str(codes.shape[0]), "--iterations", str(n_it),
            "--rho", str(kw["rho"]), "--seed", str(kw["seed"]),
            "--stop-criteria-thr", "0", "--probs",
            ",".join(map(str, probs_t)), "--vars",
            ",".join(map(str, vars_t)), "--verbosity", "0",
            "--out-dir", str(tmp_path / "out"), "--out-name", name]
    if model == "bin_class":
        args += ["--probit-var", str(kw["probit_var"])]
    return args


@pytest.mark.parametrize("model", MODELS)
def test_cli_resume_equals_uninterrupted(model, tmp_path):
    """infere with --checkpoint for 3 iterations, then restart --resume for
    3 more: the iteration-6 dump equals that of a 6-iteration run bit for
    bit, and the resumed run writes its own checkpoint at iteration 6."""
    tag = tcli._TAGS[model]
    ck = str(tmp_path / "ck.npz")
    tcli.main(["--run-mode", "infere"] + _cli_args(model, tmp_path, 6, "full"))
    tcli.main(["--run-mode", "infere", "--checkpoint", ck]
              + _cli_args(model, tmp_path, 3, "part"))
    meta = tckpt.read_meta(ck)
    assert meta["it"] == 3 and meta["cfg"]["max_iter"] == 3
    ck2 = str(tmp_path / "ck2.npz")
    tcli.main(["--run-mode", "restart", "--resume", ck, "--checkpoint", ck2]
              + _cli_args(model, tmp_path, 3, "part"))
    pre = str(tmp_path / "out")
    m = _problem(model)[0].shape[0]
    full = vecio.read_bin_shard(f"{pre}/full{tag}_it_6.bin", m, 0)
    part = vecio.read_bin_shard(f"{pre}/part{tag}_it_6.bin", m, 0)
    np.testing.assert_array_equal(part, full)
    assert tckpt.read_meta(ck2)["it"] == 6
    assert tckpt.read_meta(ck2)["cfg"]["max_iter"] == 6


def test_cli_restart_from_estimate_file(tmp_path):
    """--run-mode restart --estimate-file (linear, f64): r1 from the file
    with --gam1-init / --gamw-init injected.  The dump equals a library run
    from the same values, and that run matches the JAX package's restart
    from them (its linear.infer with r1_init, as its CLI calls it) with
    JAX's probe, to the f64 recipe's 1e-8."""
    model = "linear"
    tcli.main(["--run-mode", "infere"] + _cli_args(model, tmp_path, 3,
                                                   "first"))
    est = str(tmp_path / "out" / "first_it_3.bin")
    codes, y, _, vars_t, probs_t = _problem(model)
    M = codes.shape[0]
    tcli.main(["--run-mode", "restart", "--dtype", "float64",
               "--estimate-file", est, "--gam1-init", "0.5", "--gamw-init",
               "1.7"] + _cli_args(model, tmp_path, 3, "re"))
    dump = vecio.read_bin_shard(str(tmp_path / "out" / "re_it_3.bin"), M, 0)
    g = tcli._load_geno(tcli.Options.from_args(
        ["--dtype", "float64"] + _cli_args(model, tmp_path, 3, "x")[2:]),
        "cpu")
    kw = dict(max_iter=3, rho=0.3, seed=5, gam1_init=0.5, gamw_init=1.7,
              stop_criteria_thr=0.0)
    r1 = vecio.read_estimate(est, M, 0)
    _, state, _ = tlinear.infer(g, tlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False, r1_init=r1)
    np.testing.assert_array_equal(dump,
                                  state.x1[:M].numpy() * (1 / np.sqrt(len(y))))
    j, t = _genos(model, torch.float64)
    j.set_phen(np.asarray(g.deplanarize(g.y_planar))[:len(y)])
    t.set_phen(np.asarray(g.deplanarize(g.y_planar))[:len(y)])
    bern = np.asarray(jlinear.make_bern_probe(j, 5, 1))
    x_j, _, h_j = jlinear.infer(j, jlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False, r1_init=r1)
    x_t, _, h_t = tlinear.infer(t, tlinear.VampConfig(**kw), probs_t, vars_t,
                                verbose=False, r1_init=r1, bern=bern)
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    assert _rel(x_t, x_j) < 1e-8
