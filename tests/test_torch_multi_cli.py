"""The multi-trait parts of the port's CLI and checkpoints
(gvamp_tpu_torch/cli.py, ckpt.py): ``--phen-files a,b,c`` against the
library run, its per-trait LOO / LOCO p-value files against the JAX CLI's
``_store_pvals_multi`` on the same z1 and x1, ``--checkpoint`` / ``--run-mode
restart --resume`` equal bit for bit to an uninterrupted run for all three
models, JAX multi-trait checkpoints resumed by the port (linear and
bin_class; a Huber one holds a threefry key and is refused), and the
refusals that remain."""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu import cli as jcli
from gvamp_tpu import ckpt as jckpt
from gvamp_tpu import linear as jlinear
from gvamp_tpu import multi as jmulti
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu.data import GenoBed as JGenoBed
from gvamp_tpu.io import plink, vecio
from gvamp_tpu_torch import ckpt as tckpt
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import multi as tmulti
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch.data import GenoBed as TGenoBed
from gvamp_tpu_torch.io import vecio as tvecio
from test_torch_multi import CFG, T, jax_geno, port_geno, problem, rel
from test_torch_multi_zmodel import (H_CFG, H_N, P_CFG, huber_problem,
                                     probit_problem)

torch.set_num_threads(1)

# |log10 p| of the CLI's f32 p-values against JAX's on the same z1 and x1,
# relative to max(1, |log10 p|): tests/test_torch_linear.py's CLI_LOG10P_TOL
CLI_LOG10P_TOL = 2e-6


def _files(tmp_path, model):
    """(bed, [phen], bim, cov or None, n, m, prior) of each model's recipe,
    written once per test directory."""
    if model == "linear":
        codes, ys, _, priors = problem(0.01)
        prior, covs = priors[0], None
    elif model == "bin_class":
        pp = probit_problem()
        codes, ys, prior, covs = pp["codes"], pp["ys"], pp["prior"], pp["covs"]
    else:
        hp = huber_problem()
        codes, ys, prior, covs = hp["codes"], hp["ys"], hp["prior"], None
    d = tmp_path / model
    d.mkdir(exist_ok=True)
    bed, bim = str(d / "d.bed"), str(d / "d.bim")
    m = codes.shape[0]
    plink.write_bed(bed, codes)
    plink.write_bim(bim, np.repeat(np.arange(1, 5), m // 4))
    phens = []
    for t, y in enumerate(ys):
        phens.append(str(d / f"t{t}.phen"))
        plink.write_phen(phens[-1], y)
    cov = None
    if covs is not None:
        cov = str(d / "d.cov")
        plink.write_covariates(cov, covs)
    return bed, phens, bim, cov, codes.shape[1], m, prior


def _args(model, files, n_it, out, name, extra=()):
    bed, phens, bim, cov, n, m, (probs_t, vars_t) = files
    kw = {"linear": CFG, "bin_class": P_CFG, "robust": H_CFG}[model]
    args = ["--device", "cpu", "--model", model, "--bed-file", bed,
            "--bim-file", bim, "--phen-files", ",".join(phens), "--N", str(n),
            "--Mt", str(m), "--iterations", str(n_it), "--rho",
            str(kw["rho"]), "--seed", str(kw["seed"]),
            "--stop-criteria-thr", "0", "--probs",
            ",".join(map(str, probs_t)), "--vars", ",".join(map(str, vars_t)),
            "--verbosity", "0", "--out-dir", out, "--out-name", name]
    if model == "bin_class":
        args += ["--probit-var", str(kw["probit_var"]), "--cov-file", cov,
                 "--C", "2"]
    return args + list(extra)


def test_cli_linear_dumps_histories_and_pvals(tmp_path):
    """--phen-files a,b,c with --store-pvals 1 and a .bim: each trait's
    dumps equal a library run on a container loaded the same way, its
    scalar histories are that run's, and its LOO / LOCO p-values and LOCO
    predictors are written under _phen{t}, the p-values matching JAX's
    _store_pvals_multi on the same z1 and x1 (f32 both sides)."""
    files = _files(tmp_path, "linear")
    bed, phens, bim, _, n, m, (probs_t, vars_t) = files
    out = str(tmp_path / "out")
    n_it = 3
    _, state, _ = tcli.main(_args("linear", files, n_it, out, "run",
                                  ["--store-pvals", "1"]))
    pre = os.path.join(out, "run")
    g = TGenoBed.from_files(bed, phens[0], N=n, Mt=m, device="cpu")
    ys = tcli._read_phens(tcli.Options.from_args(
        _args("linear", files, n_it, out, "x")[2:]))
    cfg = tlinear.VampConfig(max_iter=n_it, rho=CFG["rho"], seed=CFG["seed"],
                             stop_criteria_thr=0.0)
    x_lib, s_lib, h_lib = tmulti.infer(tmulti.MultiPhen.build(g, ys), cfg,
                                       probs_t, vars_t, verbose=False)
    assert torch.equal(state.x1, s_lib.x1)
    for t in range(T):
        for it in range(1, n_it + 1):
            dump = vecio.read_bin_shard(f"{pre}_phen{t}_it_{it}.bin", m, 0)
            assert dump.shape == (m,) and np.isfinite(dump).all()
        np.testing.assert_array_equal(dump, s_lib.x1[:m, t].numpy()
                                      / np.sqrt(n))
        np.testing.assert_allclose(dump, x_lib[:, t], rtol=2.0 ** -23)
        # the histories are the library run's, as write_txt prints them
        want = {"gam1s": [h["gam1"][t] for h in h_lib],
                "gam2s": [h["gam2"][t] for h in h_lib],
                "R2trains": [v for h in h_lib for v in
                             (h["R2_train_1"][t], h["R2_train_2"][t])]}
        for name, vals in want.items():
            tvecio.write_txt(str(tmp_path / "want.csv"), np.array(vals))
            with open(f"{pre}_phen{t}_{name}.csv") as a, \
                    open(tmp_path / "want.csv") as b:
                assert a.read() == b.read(), name
        for ch in range(1, 5):
            pred = np.loadtxt(f"{pre}_phen{t}_LOCO_chr_{ch}.csv")
            assert pred.shape[0] >= n and np.isfinite(pred).all()
    assert not os.path.exists(f"{pre}_pvals.bin")
    assert not os.path.exists(f"{pre}_LOCO_chr_1.csv")

    jg = JGenoBed.from_files(bed, phens[0], N=n, Mt=m, dtype=jnp.float32,
                             backend="pallas", bim_path=bim)
    jopt = types.SimpleNamespace(model="linear", bim_file=bim,
                                 out_prefix=str(tmp_path / "jax"))
    jcli._store_pvals_multi(jopt, jg, ys, types.SimpleNamespace(
        z1=jnp.asarray(state.z1.numpy()), x1=jnp.asarray(state.x1.numpy())))
    for t in range(T):
        for suffix in ("_pvals.bin", "_pvals_LOCO.bin"):
            got = vecio.read_bin_shard(f"{pre}_phen{t}{suffix}", m, 0)
            want = vecio.read_bin_shard(f"{jopt.out_prefix}_phen{t}{suffix}",
                                        m, 0)
            assert np.all((got > 0) & (got <= 1)), suffix
            lg, lw = np.log10(got), np.log10(want)
            assert np.all(np.abs(lg - lw)
                          <= CLI_LOG10P_TOL * np.maximum(1, -lw)), (t, suffix)


@pytest.mark.parametrize("model", ["linear", "bin_class", "robust"])
def test_cli_resume_equals_uninterrupted(model, tmp_path):
    """infere with --checkpoint for 3 iterations, then restart --resume for
    3 more: every trait's iteration-6 dump equals that of a 6-iteration run
    bit for bit; the checkpoints carry T and the config, and the resumed
    run writes its own at iteration 6."""
    files = _files(tmp_path, model)
    m = files[5]
    out = str(tmp_path / "out")
    ck, ck2 = str(tmp_path / "ck.npz"), str(tmp_path / "ck2.npz")
    tcli.main(["--run-mode", "infere"] + _args(model, files, 6, out, "full"))
    tcli.main(["--run-mode", "infere", "--checkpoint", ck]
              + _args(model, files, 3, out, "part"))
    meta = tckpt.read_meta(ck)
    assert (meta["it"], meta["T"], meta["model"]) == (3, len(files[1]), model)
    assert meta["cfg"]["max_iter"] == 3
    assert meta["gen_fields"] == (["gen"] if model == "robust" else [])
    tcli.main(["--run-mode", "restart", "--resume", ck, "--checkpoint", ck2]
              + _args(model, files, 3, out, "part"))
    tag = tcli._TAGS[model]
    for t in range(len(files[1])):
        full = vecio.read_bin_shard(f"{out}/full_phen{t}{tag}_it_6.bin", m, 0)
        part = vecio.read_bin_shard(f"{out}/part_phen{t}{tag}_it_6.bin", m, 0)
        assert np.isfinite(full).all()
        np.testing.assert_array_equal(part, full)
    meta2 = tckpt.read_meta(ck2)
    assert (meta2["it"], meta2["cfg"]["max_iter"]) == (6, 6)


# A JAX checkpoint at iteration 3, resumed by JAX and by the port for 3
# more, f64, JAX's probe on both sides: the limits of the f64 recipes
@pytest.mark.parametrize("model", ["linear", "bin_class"])
def test_jax_multi_checkpoint_resumed_by_port(model, tmp_path):
    dt = torch.float64
    if model == "linear":
        codes, ys, _, priors = problem(0.01)
        prior, covs, kw, std = priors[0], None, CFG, True
        jcfg_cls, tcfg_cls = jlinear.VampConfig, tlinear.VampConfig
        jrun, trun = jmulti.infer, tmulti.infer
        jstate_cls, tstate_cls = jmulti.MultiState, tmulti.MultiState
    else:
        pp = probit_problem()
        codes, ys, prior, covs, kw, std = (pp["codes"], pp["ys"],
                                           pp["prior"], pp["covs"], P_CFG,
                                           False)
        jcfg_cls, tcfg_cls = jprobit.ProbitConfig, tprobit.ProbitConfig
        jrun, trun = jmulti.infer_probit, tmulti.infer_probit
        jstate_cls, tstate_cls = (jmulti.ProbitMultiState,
                                  tmulti.ProbitMultiState)
    j = jax_geno(codes, dt, covs=covs)
    jmp = jmulti.MultiPhen.build(j, ys, standardize=std)
    path = str(tmp_path / "j.npz")
    cfg3 = jcfg_cls(max_iter=3, **kw)

    def ck(it, state, m, g):
        jckpt.save_state(path, state, it=it, model=model, T=len(ys),
                         cfg=dataclasses.asdict(cfg3))

    jrun(jmp, cfg3, *prior, verbose=False, callbacks=[ck])
    js, _ = jckpt.load_state(path, jstate_cls)
    x_j, _, h_j = jrun(jmp, jcfg_cls(max_iter=6, **kw), *prior,
                       verbose=False, resume_state=js)
    ts, meta = tckpt.load_state(path, tstate_cls, device="cpu", dtype=dt)
    assert ts.it == 3 and meta["T"] == len(ys)
    assert ts.stopped.dtype == torch.bool
    tmp = tmulti.MultiPhen.build(port_geno(codes, dt, covs=covs), ys,
                                 standardize=std)
    bern = np.asarray(jlinear.make_bern_probe(j, kw["seed"], 1))
    x_t, _, h_t = trun(tmp, tcfg_cls(max_iter=6, **kw), *prior,
                       verbose=False, resume_state=ts, bern=bern)
    assert len(h_t) == len(h_j) == 3
    for a, b in zip(h_t, h_j):
        np.testing.assert_array_equal(a["cg_iters"], np.asarray(b["cg_iters"]))
    assert rel(x_t, x_j) < 1e-8


def test_jax_multi_huber_checkpoint_raises(tmp_path):
    """A JAX multi-trait Huber checkpoint holds a threefry key, which a
    torch generator cannot continue: load_state and the CLI's resume raise
    ValueError, as for the single-trait one."""
    hp = huber_problem()
    j = jax_geno(hp["codes"], torch.float64, n=H_N)
    jmp = jmulti.MultiPhen.build(j, hp["ys"])
    cfg = jrobust.RobustConfig(max_iter=1, **H_CFG)
    _, js, _ = jmulti.infer_huber(jmp, cfg, *hp["prior"], verbose=False)
    path = str(tmp_path / "h.npz")
    jckpt.save_state(path, js, it=1, model="robust", T=len(hp["ys"]),
                     cfg=dataclasses.asdict(cfg))
    with pytest.raises(ValueError, match="threefry key"):
        tckpt.load_state(path, tmulti.HuberMultiState, device="cpu")
    files = _files(tmp_path, "robust")
    with pytest.raises(ValueError, match="threefry key"):
        tcli.main(["--run-mode", "restart", "--resume", path]
                  + _args("robust", files, 1, str(tmp_path / "out"), "x"))


def test_missing_warm_start_fields_zero_filled_as_jax(tmp_path):
    """A multi-trait checkpoint without the warm-start fields loads with
    the zeros and shapes the JAX package's load_state gives them: mu_probe
    with T*P columns (P = 0 under SLQ), gmu with T + T*P, tau_gmu [T]."""
    codes, ys, _, priors = problem(0.0)
    cfg = jlinear.VampConfig(max_iter=2, **CFG)
    _, js, _ = jmulti.infer(jmulti.MultiPhen.build(
        jax_geno(codes, torch.float64), ys), cfg, *priors[0], verbose=False)
    full, old = str(tmp_path / "full.npz"), str(tmp_path / "old.npz")
    jckpt.save_state(full, js, it=2, model="linear", T=T,
                     cfg=dataclasses.asdict(cfg))
    drop = {"gmu", "mu_cg", "mu_probe", "tau_gmu", "mu_prevb", "gmu_prev"}
    with np.load(full) as z:
        arrs = {k: z[k] for k in z.files if k[2:] not in drop}
    meta = tckpt.read_meta(full)
    meta["fields"] = [f for f in meta["fields"] if f not in drop]
    arrs["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(old, **arrs)
    want, _ = jckpt.load_state(old, jmulti.MultiState)
    got, _ = tckpt.load_state(old, tmulti.MultiState, device="cpu")
    for f in drop:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype and not g.any(), f
    assert got.mu_probe.shape == (js.x1.shape[0], 0)
    assert got.tau_gmu.shape == (T,)
    np.testing.assert_array_equal(got.x1.numpy(), np.asarray(want.x1))


def test_cli_multi_refusals(tmp_path):
    """What several --phen-files still refuse: --use-XXT-denoiser (no dual
    multi-trait engine, as in the JAX CLI) and a resume with another trait
    count than the checkpoint's.  --store-pip and --sync-every, refused
    until they were ported, run: one pip file per trait, and the chunked
    run's last dump equal to the single-step run's."""
    files = _files(tmp_path, "linear")
    out = str(tmp_path / "out")
    with pytest.raises(SystemExit, match="--use-XXT-denoiser"):
        tcli.main(["--run-mode", "infere"]
                  + _args("linear", files, 2, out, "x",
                          ["--use-XXT-denoiser", "1"]))
    for name, extra in (("one", []),
                        ("two", ["--sync-every", "2", "--store-pip", "1"])):
        tcli.main(["--run-mode", "infere"]
                  + _args("linear", files, 3, out, name, extra))
    m = files[5]
    for t in range(T):
        a = vecio.read_bin_shard(f"{out}/two_phen{t}_it_3.bin", m, 0)
        b = vecio.read_bin_shard(f"{out}/one_phen{t}_it_3.bin", m, 0)
        np.testing.assert_array_equal(a, b)
        p = vecio.read_bin_shard(f"{out}/two_phen{t}_pip.bin", m, 0)
        assert np.all((p >= 0) & (p <= 1))
    ck = str(tmp_path / "ck.npz")
    tcli.main(["--run-mode", "infere", "--checkpoint", ck]
              + _args("linear", files, 1, out, "x"))
    two = _args("linear", files, 1, out, "x")
    two[two.index("--phen-files") + 1] = ",".join(files[1][:2])
    with pytest.raises(SystemExit, match="holds 3 traits"):
        tcli.main(["--run-mode", "restart", "--resume", ck] + two)
