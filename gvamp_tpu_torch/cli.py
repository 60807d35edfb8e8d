"""Run-mode entry point of the PyTorch port: ``python -m gvamp_tpu_torch.cli``.

The flags are those of the JAX package's CLI (parsed by the port's copy of
its ``Options``), plus ``--device`` (default ``cuda``) for the port.  It
runs every run mode of the JAX CLI (``gvamp_tpu/cli.py``) on one device or
on a marker mesh:

  infere          fit the model, dump per iteration
  restart         continue a checkpoint (``--resume``) or start from an
                  estimate file with gam1 and gamw injected
  test            R2 (bin_class: TPR / FPR / accuracy) sweep of a stored
                  estimate series over a test set
  both            infere, then score the estimate on the test set
  pvals-calc      LOO / LOCO p-values of a stored series, one forward
                  product and one moments pass for the whole series
  predict         predictions of a Gibbs-named series: one matrix CSV or
                  one file per individual (``--predict-format``)
  predict_single  one estimate's prediction CSV
  sim             simulate a truth and a phenotype, then infer

for one phenotype or, with several comma-separated ``--phen-files``, for
T phenotypes in one joint run of the multi-trait engines
(``gvamp_tpu_torch.multi``), whose series ``test``, ``both`` and
``pvals-calc`` score trait by trait.  ``--type-data meth`` reads a dense
raw-double matrix (``data.GenoDense``) for every mode but the predict
ones, which read .bed genotypes in the JAX CLI whatever --type-data says.
``--model linear`` writes the reference-layout dumps per iteration:

  {out}_it_{i}.bin  {out}_r1_it_{i}.bin  {out}_r2_it_{i}.bin
  {out}_it_{i}_x2_hat.bin  {out}_z1_it_{i}.csv

plus the ``_gam1s`` / ``_gam2s`` / ``_R2trains`` histories at the end.
``--model bin_class`` (probit regression on a case/control phenotype,
which is not standardised, with ``--cov-file`` / ``--C`` fixed covariates
and ``--probit-var``) and ``--model robust`` (Huber-loss regression for
heavy-tailed noise) write

  {out}{tag}_it_{i}.bin  {out}{tag}_r1_it_{i}.bin
  {out}{tag}_z1_it_{i}.csv  {out}{tag}_p1_it_{i}.csv

with ``tag`` ``_probit`` or ``_robust``.  ``--checkpoint PATH`` writes the
full engine state and its config at every dump.
A multi-trait run writes each trait's estimate as
``{out}_phen{t}{tag}_it_{i}.bin``, a linear one the ``_phen{t}_gam1s`` /
``_gam2s`` / ``_R2trains`` histories, and ``--checkpoint`` the joint state
at every iteration with the trait count ``T`` in its metadata;
``--use-XXT-denoiser``, ``--use-lmmse-damp``, ``--use-cross-val``,
``--use-freeze``, ``--init-est`` and ``--phase-timers`` are refused there,
as the JAX CLI refuses them.  ``--use-slq 0`` takes the Onsager traces
from probe columns riding the block CG, ``--red 1`` (``--model linear``,
one phenotype) solves on a moving 10% window of the samples,
``--use-cross-val 1`` holds out the last 2% of the samples to tune the
damping on their R2, ``--state-evo 1`` prints the state-evolution
prediction beside each iteration's measured alpha1, eta1 and gam2,
``--sync-every K`` fetches the metrics (and runs the dumps and the
stopping test) once per K iterations, ``--phase-timers 1`` prints each
phase's wall clock per iteration, ``--store-pip 1`` writes the final
posterior inclusion probabilities ``{out}{tag}_pip.bin`` (per trait
``{out}_phen{t}{tag}_pip.bin``), and ``--profile-dir DIR`` writes a
``torch.profiler`` Chrome trace of the run mode, ``DIR/trace.json``, with
the program's spans (``gvamp_tpu_torch.trace``) on a row of their own, and
prints one line per span name.
With ``--store-pvals`` 1 or 2 a linear run then writes the LOO p-values
``{out}_pvals.bin`` and, when a ``--bim-file`` is given, the LOCO
p-values ``{out}_pvals_LOCO.bin`` and each chromosome's genetic predictor
``{out}_LOCO_chr_{ch}.csv`` (``cli.py:176-177, 373-392`` of the JAX
package, whose semantics are kept: at the default 0 no p-values are
computed); a multi-trait linear run writes them per trait under
``{out}_phen{t}``.  Genotypes with missing calls run through the general
kernels; ``--use-XXT-denoiser 1`` runs the dual (N-space) LMMSE solve
through the fused dual Gram kernels; ``--deflate-k K`` preconditions the
primal solves with the top K eigenpairs of A^T A.  On dense data the
options that need the packed operator raise ``NotImplementedError`` naming
the option, where the JAX package fails.

The marker mesh (``gvamp_tpu_torch.dist``): ``--devices K`` splits the
packed matrix into K marker shards (0, the default, means one per visible
card on CUDA and 1 on the CPU; on the CPU every shard sits on the one CPU
device, on CUDA they go round-robin over the visible cards).
``--distributed 1`` with ``--coordinator HOST:PORT``, ``--n-processes``
and ``--process-id`` (or the ``GVAMP_*`` / ``torch.distributed``
variables) first joins a process group, ``nccl`` on CUDA and ``gloo`` on
the CPU; each process then owns ``--devices`` shards (default 1), reads
only their byte ranges of the .bed, and runs the engines on replicated
marker vectors.  Only the first process writes files and logs; every
process checks at the end of an inference that all hold the same state,
and a barrier ends the run.

Example::

    python -m gvamp_tpu_torch.cli --device cuda --run-mode infere \\
        --model linear --bed-file demo.bed --phen-files demo.phen \\
        --bim-file demo.bim --N 800 --Mt 240 --iterations 8 \\
        --probs 0.95,0.05 --vars 0.0,0.0667 --store-pvals 1 \\
        --out-dir out --out-name demo
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys

import numpy as np
import torch

from gvamp_tpu_torch import dist, linear, multi, probit, robust, sim, trace
from gvamp_tpu_torch.ckpt import (load_state, read_meta, save_state,
                                  write_scalar_history)
from gvamp_tpu_torch.data import GenoBed, GenoDense
from gvamp_tpu_torch.io import plink, vecio
from gvamp_tpu_torch.ops import pvals
from gvamp_tpu_torch.ops.special import normal_cdf
from gvamp_tpu_torch.options import Options
from gvamp_tpu_torch.prior import Prior, initialize_prior, pip


def _check_slice(opt: Options) -> None:
    """Raise on the flags the port does not run."""
    if opt.backend != "auto":
        raise ValueError("--backend picks a JAX backend; the port routes by "
                         "--dtype (float32: CUDA kernels, float64: CPU)")
    if opt.type_data == "meth" and opt.run_mode in ("predict",
                                                    "predict_single"):
        # gvamp_tpu/cli.py:765-770 reads --bed-file-test as packed .bed
        # genotypes whatever --type-data says
        raise NotImplementedError(
            f"--run-mode {opt.run_mode} with --type-data meth: the JAX "
            f"package's predict modes read --bed-file-test as a .bed file "
            f"whatever --type-data says; the port refuses rather than read "
            f"a .meth file as packed genotypes")


_TAGS = {"linear": "", "bin_class": "_probit", "robust": "_robust"}


# the run's files: written by the first process only, the others holding
# the same replicated values (gvamp_tpu/cli.py gates them on dist.is_main)

def _write_bin(path: str, x, offset: int) -> None:
    if dist.is_main():
        vecio.write_bin_shard(path, x, offset)


def _write_txt(path: str, x) -> None:
    if dist.is_main():
        vecio.write_txt(path, x)


def _save_state(path: str, state, **extra) -> None:
    if dist.is_main():
        save_state(path, state, **extra)


def _write_history(prefix: str, hist) -> None:
    if dist.is_main():
        write_scalar_history(prefix, hist)


def _mesh(opt: Options, device):
    """The run's marker mesh, or None for one device: ``--devices`` shards
    per process under ``--distributed`` (default 1), else ``--devices``
    shards in this process (0: one per visible card on CUDA, 1 on the
    CPU)."""
    device = torch.device(device)
    if opt.distributed:
        return dist.Mesh(opt.devices or 1, device)
    n = opt.devices
    if n == 0 and device.type == "cuda" and torch.cuda.is_available():
        n = torch.cuda.device_count()
    return dist.Mesh(n, device) if n > 1 else None


def _check_replicated(geno, state) -> None:
    """The end of an inference over several processes: one collective
    check that every process holds the same state."""
    mesh = geno.mesh
    if mesh is None or not mesh.distributed:
        return
    n = mesh.assert_replicated(*[v for v in state
                                 if isinstance(v, torch.Tensor)])
    if dist.is_main():
        print(f"replicated: {n} state tensors agree over {mesh.world} "
              f"processes ({dist.backend()})", flush=True)


def _dumper(prefix: str, every: int, model: str = "linear",
            checkpoint: str = "", meta=None):
    """Per-iteration reference-layout dumps (``gvamp_tpu.ckpt.IterDumper``,
    written from one process): x1, r1, r2, x2 and the z1 CSV for the
    linear model; x1, r1 and the z1 / p1 CSVs under ``_probit`` for
    bin_class (vamp_probit.cpp:211-225) and ``_robust`` for robust
    (vamp_Huber.cpp:145-158).  With ``checkpoint`` every dump also writes
    the full state there, ``meta`` (the engine's cfg) beside it."""
    tag = _TAGS[model]
    meta = dict(meta or {})

    def planar_csv(path, vec, geno):
        # over the padded 4*mbytes width, original order
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = geno.deplanarize(vec)[: geno.N]
        _write_txt(path, full)

    def cb(it, state, metrics, geno):
        if every == 0 or it % every:
            return
        scale = 1.0 / np.sqrt(geno.N)
        vecs = [(f"{tag}_it_{it}.bin", state.x1),
                (f"{tag}_r1_it_{it}.bin", state.r1)]
        if model == "linear":
            vecs += [(f"_r2_it_{it}.bin", state.r2),
                     (f"_it_{it}_x2_hat.bin", state.x2)]
        for name, vec in vecs:
            _write_bin(prefix + name, vec[: geno.M].cpu().numpy() * scale,
                       geno.S)
        for nm in ("z1",) if model == "linear" else ("z1", "p1"):
            planar_csv(f"{prefix}{tag}_{nm}_it_{it}.csv", getattr(state, nm),
                       geno)
        if checkpoint:
            _save_state(checkpoint, state, it=it, model=model, **meta)

    return cb


def _common_cfg(opt: Options, gam1, default_gam1: float) -> dict:
    """Engine-config fields shared by the model families
    (``gvamp_tpu.cli._common_cfg``); ``gam1`` (a restart's
    ``--gam1-init``) replaces ``default_gam1`` unless None."""
    return dict(
        max_iter=opt.iterations, rho=opt.rho,
        stop_criteria_thr=opt.stop_criteria_thr, em_max_iter=opt.EM_max_iter,
        em_err_thr=opt.EM_err_thr, cg_max_iter=opt.CG_max_iter,
        learn_vars=bool(opt.learn_vars), seed=opt.seed,
        deflate_k=opt.deflate_k, deflate_iters=opt.deflate_iters,
        cg_plateau=opt.cg_plateau, use_slq=bool(opt.use_slq),
        slq_k=opt.slq_k, stab_gamma=opt.stab_gamma,
        gam1_init=default_gam1 if gam1 is None else gam1)


def run_inference(opt: Options, geno: GenoBed, gam1=None, gamw=None,
                  r1_init=None):
    """The branches of ``gvamp_tpu.cli.run_inference``; ``gam1``, ``gamw``
    and ``r1_init`` are a restart's injected values (r1 and gamw for the
    single-trait linear model only, as in the JAX CLI)."""
    probs, vars_user = initialize_prior(opt.probs or None, opt.vars or None,
                                        N=geno.N, Mt=geno.Mt)
    if len(opt.phen_files) > 1:
        return _run_multi(opt, geno, probs, vars_user, gam1, gamw)
    ts = (vecio.read_estimate(opt.true_signal_files[0], geno.M, geno.S)
          if opt.true_signal_files else None)

    def dumper(cfg):
        return _dumper(opt.out_prefix, opt.dump_every, opt.model,
                       opt.checkpoint, {"cfg": dataclasses.asdict(cfg)})

    common = dict(true_signal=ts, sync_every=opt.sync_every,
                  phase_timers=bool(opt.phase_timers),
                  verbose=opt.verbosity > 0)
    if opt.model in ("bin_class", "robust"):
        if opt.model == "bin_class":
            cfg = probit.ProbitConfig(probit_var=opt.probit_var,
                                      **_common_cfg(opt, gam1, 1e-8))
        else:
            cfg = robust.RobustConfig(**_common_cfg(opt, gam1, 1e-8))
        res = _ENGINES[opt.model][0].infer(geno, cfg, probs, vars_user,
                                           callbacks=[dumper(cfg)], **common)
        _check_replicated(geno, res[1])
        if opt.store_pip:
            _store_pip(opt, geno, res[1], _TAGS[opt.model])
        return res
    freeze = (vecio.read_estimate(opt.freeze_index_file, geno.M, geno.S)
              if opt.use_freeze else None)
    x1_init = (vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
               if opt.init_est and opt.estimate_file else None)
    cfg = linear.VampConfig(
        **_common_cfg(opt, gam1, 1e-6),
        gamw_init=opt.gamw_default() if gamw is None else gamw,
        use_lmmse_damp=bool(opt.use_lmmse_damp),
        use_xxt=bool(opt.use_XXT_denoiser), gamma_damp=opt.gamma_damp,
        red=bool(opt.red), use_cross_val=bool(opt.use_cross_val),
        cg_extrapolate=opt.cg_extrapolate != 0)
    x_est, state, hist = linear.infer(
        geno, cfg, probs, vars_user, freeze=freeze, r1_init=r1_init,
        x1_init=x1_init, callbacks=[dumper(cfg)], **common)
    _check_replicated(geno, state)
    if hist:
        _write_history(opt.out_prefix, hist)
    if opt.state_evo and hist:
        _print_state_evolution(geno, hist, opt.seed)
    # the JAX CLI's test (cli.py:176): the default 0 computes no p-values
    if opt.store_pvals:
        _store_pvals_after_infer(opt, geno, state)
    if opt.store_pip:
        _store_pip(opt, geno, state)
    return x_est, state, hist


def _print_state_evolution(geno, hist, seed: int) -> None:
    """--state-evo (``gvamp_tpu/cli.py:332-353``): per iteration, the
    state-evolution prediction of (alpha1, eta1, gam2) from the prior,
    gam1 and rho in the metrics history beside the measured values, the
    live version of the reference's dormant state_evo (vamp.cpp:1376-1411);
    no pass over the genotypes.  The draws come from
    ``linear.state_evolution_draws``."""
    def prior(h):
        return Prior(*(torch.as_tensor(np.asarray(h[k]), dtype=geno.dtype,
                                       device=geno.device)
                       for k in ("probs", "vars")))

    print("state evolution (predicted | measured):")
    for i in range(1, len(hist)):
        m, mp = hist[i], hist[i - 1]
        a_bar, eta_bar, gam2_bar = linear.state_evolution(
            seed, i, prior(m), float(m["gam1"]), float(m["rho"]), prior(mp),
            float(mp["gam1"]), geno.Mt)
        print(f"  it {int(m['it'])}: alpha1 {float(a_bar):.6f} | "
              f"{float(m['alpha1']):.6f}   eta1 {float(eta_bar):.6g} | "
              f"{float(m['eta1']):.6g}   gam2 {float(gam2_bar):.6g} | "
              f"{float(m['gam2']):.6g}")


def _store_pip(opt: Options, geno: GenoBed, state, tag: str = "",
               T: int = 0) -> None:
    """--store-pip (``gvamp_tpu/cli.py:307-329``): each marker's posterior
    inclusion probability P(x != 0 | r1, gam1) at the final iterate, from
    the state's internal-scale r1, gam1 and prior, as
    ``{out}{tag}_pip.bin``, or per trait ``{out}_phen{t}{tag}_pip.bin``."""
    def one(r1, gam1, probs, vars_, name):
        p = pip(r1, gam1, Prior(probs=probs, vars=vars_))[: geno.M]
        _write_bin(name, p.cpu().numpy(), geno.S)
        print(f"pip -> {name}")

    if T:
        for t in range(T):
            one(state.r1[:, t], state.gam1[t], state.probs[t], state.vars[t],
                f"{opt.out_prefix}_phen{t}{tag}_pip.bin")
    else:
        one(state.r1, state.gam1, state.probs, state.vars,
            f"{opt.out_prefix}{tag}_pip.bin")


def _check_multi_flags(opt: Options) -> None:
    """The flags the multi-trait engines do not take
    (``gvamp_tpu/cli.py:247-262``): refused rather than ignored."""
    bad = [nm for nm, v in [
        ("--use-XXT-denoiser", opt.use_XXT_denoiser),
        ("--use-lmmse-damp", opt.use_lmmse_damp),
        ("--use-cross-val", opt.use_cross_val),
        ("--use-freeze", opt.use_freeze),
        ("--init-est", opt.init_est),
        ("--phase-timers", opt.phase_timers)] if v]
    if bad:
        raise SystemExit("multi-trait runs (multiple --phen-files) do not "
                         "support: " + ", ".join(bad))


def _read_phens(opt: Options) -> list:
    """Each --phen-files phenotype, NA as NaN."""
    ys = []
    for pf in opt.phen_files:
        y, isna = plink.read_phen(pf)
        ys.append(np.where(isna, np.nan, y))
    return ys


# model -> (engine entry, config, state class) of the multi-trait engines
_MULTI = {"linear": (multi.infer, linear.VampConfig, multi.MultiState),
          "bin_class": (multi.infer_probit, probit.ProbitConfig,
                        multi.ProbitMultiState),
          "robust": (multi.infer_huber, robust.RobustConfig,
                     multi.HuberMultiState)}


def _multi_cfg(opt: Options, gam1, gamw):
    """The engine config of a multi-trait run (``gvamp_tpu/cli.py:121-232``):
    the linear one takes --gamma-damp and --cg-extrapolate besides the
    common fields, the probit one --probit-var."""
    if opt.model == "bin_class":
        return probit.ProbitConfig(probit_var=opt.probit_var,
                                   **_common_cfg(opt, gam1, 1e-8))
    if opt.model == "robust":
        return robust.RobustConfig(**_common_cfg(opt, gam1, 1e-8))
    return linear.VampConfig(
        **_common_cfg(opt, gam1, 1e-6), gamma_damp=opt.gamma_damp,
        gamw_init=opt.gamw_default() if gamw is None else gamw,
        cg_extrapolate=opt.cg_extrapolate != 0)


def _run_multi(opt: Options, geno: GenoBed, probs, vars_user, gam1=None,
               gamw=None, resume=None, cfg=None):
    """One joint run of every --phen-files trait: a fresh one, or the
    continuation of ``resume`` (a multi-trait state) under ``cfg``.  Binary
    traits stay unstandardised.  A linear run writes the per-trait scalar
    histories and, with --store-pvals, each trait's p-values."""
    _check_multi_flags(opt)
    ys = _read_phens(opt)
    mp = multi.MultiPhen.build(geno, ys, standardize=opt.model != "bin_class")
    run = _MULTI[opt.model][0]
    if cfg is None:
        cfg = _multi_cfg(opt, gam1, gamw)
    x_est, state, hist = run(
        mp, cfg, probs, vars_user, resume_state=resume,
        verbose=opt.verbosity > 0, sync_every=opt.sync_every,
        callbacks=[_multi_dump_cb(opt, mp, cfg, _TAGS[opt.model])])
    _check_replicated(geno, state)
    if opt.model == "linear":
        if hist:
            _write_multi_scalar_history(opt.out_prefix, hist, mp.T)
        if opt.store_pvals and resume is None:
            _store_pvals_multi(opt, geno, ys, state)
    if opt.store_pip and resume is None:
        _store_pip(opt, geno, state, _TAGS[opt.model], T=mp.T)
    return x_est, state, hist


def _multi_dump_cb(opt: Options, mp, cfg, tag: str = ""):
    """Per-iteration callback of the multi-trait engines
    (``gvamp_tpu/cli.py:265-289``): each trait's estimate as
    ``{out}_phen{t}{tag}_it_{it}.bin`` at the dumps, and with --checkpoint
    the joint state at every iteration, its metadata holding the trait
    count ``T`` and the engine config."""

    def cb(it, state, metrics, g):
        if opt.dump_every and it % opt.dump_every == 0:
            x = state.x1[: g.M].cpu().numpy() / np.sqrt(g.N)
            for t in range(mp.T):
                _write_bin(
                    f"{opt.out_prefix}_phen{t}{tag}_it_{it}.bin", x[:, t],
                    g.S)
        if opt.checkpoint:
            _save_state(opt.checkpoint, state, it=it, model=opt.model,
                       T=mp.T, cfg=dataclasses.asdict(cfg))

    return cb


def _write_multi_scalar_history(prefix: str, hist, T: int) -> None:
    """Per-trait gam1s / gam2s / R2trains CSVs under ``{prefix}_phen{t}``
    (vamp.cpp:778-794 per trait)."""
    keys = ("gam1", "gam2", "R2_train_1", "R2_train_2")
    for t in range(T):
        _write_history(f"{prefix}_phen{t}", [
            {k: np.asarray(h[k])[t] for k in keys if k in h} for h in hist])


def _store_pvals_multi(opt: Options, geno: GenoBed, ys, state) -> None:
    """Each trait's end-of-run LOO (+ LOCO with a .bim) p-values
    (``gvamp_tpu/cli.py:356-371``): the container takes the trait's
    phenotype, then the single-trait p-value functions run on its z1 and
    x1 columns."""
    for t in range(len(ys)):
        geno.set_phen(ys[t], standardize=opt.model != "bin_class")
        z1_t = state.z1[..., t].contiguous()
        x1_t = state.x1[:, t].contiguous()
        name = f"{opt.out_prefix}_phen{t}_pvals"
        _write_bin(name + ".bin", pvals.loo_pvals(geno, z1_t, x1_t), geno.S)
        print(f"pvals -> {name}.bin")
        if opt.bim_file:
            ploco = pvals.loco_pvals(
                geno, z1_t, x1_t, geno.chromosomes(),
                predictor_cb=_loco_predictor_writer(opt, geno, f"_phen{t}"))
            _write_bin(name + "_LOCO.bin", ploco, geno.S)


def mode_restart(opt: Options, device):
    """``--run-mode restart`` (``gvamp_tpu/cli.py:405-411``): continue a
    full-state checkpoint (``--resume``), or start from an estimate file
    with gam1 and gamw injected (main_real.cpp:453-486)."""
    if opt.resume:
        return _resume_run(opt, device)
    geno = _load_geno(opt, device)
    r1 = vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
    return run_inference(opt, geno, gam1=opt.gam1_init, gamw=opt.gamw_init,
                         r1_init=r1)


_ENGINES = {"linear": (linear, linear.VampConfig, linear.LinState),
            "bin_class": (probit, probit.ProbitConfig, probit.ProbitState),
            "robust": (robust, robust.RobustConfig, robust.RobustState)}


def _resume_run(opt: Options, device):
    """Full-state resume from an .npz checkpoint (``gvamp_tpu/cli.py:
    462-520``): the model and its whole config come back from the
    checkpoint's metadata, and the run continues from the checkpoint's
    iteration for ``--iterations`` more."""
    meta = read_meta(opt.resume)
    model = meta.get("model", "linear")
    if model != opt.model:
        raise SystemExit(
            f"FATAL  : checkpoint {opt.resume} was written by --model {model};"
            f" pass the same --model to resume (got {opt.model})")
    if int(meta.get("T", 1)) > 1:
        return _resume_multi(opt, device, meta)
    geno = _load_geno(opt, device)
    eng, cfg_cls, state_cls = _ENGINES[model]
    state, _ = load_state(opt.resume, state_cls, device=geno.device,
                          dtype=geno.dtype, mpad=geno.Mpad)
    cfg_d = dict(meta.get("cfg", {}))
    if cfg_d:
        # a run from before the SLQ traces carries probe columns, and one
        # from before the secant warm start ran without it: the resume
        # keeps the original configuration (gvamp_tpu/cli.py:479-489)
        cfg_d.setdefault("use_slq", False)
        cfg_d.setdefault("cg_extrapolate", False)
    cfg_d["max_iter"] = int(meta.get("it", 0)) + opt.iterations
    if model == "linear" and not cfg_d.keys() - {"max_iter"}:
        cfg = cfg_cls(max_iter=cfg_d["max_iter"], rho=opt.rho,
                      cg_max_iter=opt.CG_max_iter, seed=opt.seed)
    else:
        cfg = cfg_cls(**cfg_d)
    probs, vars_user = initialize_prior(opt.probs or None, opt.vars or None,
                                        N=geno.N, Mt=geno.Mt)
    dump = _dumper(opt.out_prefix, opt.dump_every, model, opt.checkpoint,
                   {"cfg": dataclasses.asdict(cfg)})
    x_est, state, hist = eng.infer(
        geno, cfg, probs, vars_user, resume_state=state, callbacks=[dump],
        verbose=opt.verbosity > 0, sync_every=opt.sync_every,
        phase_timers=bool(opt.phase_timers))
    _check_replicated(geno, state)
    if hist:
        _write_history(opt.out_prefix, hist)
    return x_est, state, hist


def _resume_multi(opt: Options, device, meta: dict):
    """Continue a multi-trait checkpoint (``gvamp_tpu/cli.py:414-459``):
    the same --phen-files set builds the traits again, and the joint run
    goes on under the checkpoint's config for --iterations more."""
    T = int(meta["T"])
    if len(opt.phen_files) != T:
        raise SystemExit(
            f"FATAL  : checkpoint {opt.resume} holds {T} traits; pass the "
            f"same {T} --phen-files to resume (got {len(opt.phen_files)})")
    geno = _load_geno(opt, device)
    _, cfg_cls, state_cls = _MULTI[opt.model]
    state, _ = load_state(opt.resume, state_cls, device=geno.device,
                          dtype=geno.dtype, mpad=geno.Mpad)
    cfg_d = dict(meta.get("cfg", {}))
    cfg_d.setdefault("use_slq", False)
    cfg_d.setdefault("cg_extrapolate", False)
    # --iterations more from the state's own counter
    cfg = dataclasses.replace(cfg_cls(**cfg_d),
                              max_iter=state.it + opt.iterations)
    probs, vars_user = initialize_prior(opt.probs or None, opt.vars or None,
                                        N=geno.N, Mt=geno.Mt)
    return _run_multi(opt, geno, probs, vars_user, resume=state, cfg=cfg)


def _store_pvals_after_infer(opt: Options, geno: GenoBed, state) -> None:
    """End-of-run LOO (+ LOCO with a .bim) p-values (vamp.cpp:761-776)."""
    p = pvals.loo_pvals(geno, state.z1, state.x1)
    _write_bin(opt.out_prefix + "_pvals.bin", p, geno.S)
    print(f"pvals -> {opt.out_prefix}_pvals.bin")
    if opt.bim_file:
        ploco = pvals.loco_pvals(
            geno, state.z1, state.x1, geno.chromosomes(),
            predictor_cb=_loco_predictor_writer(opt, geno))
        _write_bin(opt.out_prefix + "_pvals_LOCO.bin", ploco, geno.S)
        print(f"LOCO pvals -> {opt.out_prefix}_pvals_LOCO.bin")


def _loco_predictor_writer(opt: Options, geno: GenoBed, tag: str = ""):
    """predictor_cb writing each chromosome's predictor as
    ``{out}{tag}_LOCO_chr_{ch}.csv`` in the original sample order (``tag``
    ``_phen{t}`` in a multi-trait run)."""
    def cb(ch, y_chrom):
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = geno.deplanarize(y_chrom)[: geno.N]
        _write_txt(f"{opt.out_prefix}{tag}_LOCO_chr_{ch}.csv", full)
    return cb


# --------------------------------------------------------------------------
# the run modes that score, test and simulate (gvamp_tpu/cli.py:526-915)
# --------------------------------------------------------------------------


def _series_paths(path: str, lo: int, hi: int) -> list:
    """Per-iteration estimate paths from one example path
    (``gvamp_tpu/cli.py:526-543``; the reference splices the iteration into
    the name, main_real.cpp:160-181): ``it_{N}.`` is parsed in the
    basename only, so a directory or stem holding "it" does not confuse
    it; a name without an iteration tag gets ``_it_{N}`` before its
    extension."""
    d, base = os.path.split(path)
    m = re.search(r"^(?P<stem>.*it_)\d+\.(?P<ext>[^.]+)$", base)
    if m:
        fmt = m.group("stem") + "{it}." + m.group("ext")
    else:
        root, ext = os.path.splitext(base)
        fmt = root + "_it_{it}" + ext
    return [os.path.join(d, fmt.format(it=it)) for it in range(lo, hi + 1)]


def _tagged(path: str, tag: str) -> str:
    """A trait tag inserted before the trailing ``_it_{N}`` (or the
    extension) of a path (``gvamp_tpu/cli.py:561-570``)."""
    if not tag:
        return path
    d, base = os.path.split(path)
    m = re.search(r"^(?P<stem>.*?)(?P<it>_(?:probit_|robust_)?it_\d+)?"
                  r"\.(?P<ext>[^.]+)$", base)
    return os.path.join(
        d, f"{m.group('stem')}{tag}{m.group('it') or ''}.{m.group('ext')}")


def _estimate_series(opt: Options, M: int, S: int, tag: str = ""):
    """Yield (it, estimate) over --test-iter-range from --estimate-file
    (``gvamp_tpu/cli.py:546-558``): the one file at range -1, else each
    iteration's; ``tag`` selects a multi-trait series (``_phen{t}``)."""
    lo, hi = opt.test_iter_range
    path = opt.estimate_file
    if lo == -1:
        yield -1, vecio.read_estimate(_tagged(path, tag), M, S)
        return
    for it, p in zip(range(lo, hi + 1), _series_paths(path, lo, hi)):
        yield it, vecio.read_estimate(_tagged(p, tag), M, S)


def _trait_tags(opt: Options, test: bool = False) -> list:
    """[("", phen)] for one trait; [("_phen0", phen0), ...] for several,
    the series tags of the multi-trait dumps (``gvamp_tpu/cli.py:573-579``)."""
    phens = (opt.phen_files_test if test else opt.phen_files) or opt.phen_files
    if len(phens) <= 1:
        return [("", phens[0] if phens else None)]
    return [(f"_phen{t}", pf) for t, pf in enumerate(phens)]


def score_bin_class(geno, z_planar, m_cov_planar):
    """(TPR, FPR, accuracy) of a probit prediction on a container
    (``gvamp_tpu/cli.py:629-646``, main_real_probit.cpp:131-157):
    classified by Phi(z + Z cov_eff) >= 0.5; the four counts reach the host
    in one transfer."""
    nm = geno.n_mask_planar > 0
    pred = (normal_cdf(z_planar + m_cov_planar) >= 0.5) & nm
    truth = (geno.filter_pheno() >= 0.5) & nm
    tp, fp, fn, tn = (int(v) for v in torch.stack([
        (pred & truth).sum(), (pred & ~truth & nm).sum(),
        (~pred & truth & nm).sum(), (~pred & ~truth & nm).sum()]).cpu())
    return tp / max(tp + fn, 1), fp / max(fp + tn, 1), (tp + tn) / geno.N


def score_series(geno, series, model: str = "linear", m_cov=None):
    """``--run-mode test``'s sweep over (it, estimate) pairs
    (``gvamp_tpu/cli.py:597-625``) on a loaded container: each estimate's
    prediction A x on the device, its R2 (linear, robust) or, for
    bin_class with the covariate term ``m_cov`` [N] (zeros when None), its
    accuracy from the confusion counts; one scalar fetch each.  Prints one
    line per estimate and the best; returns (best score, its iteration)."""
    y_pl = geno.filter_pheno()
    y = geno.deplanarize(y_pl)[: geno.N]
    best, best_it = -np.inf, -1
    sqn = np.sqrt(geno.N)
    m_cov_pl = None
    if model == "bin_class":
        m_cov_pl = geno.planarize(np.zeros(geno.N) if m_cov is None
                                  else m_cov)
    sd = np.std(y, ddof=1)
    for it, est in series:
        z = geno.ax(geno.pad_m(est * sqn))
        if model == "bin_class":
            tpr, fpr, acc = score_bin_class(geno, z, m_cov_pl)
            print(f"it {it}: TPR={tpr:.4f} FPR={fpr:.4f} acc={acc:.4f}")
            score = acc
        else:
            err2 = float(torch.square(y_pl - z).sum())
            score = 1.0 - err2 / (sd * sd * geno.N)
            print(f"it {it}: R2 = {score:.6f}")
        if score > best:
            best, best_it = score, it
    print(f"max score = {best:.6f} at it = {best_it}")
    return best, best_it


def pvals_series(geno, ests, loo: bool = True, chroms=None,
                 predictor_cb=None):
    """``--run-mode pvals-calc``'s p-values for E stored estimates
    (``gvamp_tpu/cli.py:742-762``; reference nE batch, data.cpp:1155-1183):
    one ``axm`` over the whole series and one moments pass give every
    estimate's LOO p-values; with ``chroms`` each estimate's LOCO ones,
    ``predictor_cb(e)`` giving its per-chromosome predictor callback.
    Returns (LOO float64[E, M] or None, [LOCO float64[M] per estimate] or
    None)."""
    sqn = np.sqrt(geno.N)
    x1s = torch.stack([geno.pad_m(est * sqn) for est in ests], dim=1)
    z1s = geno.axm(x1s)
    p_loo = pvals.loo_pvals_multi(geno, z1s, x1s) if loo else None
    p_loco = None
    if chroms is not None:
        p_loco = [pvals.loco_pvals(
            geno, z1s[..., e].contiguous(), x1s[:, e].contiguous(), chroms,
            predictor_cb=predictor_cb(e) if predictor_cb else None)
            for e in range(len(ests))]
    return p_loo, p_loco


def predict_series(geno, ests) -> np.ndarray:
    """Predictions A x of stored estimates on a container, one forward
    product each (``gvamp_tpu/cli.py:771-790``): float [N, E] in the
    original sample order."""
    sqn = np.sqrt(geno.N)
    return np.stack([geno.deplanarize(geno.ax(geno.pad_m(est * sqn)))[
        : geno.N] for est in ests], axis=1)


def mode_test(opt: Options, device):
    """``--run-mode test`` (``gvamp_tpu/cli.py:582-626``, main_real.cpp:
    129-244, main_real_probit.cpp:117-157): R2 or confusion sweep of the
    stored estimates over the test set; a multi-trait series trait by
    trait, each against its own --phen-files-test phenotype."""
    geno = _load_geno(opt, device, test=True)
    traits = _trait_tags(opt, test=True)
    results = []
    for tag, pf in traits:
        if len(traits) > 1:
            y_raw, isna = plink.read_phen(pf)
            geno.set_phen(np.where(isna, np.nan, y_raw),
                          standardize=opt.model != "bin_class")
            print(f"trait {tag or pf}:")
        m_cov = None
        if opt.model == "bin_class" and opt.cov_estimate_file and opt.C:
            m_cov = geno.covs_np @ vecio.read_estimate(opt.cov_estimate_file,
                                                       opt.C, 0)
        results.append(score_series(
            geno, _estimate_series(opt, geno.M, geno.S, tag=tag), opt.model,
            m_cov))
    return results if len(traits) > 1 else results[0]


def mode_both(opt: Options, device):
    """``--run-mode both`` (``gvamp_tpu/cli.py:649-724``, main_real.cpp:
    245-330): infere on the training set, then score on the test set.
    Linear and robust report R2 with the training phenotype's intercept
    and scale (recomputed per trait in a multi-trait run); bin_class the
    confusion counts with the learned covariate effects, when the test
    covariate rows match, and a warning when they do not."""
    geno = _load_geno(opt, device)
    x_est, state, _ = run_inference(opt, geno)
    x_est = np.asarray(x_est)
    traits = _trait_tags(opt, test=True)
    several = x_est.ndim == 2
    if several:
        scales = []
        for _, pf in _trait_tags(opt, test=False):
            yt, isna = plink.read_phen(pf)
            y_v = np.where(isna, np.nan, yt)
            avg = float(np.nanmean(y_v))
            scales.append((avg, float(np.sqrt(((~isna).sum() - 1)
                                              / np.nansum((y_v - avg) ** 2)))))
    else:
        scales = [(geno.intercept, geno.scale)]
    geno_t = _load_geno(opt, device, test=True)
    sqn = np.sqrt(geno_t.N)
    bin_class = opt.model == "bin_class"
    eff_all = None
    if bin_class and opt.C > 0 and getattr(state, "cov_eff", None) is not None:
        # the fixed covariate effects carry to the test set
        # (main_real_probit.cpp:241-258); [C, T] in a multi-trait run
        eff_all = state.cov_eff.cpu().numpy()[: opt.C]
    scores = []
    for t, (tag, pf) in enumerate(traits):
        if several:
            y_raw, isna = plink.read_phen(pf)
            geno_t.set_phen(np.where(isna, np.nan, y_raw),
                            standardize=not bin_class)
        est_t = x_est[:, t] if several else x_est
        z_pl = geno_t.ax(geno_t.pad_m(est_t[: geno_t.M] * sqn))
        label = tag and f" ({tag})" or ""
        if bin_class:
            m_cov = np.zeros(geno_t.N)
            if eff_all is not None:
                if (geno_t.covs is not None
                        and geno_t.covs_np.shape[0] == geno_t.N):
                    m_cov = geno_t.covs_np @ (eff_all[:, t] if eff_all.ndim
                                              == 2 else eff_all)
                else:
                    have = (geno_t.covs_np.shape[0]
                            if geno_t.covs is not None else 0)
                    print(f"WARNING: learned covariate effects NOT applied "
                          f"to test predictions — --cov-file has {have} "
                          f"rows, test set has {geno_t.N} individuals",
                          flush=True)
            tpr, fpr, acc = score_bin_class(geno_t, z_pl,
                                            geno_t.planarize(m_cov))
            print(f"test{label}: TPR={tpr:.4f} FPR={fpr:.4f} acc={acc:.4f}")
            scores.append(acc)
            continue
        intercept, scale = scales[min(t, len(scales) - 1)]
        z = intercept + scale * geno_t.deplanarize(z_pl)[: geno_t.N]
        y = geno_t.deplanarize(geno_t.filter_pheno())[: geno_t.N]
        sd = np.std(y, ddof=1)
        r2 = 1.0 - float(np.sum((y - z) ** 2)) / (sd * sd * geno_t.N)
        print(f"test R2{label} = {r2:.6f}")
        scores.append(r2)
    return scores if several else scores[0]


def mode_pvals_calc(opt: Options, device):
    """``--run-mode pvals-calc`` (``gvamp_tpu/cli.py:727-762``,
    main_real.cpp:331-452): LOO (--store-pvals 0 or 1) and, with a .bim,
    LOCO (0 or 2) p-values of the stored estimates, written as
    ``{out}{tag}_pvals.bin`` / ``_pvals_LOCO.bin`` with each estimate's
    ``_it_{N}`` tag and the LOCO predictors; a multi-trait series trait by
    trait against its own phenotype."""
    geno = _load_geno(opt, device)
    traits = _trait_tags(opt)
    for ttag, pf in traits:
        if len(traits) > 1:
            y_raw, isna = plink.read_phen(pf)
            geno.set_phen(np.where(isna, np.nan, y_raw),
                          standardize=opt.model != "bin_class")
        series = list(_estimate_series(opt, geno.M, geno.S, tag=ttag))
        tags = [ttag + (f"_it_{it}" if it != -1 else "") for it, _ in series]
        p_loo, p_loco = pvals_series(
            geno, [est for _, est in series], loo=opt.store_pvals in (0, 1),
            chroms=(geno.chromosomes() if opt.bim_file
                    and opt.store_pvals in (0, 2) else None),
            predictor_cb=lambda e: _loco_predictor_writer(opt, geno, tags[e]))
        for e, tag in enumerate(tags):
            if p_loo is not None:
                _write_bin(f"{opt.out_prefix}{tag}_pvals.bin", p_loo[e],
                           geno.S)
            if p_loco is not None:
                _write_bin(f"{opt.out_prefix}{tag}_pvals_LOCO.bin",
                           p_loco[e], geno.S)


def mode_predict(opt: Options, device, single: bool = False):
    """``--run-mode predict`` / ``predict_single`` (``gvamp_tpu/cli.py:
    765-803``, main_real.cpp:487-594) on the --bed-file-test genotypes:
    one estimate's prediction as ``{out}_predict.csv``, or over
    --test-iter-range the Gibbs-named series ``<stem>temp_<it>_<it>_gibbs_
    est.<ext>`` as one [N, iterations] ``{out}_predict_matrix.csv``
    (--predict-format matrix) or one file per individual, the reference's
    layout, with a warning above 10,000 people."""
    dtype = torch.float64 if opt.dtype == "float64" else torch.float32
    geno = GenoBed.from_files(
        opt.bed_file_test, None, N=opt.N_test, Mt=opt.Mt_test,
        alpha_scale=opt.alpha_scale, dtype=dtype,
        device=torch.device(device), standardize_phen=False,
        mesh=_mesh(opt, device))
    if single:
        est = vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = predict_series(geno, [est])[:, 0]
        _write_txt(opt.out_prefix + "_predict.csv", full)
        return
    lo, hi = opt.test_iter_range
    path = opt.estimate_file
    ext = path[path.find(".") + 1:]
    stem = path[: path.rfind("temp")]
    zs = predict_series(geno, [
        vecio.read_estimate(f"{stem}temp_{it}_{it}_gibbs_est.{ext}", geno.M,
                            geno.S) for it in range(lo, hi + 1)])
    if opt.predict_format == "matrix":
        if dist.is_main():
            np.savetxt(f"{opt.out_prefix}_predict_matrix.csv", zs,
                       delimiter=",")
        return
    if geno.N > 10000:
        print(f"WARNING: --predict-format per-individual writes {geno.N} "
              "files (reference main_real.cpp:538-545 behavior); use "
              "--predict-format matrix for one CSV", flush=True)
    for i in range(geno.N):
        _write_txt(f"{opt.out_prefix}_predict_{i}.csv", zs[i])


def mode_sim(opt: Options, device):
    """``--run-mode sim`` (``gvamp_tpu/cli.py:806-903``): simulate a truth
    and a phenotype on the .bed (or .meth) genotypes, write them
    (``{out}_beta_true.bin``, ``{out}_y.txt``), then infer with the truth's
    diagnostics.  --sim-model picks the recipe: default (sim.cpp), realistic
    (sim_realistic.cpp:88-95), heavy-tails (sim_heavy_tails.cpp:87-89) or
    probit (sim_probit.cpp:170-205, alternating +-0.25 covariate effects).
    The numpy generator is seeded by --seed, so the draws are the JAX
    CLI's; --num-mix-comp L builds the initial prior from the CVhat
    heuristic (sim_probit.cpp:53-77) when --vars is not given."""
    geno = _load_geno(opt, device)
    rng = np.random.default_rng(opt.seed)
    h2 = opt.h2 if opt.h2 != -1 else 0.5
    cv = opt.CV or max(geno.Mt // 100, 1)
    if opt.sim_model == "realistic":
        vars_t, probs_t = sim.realistic_prior(geno.Mt, h2)
    elif opt.sim_model == "heavy-tails":
        vars_t, probs_t = sim.heavy_tails_prior(geno.Mt, cv, h2)
    else:
        vars_t, probs_t = sim.two_group_prior(geno.Mt, cv, h2)
    cov_eff = None
    if opt.sim_model == "probit" and opt.cov_file and opt.C > 0:
        geno.read_covariates(opt.cov_file, opt.C)
        cov_eff = (2.0 * (np.arange(opt.C) % 2) - 1.0) * 0.25
    if opt.true_signal_files:
        beta = vecio.read_estimate(opt.true_signal_files[0], geno.M, geno.S)
        y = vecio.read_txt_shard(opt.phen_files[0], geno.N, 0)
    else:
        beta = sim.simulate_mixture(rng, geno.M, vars_t, probs_t)
        if opt.sim_model == "probit":
            y = sim.simulate_probit_phenotype(geno, beta, opt.probit_var, rng,
                                              cov_effects=cov_eff)
        else:
            y = sim.simulate_linear_phenotype(geno, beta, 1.0 / (1.0 - h2),
                                              rng)
        _write_bin(opt.out_prefix + "_beta_true.bin", beta, geno.S)
        _write_txt(opt.out_prefix + "_y.txt", y)
    geno.set_phen(y)
    probs_i, vars_i = opt.probs, opt.vars
    if not opt.vars and opt.num_mix_comp > 1:
        L = opt.num_mix_comp
        cvhat = max(cv // 2, 1)
        pe = cvhat / geno.Mt / (2.0 - 1.0 / 2.0 ** (L - 1))
        curr_var = 0.01 / cvhat
        probs_i, vars_i = [1.0 - cvhat / geno.Mt], [0.0]
        for _ in range(1, L):
            probs_i.append(pe)
            vars_i.append(curr_var)
            curr_var *= 10.0
            pe /= 2.0
    elif not opt.vars:
        probs_i, vars_i = list(probs_t), list(vars_t)
    probs, vars_user = initialize_prior(probs_i or None, vars_i or None,
                                        N=geno.N, Mt=geno.Mt)
    common = dict(max_iter=opt.iterations, rho=opt.rho,
                  cg_max_iter=opt.CG_max_iter,
                  stop_criteria_thr=opt.stop_criteria_thr, seed=opt.seed,
                  gam1_init=1e-8, em_max_iter=opt.EM_max_iter,
                  em_err_thr=opt.EM_err_thr, learn_vars=bool(opt.learn_vars))
    if opt.sim_model == "probit":
        model, eng = "bin_class", probit
        cfg = probit.ProbitConfig(probit_var=opt.probit_var, **common)
    else:
        model, eng = "linear", linear
        cfg = linear.VampConfig(gamw_init=2.0, **common)
    x_est, state, hist = eng.infer(
        geno, cfg, probs, vars_user, true_signal=beta,
        callbacks=[_dumper(opt.out_prefix, opt.dump_every, model)],
        verbose=opt.verbosity > 0)
    _check_replicated(geno, state)
    _write_history(opt.out_prefix, hist)
    return x_est


def mode_infere(opt: Options, device):
    """``--run-mode infere``: fit the model, dump per iteration."""
    return run_inference(opt, _load_geno(opt, device))


MODES = {
    "infere": mode_infere,
    "test": mode_test,
    "both": mode_both,
    "restart": mode_restart,
    "pvals-calc": mode_pvals_calc,
    "predict": lambda o, d: mode_predict(o, d, single=False),
    "predict_single": lambda o, d: mode_predict(o, d, single=True),
    "sim": mode_sim,
}


def _load_geno(opt: Options, device, test: bool = False):
    """The training container (``test``: the test set's, from
    --bed-file-test, --phen-files-test, --N-test and --Mt-test) on
    ``device``: ``GenoDense`` under --type-data meth, else ``GenoBed``;
    binary phenotypes stay raw 0/1 (gvamp_tpu/cli.py:61-80)."""
    dtype = torch.float64 if opt.dtype == "float64" else torch.float32
    phen = opt.phen_files_test if test else opt.phen_files
    container = GenoDense if opt.type_data == "meth" else GenoBed
    geno = container.from_files(
        opt.bed_file_test if test else opt.bed_file,
        phen[0] if phen else None, N=opt.N_test if test else opt.N,
        Mt=opt.Mt_test if test else opt.Mt, alpha_scale=opt.alpha_scale,
        dtype=dtype, standardize_phen=opt.model != "bin_class",
        device=torch.device(device), bim_path=opt.bim_file,
        mesh=_mesh(opt, device))
    if opt.cov_file and opt.C > 0:
        geno.read_covariates(opt.cov_file, opt.C)
    return geno


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="torch device of the run (default: cuda)")
    ns, rest = pre.parse_known_args(argv)
    opt = Options.from_args(rest)
    _check_slice(opt)
    device = ns.device
    if opt.distributed:
        # join the process group before any device use (gvamp_tpu/cli.py:
        # 921-943); the first process alone logs
        rank = dist.initialize(
            opt.coordinator or None, opt.n_processes or None,
            opt.process_id if opt.process_id >= 0 else None, device=device)
        device = dist.process_device(device)
        if rank != 0:
            opt.verbosity = 0

    def run():
        return MODES[opt.run_mode](opt, device)

    try:
        if opt.profile_dir:
            out = _profiled(run, opt.profile_dir, torch.device(device))
        else:
            out = run()
        if opt.distributed:
            dist.barrier()
    finally:
        if opt.distributed:
            dist.finalize()
    return out


def _profiled(run, out_dir: str, device: torch.device):
    """--profile-dir (``gvamp_tpu/cli.py:934-939``): the run mode under
    ``torch.profiler``, host activity always and the card's on CUDA, its
    Chrome trace written as ``out_dir/trace.json`` with the program's spans
    added (``_add_spans``), and one line per span name printed: count,
    host ms in all, host ms less the spans' children, counted syncs.  A
    profiler that cannot start raises, and so does a CUDA run whose trace
    holds no device activity."""
    from torch.autograd import kineto_available
    from torch.profiler import ProfilerActivity, profile
    if not kineto_available():
        raise RuntimeError("--profile-dir: this torch build has no profiler "
                           "(kineto) support")
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    trace.clear()
    with profile(activities=acts) as prof:
        out = run()
    if device.type == "cuda" and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError("--profile-dir: the profiler recorded no CUDA "
                           "activity")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, trace.spans())
    print(f"profile -> {path}")
    print(f"{'span':<16} {'count':>7} {'host ms':>11} {'self ms':>11} "
          f"{'syncs':>7}")
    for name, n, total, own, syncs in trace.summary():
        print(f"{name:<16} {n:7d} {total:11.3f} {own:11.3f} {syncs:7d}")
    trace.clear()
    return out


def _add_spans(path: str, spans: list) -> None:
    """Write ``spans`` into the Chrome trace at ``path`` as complete events
    on a process row of their own, their ``time.time_ns`` stamps moved to
    the file's time base (``baseTimeNanoseconds``, 0 where it has none;
    timestamps in microseconds)."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    events = doc["traceEvents"]
    pid = 1 + max([e["pid"] for e in events
                   if isinstance(e.get("pid"), int)] or [0])
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "gvamp_tpu_torch spans"}})
    for s in spans:
        if s.end_ns is None:
            continue
        events.append({"ph": "X", "name": s.name, "cat": "program",
                       "pid": pid, "tid": 0,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.attrs, syncs=s.syncs,
                                    launches=s.launches, seq=s.seq)})
    with open(path, "w") as f:
        json.dump(doc, f)


if __name__ == "__main__":
    main(sys.argv[1:])
