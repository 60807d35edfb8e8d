"""Run-mode entry point of the PyTorch port: ``python -m gvamp_tpu_torch.cli``.

The flags are those of the JAX package's CLI (parsed by the port's copy of
its ``Options``), plus ``--device`` (default ``cuda``) for the port.  This
slice runs ``--run-mode infere`` and ``--run-mode restart`` on one device
(``cli.py:61-80, 113-242, 400-520`` of the JAX package), for one phenotype
or, with several comma-separated ``--phen-files``, for T phenotypes in one
joint run of the multi-trait engines (``gvamp_tpu_torch.multi``).
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
full engine state and its config at every dump; ``--run-mode restart``
either continues such a checkpoint (``--resume PATH``: ``--iterations``
more iterations under the checkpoint's config) or starts from an estimate
file (``--estimate-file``: r1 for the linear model, with ``--gam1-init``
and ``--gamw-init`` injected, as the JAX CLI does).
A multi-trait run writes each trait's estimate as
``{out}_phen{t}{tag}_it_{i}.bin``, a linear one the ``_phen{t}_gam1s`` /
``_gam2s`` / ``_R2trains`` histories, and ``--checkpoint`` the joint state
at every iteration with the trait count ``T`` in its metadata;
``--use-XXT-denoiser``, ``--use-lmmse-damp``, ``--use-cross-val``,
``--use-freeze``, ``--init-est`` and ``--phase-timers`` are refused there,
as the JAX CLI refuses them.  ``--use-slq 0`` takes the Onsager traces
from probe columns riding the block CG, ``--red 1`` (``--model linear``,
one phenotype) solves on a moving 10% window of the samples,
``--sync-every K`` fetches the metrics (and runs the dumps and the
stopping test) once per K iterations, ``--phase-timers 1`` prints each
phase's wall clock per iteration, ``--store-pip 1`` writes the final
posterior inclusion probabilities ``{out}{tag}_pip.bin`` (per trait
``{out}_phen{t}{tag}_pip.bin``), and ``--profile-dir DIR`` writes a
``torch.profiler`` Chrome trace of the run mode, ``DIR/trace.json``.
With ``--store-pvals`` 1 or 2 a linear run then writes the LOO p-values
``{out}_pvals.bin`` and, when a ``--bim-file`` is given, the LOCO
p-values ``{out}_pvals_LOCO.bin`` and each chromosome's genetic predictor
``{out}_LOCO_chr_{ch}.csv`` (``cli.py:176-177, 373-392`` of the JAX
package, whose semantics are kept: at the default 0 no p-values are
computed); a multi-trait linear run writes them per trait under
``{out}_phen{t}``.  Genotypes with missing calls run through the general
kernels; ``--use-XXT-denoiser 1`` runs the dual (N-space) LMMSE solve
through the fused dual Gram kernels; ``--deflate-k K`` preconditions the
primal solves with the top K eigenpairs of A^T A.  Every other run mode,
model and option outside the slice raises ``NotImplementedError`` naming
its ROADMAP.md item (Queue 1 item 11).

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
import os
import sys

import numpy as np
import torch

from gvamp_tpu_torch import linear, multi, probit, robust
from gvamp_tpu_torch.ckpt import (load_state, read_meta, save_state,
                                  write_scalar_history)
from gvamp_tpu_torch.data import GenoBed
from gvamp_tpu_torch.io import plink, vecio
from gvamp_tpu_torch.ops import pvals
from gvamp_tpu_torch.options import Options
from gvamp_tpu_torch.prior import Prior, initialize_prior, pip


def _check_slice(opt: Options) -> None:
    """Raise on every flag outside the ported slice."""
    if opt.backend != "auto":
        raise ValueError("--backend picks a JAX backend; the port routes by "
                         "--dtype (float32: CUDA kernels, float64: CPU)")
    for on, what, item in (
            (opt.run_mode not in ("infere", "restart"),
             f"--run-mode {opt.run_mode}", 11),
            (opt.type_data != "bed", f"--type-data {opt.type_data}", 11),
            (opt.state_evo != 0, "--state-evo", 11),
            (opt.devices > 1 or opt.distributed != 0, "a device mesh "
                                                     "(--devices, "
                                                     "--distributed)", 11)):
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}")


_TAGS = {"linear": "", "bin_class": "_probit", "robust": "_robust"}


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
        vecio.write_txt(path, full)

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
            vecio.write_bin_shard(prefix + name,
                                  vec[: geno.M].cpu().numpy() * scale, geno.S)
        for nm in ("z1",) if model == "linear" else ("z1", "p1"):
            planar_csv(f"{prefix}{tag}_{nm}_it_{it}.csv", getattr(state, nm),
                       geno)
        if checkpoint:
            save_state(checkpoint, state, it=it, model=model, **meta)

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
    if hist:
        write_scalar_history(opt.out_prefix, hist)
    # the JAX CLI's test (cli.py:176): the default 0 computes no p-values
    if opt.store_pvals:
        _store_pvals_after_infer(opt, geno, state)
    if opt.store_pip:
        _store_pip(opt, geno, state)
    return x_est, state, hist


def _store_pip(opt: Options, geno: GenoBed, state, tag: str = "",
               T: int = 0) -> None:
    """--store-pip (``gvamp_tpu/cli.py:307-329``): each marker's posterior
    inclusion probability P(x != 0 | r1, gam1) at the final iterate, from
    the state's internal-scale r1, gam1 and prior, as
    ``{out}{tag}_pip.bin``, or per trait ``{out}_phen{t}{tag}_pip.bin``."""
    def one(r1, gam1, probs, vars_, name):
        p = pip(r1, gam1, Prior(probs=probs, vars=vars_))[: geno.M]
        vecio.write_bin_shard(name, p.cpu().numpy(), geno.S)
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
                vecio.write_bin_shard(
                    f"{opt.out_prefix}_phen{t}{tag}_it_{it}.bin", x[:, t],
                    g.S)
        if opt.checkpoint:
            save_state(opt.checkpoint, state, it=it, model=opt.model,
                       T=mp.T, cfg=dataclasses.asdict(cfg))

    return cb


def _write_multi_scalar_history(prefix: str, hist, T: int) -> None:
    """Per-trait gam1s / gam2s / R2trains CSVs under ``{prefix}_phen{t}``
    (vamp.cpp:778-794 per trait)."""
    keys = ("gam1", "gam2", "R2_train_1", "R2_train_2")
    for t in range(T):
        write_scalar_history(f"{prefix}_phen{t}", [
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
        vecio.write_bin_shard(name + ".bin", pvals.loo_pvals(geno, z1_t, x1_t),
                              geno.S)
        print(f"pvals -> {name}.bin")
        if opt.bim_file:
            ploco = pvals.loco_pvals(
                geno, z1_t, x1_t, geno.chromosomes(),
                predictor_cb=_loco_predictor_writer(opt, geno, f"_phen{t}"))
            vecio.write_bin_shard(name + "_LOCO.bin", ploco, geno.S)


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
                          dtype=geno.dtype)
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
    if hist:
        write_scalar_history(opt.out_prefix, hist)
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
                          dtype=geno.dtype)
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
    vecio.write_bin_shard(opt.out_prefix + "_pvals.bin", p, geno.S)
    print(f"pvals -> {opt.out_prefix}_pvals.bin")
    if opt.bim_file:
        ploco = pvals.loco_pvals(
            geno, state.z1, state.x1, geno.chromosomes(),
            predictor_cb=_loco_predictor_writer(opt, geno))
        vecio.write_bin_shard(opt.out_prefix + "_pvals_LOCO.bin", ploco,
                              geno.S)
        print(f"LOCO pvals -> {opt.out_prefix}_pvals_LOCO.bin")


def _loco_predictor_writer(opt: Options, geno: GenoBed, tag: str = ""):
    """predictor_cb writing each chromosome's predictor as
    ``{out}{tag}_LOCO_chr_{ch}.csv`` in the original sample order (``tag``
    ``_phen{t}`` in a multi-trait run)."""
    def cb(ch, y_chrom):
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = geno.deplanarize(y_chrom)[: geno.N]
        vecio.write_txt(f"{opt.out_prefix}{tag}_LOCO_chr_{ch}.csv", full)
    return cb


def _load_geno(opt: Options, device) -> GenoBed:
    """The training container on ``device``; binary phenotypes stay raw
    0/1 (gvamp_tpu/cli.py:68-76)."""
    dtype = torch.float64 if opt.dtype == "float64" else torch.float32
    geno = GenoBed.from_files(
        opt.bed_file, opt.phen_files[0], N=opt.N, Mt=opt.Mt,
        alpha_scale=opt.alpha_scale, dtype=dtype,
        standardize_phen=opt.model != "bin_class",
        device=torch.device(device), bim_path=opt.bim_file)
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

    def run():
        if opt.run_mode == "restart":
            return mode_restart(opt, ns.device)
        return run_inference(opt, _load_geno(opt, ns.device))

    if opt.profile_dir:
        return _profiled(run, opt.profile_dir, torch.device(ns.device))
    return run()


def _profiled(run, out_dir: str, device: torch.device):
    """--profile-dir (``gvamp_tpu/cli.py:934-939``): the run mode under
    ``torch.profiler``, host activity always and the card's on CUDA, its
    Chrome trace written as ``out_dir/trace.json``.  A profiler that cannot
    start raises, and so does a CUDA run whose trace holds no device
    activity."""
    from torch.autograd import kineto_available
    from torch.profiler import ProfilerActivity, profile
    if not kineto_available():
        raise RuntimeError("--profile-dir: this torch build has no profiler "
                           "(kineto) support")
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
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
    print(f"profile -> {path}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
