"""Run-mode entry point of the PyTorch port: ``python -m gvamp_tpu_torch.cli``.

The flags are those of the JAX package's CLI (parsed by the port's copy of
its ``Options``), plus ``--device`` (default ``cuda``) for the port.  This
slice runs ``--run-mode infere`` on one device for one phenotype
(``cli.py:61-80, 113-212, 400-402`` of the JAX package).  ``--model
linear`` writes the reference-layout dumps per iteration:

  {out}_it_{i}.bin  {out}_r1_it_{i}.bin  {out}_r2_it_{i}.bin
  {out}_it_{i}_x2_hat.bin  {out}_z1_it_{i}.csv

plus the ``_gam1s`` / ``_gam2s`` / ``_R2trains`` histories at the end.
``--model bin_class`` (probit regression on a case/control phenotype,
which is not standardised, with ``--cov-file`` / ``--C`` fixed covariates
and ``--probit-var``) writes

  {out}_probit_it_{i}.bin  {out}_probit_r1_it_{i}.bin
  {out}_probit_z1_it_{i}.csv  {out}_probit_p1_it_{i}.csv
With ``--store-pvals`` 1 or 2 it then writes the LOO p-values
``{out}_pvals.bin`` and, when a ``--bim-file`` is given, the LOCO
p-values ``{out}_pvals_LOCO.bin`` and each chromosome's genetic predictor
``{out}_LOCO_chr_{ch}.csv`` (``cli.py:176-177, 373-392`` of the JAX
package, whose semantics are kept: at the default 0 no p-values are
computed).  Genotypes with missing calls run through the general kernels;
``--use-XXT-denoiser 1`` runs the dual (N-space) LMMSE solve through the
fused dual Gram kernels.  Every other run mode, model and option outside
the slice raises ``NotImplementedError`` naming its ROADMAP.md item.

Example::

    python -m gvamp_tpu_torch.cli --device cuda --run-mode infere \\
        --model linear --bed-file demo.bed --phen-files demo.phen \\
        --bim-file demo.bim --N 800 --Mt 240 --iterations 8 \\
        --probs 0.95,0.05 --vars 0.0,0.0667 --store-pvals 1 \\
        --out-dir out --out-name demo
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from gvamp_tpu_torch import linear, probit
from gvamp_tpu_torch.ckpt import write_scalar_history
from gvamp_tpu_torch.data import GenoBed
from gvamp_tpu_torch.io import vecio
from gvamp_tpu_torch.ops import pvals
from gvamp_tpu_torch.options import Options
from gvamp_tpu_torch.prior import initialize_prior


def _check_slice(opt: Options) -> None:
    """Raise on every flag outside the ported slice."""
    if opt.backend != "auto":
        raise ValueError("--backend picks a JAX backend; the port routes by "
                         "--dtype (float32: CUDA kernels, float64: CPU)")
    for on, what, item in (
            (opt.run_mode != "infere", f"--run-mode {opt.run_mode}", 11),
            (opt.model not in ("linear", "bin_class"), f"--model {opt.model}",
             9),
            (len(opt.phen_files) > 1, "multi-trait runs (several "
                                      "--phen-files)", 10),
            (opt.type_data != "bed", f"--type-data {opt.type_data}", 11),
            (opt.store_pip != 0, "--store-pip", 12),
            (opt.state_evo != 0, "--state-evo", 11),
            (bool(opt.checkpoint or opt.resume), "--checkpoint / --resume", 4),
            (opt.devices > 1 or opt.distributed != 0, "a device mesh "
                                                     "(--devices, "
                                                     "--distributed)", 11),
            (bool(opt.profile_dir), "--profile-dir", 12)):
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet: ROADMAP.md Queue 1 item {item}")


def _dumper(prefix: str, every: int, model: str = "linear"):
    """Per-iteration reference-layout dumps (``gvamp_tpu.ckpt.IterDumper``,
    written from one process): x1, r1, r2, x2 and the z1 CSV for the
    linear model; x1, r1 and the z1 / p1 CSVs under ``_probit`` for
    bin_class (vamp_probit.cpp:211-225)."""
    tag = "_probit" if model == "bin_class" else ""

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
        if not tag:
            vecs += [(f"_r2_it_{it}.bin", state.r2),
                     (f"_it_{it}_x2_hat.bin", state.x2)]
        for name, vec in vecs:
            vecio.write_bin_shard(prefix + name,
                                  vec[: geno.M].cpu().numpy() * scale, geno.S)
        for nm in ("z1", "p1") if tag else ("z1",):
            planar_csv(f"{prefix}{tag}_{nm}_it_{it}.csv", getattr(state, nm),
                       geno)

    return cb


def _common_cfg(opt: Options, gam1_init: float) -> dict:
    """Engine-config fields shared by the model families
    (``gvamp_tpu.cli._common_cfg``)."""
    return dict(
        max_iter=opt.iterations, rho=opt.rho,
        stop_criteria_thr=opt.stop_criteria_thr, em_max_iter=opt.EM_max_iter,
        em_err_thr=opt.EM_err_thr, cg_max_iter=opt.CG_max_iter,
        learn_vars=bool(opt.learn_vars), seed=opt.seed,
        deflate_k=opt.deflate_k, deflate_iters=opt.deflate_iters,
        cg_plateau=opt.cg_plateau, use_slq=bool(opt.use_slq),
        slq_k=opt.slq_k, stab_gamma=opt.stab_gamma, gam1_init=gam1_init)


def run_inference(opt: Options, geno: GenoBed):
    """The single-phenotype linear and bin_class branches of
    ``gvamp_tpu.cli.run_inference``."""
    probs, vars_user = initialize_prior(opt.probs or None, opt.vars or None,
                                        N=geno.N, Mt=geno.Mt)
    ts = (vecio.read_estimate(opt.true_signal_files[0], geno.M, geno.S)
          if opt.true_signal_files else None)
    if opt.model == "bin_class":
        cfg = probit.ProbitConfig(probit_var=opt.probit_var,
                                  **_common_cfg(opt, 1e-8))
        return probit.infer(
            geno, cfg, probs, vars_user, true_signal=ts,
            sync_every=opt.sync_every, phase_timers=bool(opt.phase_timers),
            verbose=opt.verbosity > 0,
            callbacks=[_dumper(opt.out_prefix, opt.dump_every, opt.model)])
    freeze = (vecio.read_estimate(opt.freeze_index_file, geno.M, geno.S)
              if opt.use_freeze else None)
    x1_init = (vecio.read_estimate(opt.estimate_file, geno.M, geno.S)
               if opt.init_est and opt.estimate_file else None)
    cfg = linear.VampConfig(
        **_common_cfg(opt, 1e-6),
        gamw_init=opt.gamw_default(),
        use_lmmse_damp=bool(opt.use_lmmse_damp),
        use_xxt=bool(opt.use_XXT_denoiser), gamma_damp=opt.gamma_damp,
        red=bool(opt.red), use_cross_val=bool(opt.use_cross_val),
        cg_extrapolate=opt.cg_extrapolate != 0)
    x_est, state, hist = linear.infer(
        geno, cfg, probs, vars_user, freeze=freeze, x1_init=x1_init,
        true_signal=ts, sync_every=opt.sync_every,
        phase_timers=bool(opt.phase_timers), verbose=opt.verbosity > 0,
        callbacks=[_dumper(opt.out_prefix, opt.dump_every)])
    if hist:
        write_scalar_history(opt.out_prefix, hist)
    # the JAX CLI's test (cli.py:176): the default 0 computes no p-values
    if opt.store_pvals:
        _store_pvals_after_infer(opt, geno, state)
    return x_est, state, hist


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


def _loco_predictor_writer(opt: Options, geno: GenoBed):
    """predictor_cb writing each chromosome's predictor as
    ``{out}_LOCO_chr_{ch}.csv`` in the original sample order."""
    def cb(ch, y_chrom):
        full = np.zeros(4 * geno.layout.mbytes)
        full[: geno.N] = geno.deplanarize(y_chrom)[: geno.N]
        vecio.write_txt(f"{opt.out_prefix}_LOCO_chr_{ch}.csv", full)
    return cb


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="torch device of the run (default: cuda)")
    ns, rest = pre.parse_known_args(argv)
    opt = Options.from_args(rest)
    _check_slice(opt)
    dtype = torch.float64 if opt.dtype == "float64" else torch.float32
    # binary phenotypes stay raw 0/1 (gvamp_tpu/cli.py:68-76)
    geno = GenoBed.from_files(
        opt.bed_file, opt.phen_files[0], N=opt.N, Mt=opt.Mt,
        alpha_scale=opt.alpha_scale, dtype=dtype,
        standardize_phen=opt.model != "bin_class",
        device=torch.device(ns.device), bim_path=opt.bim_file)
    if opt.cov_file and opt.C > 0:
        geno.read_covariates(opt.cov_file, opt.C)
    return run_inference(opt, geno)


if __name__ == "__main__":
    main(sys.argv[1:])
