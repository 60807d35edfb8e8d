"""CLI options — flag-for-flag compatible with the reference parser.

The reference hand-rolls an exact-match strcmp loop over ~40 flags
(options.cpp:18-429) with defaults in options.hpp:107-142.  Same flag names
and defaults here, argparse-based, plus validation (check_options,
options.cpp:444-492) and out-dir auto-creation (options.cpp:274-277).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional


@dataclasses.dataclass
class Options:
    run_mode: str = "infere"
    model: str = "linear"               # linear | bin_class | robust
    bed_file: str = ""
    bed_file_test: str = ""
    phen_files: List[str] = dataclasses.field(default_factory=list)
    phen_files_test: List[str] = dataclasses.field(default_factory=list)
    true_signal_files: List[str] = dataclasses.field(default_factory=list)
    cov_file: str = ""
    bim_file: str = ""
    estimate_file: str = ""
    cov_estimate_file: str = ""
    freeze_index_file: str = ""
    out_dir: str = ""
    out_name: str = ""
    N: int = 0
    Mt: int = 0
    N_test: int = 0
    Mt_test: int = 0
    iterations: int = 1
    num_mix_comp: int = 0
    vars: List[float] = dataclasses.field(default_factory=list)
    probs: List[float] = dataclasses.field(default_factory=list)
    test_iter_range: List[int] = dataclasses.field(default_factory=lambda: [-1, -1])
    rho: float = 0.15
    h2: float = -1.0
    CV: int = 0
    C: int = 0
    stop_criteria_thr: float = 1e-4
    EM_err_thr: float = 1e-2
    EM_max_iter: int = 2
    CG_max_iter: int = 60
    learn_vars: int = 1
    store_pvals: int = 0
    use_lmmse_damp: int = 0
    use_XXT_denoiser: int = 0
    use_freeze: int = 0
    init_est: int = 0
    red: int = 0
    seed: int = 1
    alpha_scale: float = 1.0
    probit_var: float = 1.0
    gamw_init: float = 0.0
    gam1_init: float = -1.0
    gamma_damp: float = 1.0
    use_cross_val: int = 0          # live version of the reference's dormant
                                    # cross-validated damping (vamp.hpp:61)
    state_evo: int = 0              # print per-iteration state-evolution
                                    # predictions of (alpha1, eta1, gam2)
                                    # next to the measured values — the live
                                    # version of the reference's dormant
                                    # state_evo diagnostic (vamp.cpp:
                                    # 1376-1411, calc_state_evo=0 at
                                    # vamp.hpp:38); linear model only
    store_pip: int = 0              # write per-marker posterior inclusion
                                    # probabilities at the final iterate
                                    # (extension; the reference only uses
                                    # this posterior internally, vamp.cpp:979)
    stab_gamma: float = 1.0         # geometric trust region on the gam1/tau1
                                    # recurrences of the z-model engines
                                    # (bin_class/robust, single- and
                                    # multi-trait); 1.0 = reference dynamics.
                                    # Rescues late-iteration precision
                                    # collapse at small N (extension; see
                                    # linear.VampConfig.stab_gamma)
    cg_plateau: int = 12            # CG stagnation exit: freeze a column
                                    # after this many consecutive CG
                                    # iterations without >=1% residual
                                    # improvement; 0 = reference behavior
                                    # (burn the full --CG-max-iter budget on
                                    # ill-conditioned solves).  See
                                    # linear.VampConfig.cg_plateau
    # extensions beyond the reference CLI:
    type_data: str = "bed"          # bed | meth (reference data ctor arg,
                                    # data.hpp:93; meth = raw-double matrix
                                    # at --bed-file)
    predict_format: str = "matrix"  # predict-mode output: "matrix" = ONE
                                    # <out>_predict_matrix.csv with a row per
                                    # test individual (columns = iterations);
                                    # "per-individual" = the reference's
                                    # file-per-individual behavior
                                    # (main_real.cpp:538-545 — N_test files;
                                    # 400k files at biobank scale)
    sim_model: str = "default"      # sim run-mode recipe: default (sim.cpp),
                                    # realistic, heavy-tails, probit
    dtype: str = "float32"          # compute dtype (reference: f64 only)
    backend: str = "auto"           # pallas | xla | auto
    devices: int = 0                # mesh size (0 = all available)
    dump_every: int = 1             # per-iteration estimate dumps (0 = off)
    sync_every: int = 1             # iterations per device dispatch
                                    # (throughput mode, linear model)
    profile_dir: str = ""           # jax.profiler trace output directory
                                    # ("" = off); pairs with --phase-timers
    phase_timers: int = 0           # per-phase wall-clock per iteration
                                    # (denoise/z1/CG/noise spans like the
                                    # reference's MPI_Wtime prints,
                                    # vamp.cpp:752-755); linear model
    deflate_k: int = 0              # spectral deflation rank for the CG
                                    # operator (0 = off; ~256 cuts CG
                                    # iterations ~4x on LD-structured data)
    deflate_iters: int = 8          # block power-iteration steps
    use_slq: int = 1                # Onsager alpha2 + noise-EM trace from
                                    # stochastic Lanczos quadrature on the
                                    # fixed Gram (one slq-k-pass setup,
                                    # amortized) instead of per-iteration
                                    # probe CG columns; 0 = probe columns
                                    # (reference g2d_onsager structure,
                                    # vamp.cpp:871-889).  Ignored under
                                    # --red (windowed operator).  See
                                    # linear.VampConfig.use_slq
    slq_k: int = 32                 # Lanczos steps (quadrature nodes)
    cg_extrapolate: int = -1        # secant-extrapolated CG warm start over
                                    # the last two LMMSE exits (per-column
                                    # closed-form least-squares theta from
                                    # Gram linearity, zero extra passes):
                                    # steady-state CG drops to ONE iteration
                                    # on bandwidth-bound runs (round-5
                                    # measurement, BASELINE.md).  -1 = auto
                                    # (ON for linear models — single- and
                                    # multi-trait — on the primal two-pass
                                    # path; vacuous elsewhere); explicit 1
                                    # is rejected where it cannot apply.
                                    # See linear.VampConfig.cg_extrapolate
    checkpoint: str = ""            # full-state checkpoint path ("" = off)
    resume: str = ""                # resume from a full-state checkpoint
    verbosity: int = 1
    # multi-process (multi-host) execution — the MPI_Init analog
    # (gvamp_tpu/dist.py).  --distributed 1 joins a cluster; coordinator /
    # n-processes / process-id may also come from GVAMP_COORDINATOR,
    # GVAMP_NPROCS, GVAMP_PROC_ID, or be auto-discovered on TPU pods.
    distributed: int = 0
    coordinator: str = ""
    n_processes: int = 0
    process_id: int = -1

    @classmethod
    def parser(cls) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(
            prog="gvamp-tpu",
            description="TPU-native gVAMP: whole-genome VAMP regression")

        def flag(name, **kw):
            p.add_argument(name, dest=name.lstrip("-").replace("-", "_"), **kw)

        flag("--run-mode", default="infere",
             choices=["infere", "test", "both", "restart", "predict",
                      "predict_single", "pvals-calc", "sim"])
        flag("--model", default="linear",
             choices=["linear", "bin_class", "robust"])
        for f in ["--bed-file", "--bed-file-test", "--cov-file", "--bim-file",
                  "--estimate-file", "--cov-estimate-file",
                  "--freeze-index-file", "--out-dir", "--out-name",
                  "--checkpoint", "--resume", "--profile-dir"]:
            flag(f, default="")
        for f, d in [("--N", 0), ("--Mt", 0), ("--N-test", 0), ("--Mt-test", 0),
                     ("--iterations", 1), ("--num-mix-comp", 0), ("--CV", 0),
                     ("--C", 0), ("--EM-max-iter", 2), ("--CG-max-iter", 60),
                     ("--learn-vars", 1), ("--store-pvals", 0),
                     ("--store-pip", 0), ("--state-evo", 0),
                     ("--use-lmmse-damp", 0), ("--use-XXT-denoiser", 0),
                     ("--use-freeze", 0), ("--init-est", 0), ("--red", 0),
                     ("--use-cross-val", 0),
                     ("--seed", 1), ("--devices", 0), ("--dump-every", 1),
                     ("--sync-every", 1), ("--phase-timers", 0),
                     ("--deflate-k", 0),
                     ("--deflate-iters", 8), ("--cg-plateau", 12),
                     ("--use-slq", 1), ("--slq-k", 32),
                     ("--cg-extrapolate", -1),
                     ("--distributed", 0), ("--n-processes", 0),
                     ("--process-id", -1),
                     ("--verbosity", 1)]:
            flag(f, type=int, default=d)
        for f, d in [("--rho", 0.15), ("--h2", -1.0),
                     ("--stop-criteria-thr", 1e-4), ("--EM-err-thr", 1e-2),
                     ("--alpha-scale", 1.0), ("--probit-var", 1.0),
                     ("--gamw-init", 0.0), ("--gam1-init", -1.0),
                     ("--gamma-damp", 1.0), ("--stab-gamma", 1.0)]:
            flag(f, type=float, default=d)
        for f in ["--phen-files", "--phen-files-test", "--true-signal-files"]:
            flag(f, type=lambda s: s.split(","), default=[])
        flag("--vars", type=lambda s: [float(x) for x in s.split(",")], default=[])
        flag("--probs", type=lambda s: [float(x) for x in s.split(",")], default=[])
        flag("--test-iter-range", type=lambda s: [int(x) for x in s.split(",")],
             default=[-1, -1])
        flag("--type-data", default="bed", choices=["bed", "meth"])
        flag("--predict-format", default="matrix",
             choices=["matrix", "per-individual"])
        flag("--sim-model", default="default",
             choices=["default", "realistic", "heavy-tails", "probit"])
        flag("--dtype", default="float32", choices=["float32", "float64"])
        flag("--backend", default="auto", choices=["auto", "pallas", "xla"])
        flag("--coordinator", default="")
        return p

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None) -> "Options":
        ns = cls.parser().parse_args(argv)
        opt = cls(**vars(ns))
        opt.check()
        return opt

    def check(self) -> None:
        """Reference-grade validation (check_options, options.cpp:444-492).

        Every inconsistency fails fast with a message instead of surfacing
        as a downstream shape error or a silently ignored flag."""

        def fatal(msg):
            raise SystemExit("FATAL  : " + msg)

        train_modes = {"infere", "both", "restart", "sim", "pvals-calc"}
        test_modes = {"test", "both", "predict", "predict_single"}
        if self.run_mode in train_modes:
            if not self.bed_file:
                fatal("you need to specify the location of the genotype data"
                      " (--bed-file)")
            if self.N <= 0:
                fatal("specify number of individuals in the training set"
                      " (--N)")
            if self.Mt <= 0:
                fatal("specify number of markers in the training set (--Mt)")
            if self.run_mode != "sim" and not self.phen_files:
                fatal("you need to specify the location of the phenotype data"
                      " (--phen-files)")
        if self.run_mode in test_modes:
            if not self.bed_file_test:
                fatal("you need to specify the location of the test genotype"
                      " data (--bed-file-test)")
            if self.N_test <= 0:
                fatal("specify number of individuals in the test set"
                      " (--N-test)")
            if self.Mt_test <= 0:
                fatal("specify number of markers in the test set (--Mt-test)")
        if self.run_mode == "test" and not (self.phen_files_test
                                            or self.phen_files):
            fatal("you need to specify the test phenotype data"
                  " (--phen-files-test)")
        if self.run_mode in ("test", "pvals-calc", "predict",
                             "predict_single") and not self.estimate_file:
            fatal(f"run-mode {self.run_mode} needs --estimate-file")
        if self.run_mode == "restart" and not (self.estimate_file
                                               or self.resume):
            fatal("run-mode restart needs --estimate-file or --resume")
        if self.vars and self.probs and len(self.vars) != len(self.probs):
            fatal("--vars and --probs lengths differ")
        if self.iterations < 1:
            fatal("--iterations must be >= 1")
        if self.CG_max_iter < 1:
            fatal("--CG-max-iter must be >= 1")
        if self.EM_max_iter < 0:
            fatal("--EM-max-iter must be >= 0")
        if not (0.0 < self.rho <= 1.0):
            fatal("--rho must be in (0, 1]")
        if self.h2 != -1.0 and not (0.0 < self.h2 < 1.0):
            fatal("--h2 must be in (0, 1)")
        lo, hi = self.test_iter_range
        if (lo, hi) != (-1, -1) and not (0 <= lo <= hi):
            fatal("--test-iter-range needs 0 <= first <= last")
        if self.store_pvals not in (0, 1, 2):
            fatal("--store-pvals must be 0 (both), 1 (LOO) or 2 (LOCO)")
        if self.store_pip not in (0, 1):
            fatal("--store-pip must be 0 or 1")
        if self.state_evo not in (0, 1):
            fatal("--state-evo must be 0 or 1")
        if self.state_evo and self.model != "linear":
            fatal("--state-evo is only supported for --model linear "
                  "(reference state_evo lives in the linear loop, "
                  "vamp.cpp:1376-1411)")
        if self.red not in (0, 1):
            fatal("--red must be 0 or 1")
        if not (0.0 < self.stab_gamma <= 1.0):
            fatal("--stab-gamma must be in (0, 1]")
        if self.cg_plateau < 0:
            fatal("--cg-plateau must be >= 0 (0 disables the exit)")
        if self.use_slq and self.slq_k < 2:
            fatal("--slq-k must be >= 2 (quadrature nodes)")
        if self.stab_gamma != 1.0 and self.model == "linear":
            # the linear engine has its own stabilizers (--use-lmmse-damp,
            # --gamma-damp, --use-cross-val); reject rather than silently
            # ignore
            fatal("--stab-gamma is only supported for "
                  "--model bin_class/robust")
        # flags with a linear-model-only implementation (matching the
        # reference, where they live in infere_linear / vamp.cpp): reject
        # rather than silently ignore on other model families
        if self.model != "linear":
            for nm, bad in [("--gamma-damp", self.gamma_damp != 1.0),
                            ("--cg-extrapolate", self.cg_extrapolate == 1),
                            ("--red", self.red != 0),
                            ("--use-XXT-denoiser", self.use_XXT_denoiser),
                            ("--use-lmmse-damp", self.use_lmmse_damp),
                            ("--use-cross-val", self.use_cross_val),
                            ("--use-freeze", self.use_freeze)]:
                if bad:
                    fatal(f"{nm} is only supported for --model linear")
        if self.red:
            # reduced-subset solves are implemented only for the primal
            # single-trait linear path (matching the reference, vamp.cpp:
            # 561-596) — reject the unimplemented combinations loudly
            if self.use_XXT_denoiser:
                fatal("--red is not supported with --use-XXT-denoiser")
            if len(self.phen_files) > 1:
                fatal("--red is not supported for multi-trait runs")
        if self.cg_extrapolate == 1:
            # the secant pair rides the tracked-Gram carry of the primal
            # two-pass path; red re-draws its operator per iteration and
            # dual mode has its own N-space carry — reject an EXPLICIT
            # enable rather than silently ignore (the -1 auto default is
            # simply vacuous on those paths)
            if self.red:
                fatal("--cg-extrapolate is not supported with --red")
            if self.use_XXT_denoiser:
                fatal("--cg-extrapolate is not supported with "
                      "--use-XXT-denoiser")
        if self.backend == "pallas" and self.dtype == "float64":
            # the pallas kernels are int8-digit-quantized (~1e-7): honoring
            # an explicit f64 request there would silently downgrade
            # precision (VERDICT r3 #6).  --backend auto routes f64 to the
            # true-f64 XLA decode path instead.
            fatal("--backend pallas cannot honor --dtype float64 (int8 "
                  "digit quantization, ~1e-7); use --backend xla (or auto) "
                  "for float64, or --dtype float32 with pallas")
        if self.out_dir and not os.path.isdir(self.out_dir):
            os.makedirs(self.out_dir, exist_ok=True)

    @property
    def out_prefix(self) -> str:
        d = self.out_dir
        if d and not d.endswith("/"):
            d += "/"
        return d + self.out_name

    def gamw_default(self) -> float:
        """gamw init: 1/(1-h2) if h2 given, else 2 (main_real.cpp:67-73)."""
        if self.gamw_init:
            return self.gamw_init
        return 2.0 if self.h2 == -1 else 1.0 / (1.0 - self.h2)
