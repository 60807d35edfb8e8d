"""Linear-model EM-VAMP engine of the PyTorch port (the main path).

Port of ``gvamp_tpu/linear.py``: primal LMMSE block CG with the
secant-extrapolated tracked warm start and the noise-EM pass folded into
the CG exit; with the fused primal Gram (``GVAMP_FUSED_GRAM=1``),
``fold_noise=False`` or ``GVAMP_NOISE_PASS=1``, the explicit noise pass
instead (one wide forward pass over [x2, invq, x1] after the solve); and
for ``use_xxt``, the dual (N-space) LMMSE solve with its tracked warm start,
Woodbury Onsager term and the noise update from the CG residual.  The
Onsager trace comes from the SLQ quadrature (``use_slq``, the default) or
from Hutchinson probe columns riding the block CG (``use_slq=False``).
``red`` solves on a moving 10% window of the sample word rows
(``GenoBed.window_fns_multi``) with probe columns, and ``use_cross_val``
holds out the last 2% of the samples to tune the damping on their R2
(``GenoBed.sample_window``).  With ``deflate_k > 0``
the primal solve is preconditioned by the top eigenpairs of A^T A
(``cg.make_deflated_precond``).  One iteration (reference
``infere_linear``, vamp.cpp:190-803) runs JAX's five phases:

  denoise     the re-estimation loop x1 = g1(r1, gam1), alpha1, eta1, gam1
              and the EM prior update; damping of x1/alpha1.
  z1_project  adaptive rho, gam2 = eta1 - gam1, r2 = (eta1 x1 - gam1 r1) /
              gam2.
  lmmse_cg    v = gamw A^T y + gam2 r2, warm-started Jacobi CG on
              (gamw A^T A + gam2 I); alpha2 from the SLQ quadrature or the
              probe columns; gam2 re-estimate, gam1 = eta2 - gam2, r1.
              Dual: x2 = gamw A^T s + r2 with s from the CG on
              (gamw A A^T + gam2 I) s = y - A r2.
  noise_em    the gamw EM update from |A x2 - y|^2 and the trace term:
              from the CG exit (folded), one forward pass, or under red the
              full-data pass and the windowed trace pass.
  finish      the metrics and the new state.

The JAX step is one jitted program; here it runs eagerly.  Each loop exit or
branch on a device value is a counted host sync (``gvamp_tpu_torch.sync``),
and ``infer`` records the count per iteration.  ``run_chunks`` is the
driver of every engine (``sync_every`` iterations per metrics fetch), and
``make_phase_step`` composes the phases, each a span under a profiler
(``gvamp_tpu_torch.trace``) and timed under ``phase_timers``.
``state_evolution`` is the ``--state-evo`` diagnostic's prediction.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gvamp_tpu_torch import cg, slq, trace
from gvamp_tpu_torch.prior import GAMMA_MAX, GAMMA_MIN, Prior, g1, g1d, update_prior
from gvamp_tpu_torch.sync import SYNCS, host_bool, host_values


def _clamp_gamma(x):
    return torch.clamp(x, GAMMA_MIN, GAMMA_MAX)


@dataclasses.dataclass(frozen=True)
class VampConfig:
    """Engine options, with the fields and defaults of
    ``gvamp_tpu.linear.VampConfig`` (reference options.hpp:107-142 +
    vamp.hpp); see that class for each field's meaning."""

    max_iter: int = 10
    rho: float = 0.15
    stop_criteria_thr: float = 1e-4
    em_max_iter: int = 2
    em_err_thr: float = 1e-2
    cg_max_iter: int = 60
    learn_vars: bool = True
    use_lmmse_damp: bool = False
    use_xxt: bool = False
    cg_err_tol_xxt: float = 1e-4
    auto_var_max_iter: int = 5
    revar_tol: float = 1e-3
    seed: int = 1
    gam1_init: float = 1e-6
    gamw_init: float = 2.0
    cg_err_tol: float = 1e-5
    onsager_tol: float = 1e-6
    n_probes: int = 1
    gamma_damp: float = 1.0
    use_cross_val: bool = False
    cv_max_retry: int = 25
    deflate_k: int = 0
    deflate_iters: int = 8
    gram_refresh: int = 8
    red: bool = False
    stab_gamma: float = 1.0
    cg_plateau: int = 12
    use_slq: bool = True
    slq_k: int = 32
    cg_extrapolate: bool = True
    fold_noise: bool = True


def slq_on(cfg: VampConfig) -> bool:
    """The SLQ quadrature supplies the Onsager traces: ``use_slq`` and not
    ``red``, whose windowed operator changes every iteration."""
    return bool(cfg.use_slq) and not cfg.red


def probe_cols(cfg: VampConfig) -> int:
    """Onsager probe columns riding the block CG: zero under SLQ."""
    return 0 if slq_on(cfg) else cfg.n_probes


def _check_resume_probe_cols(state, cfg, T: int = 1) -> None:
    """Fail fast when a resume state's probe-column width disagrees with
    the config it is resumed under (``gvamp_tpu/linear.py:219-233``)."""
    want = T * probe_cols(cfg)
    got = int(state.mu_probe.shape[-1])
    if got != want:
        raise ValueError(
            f"resume_state carries {got} probe column(s) but the resumed "
            f"config implies {want} (use_slq={cfg.use_slq}, red={cfg.red}, "
            f"n_probes={cfg.n_probes}); resume with the checkpoint's "
            f"original use_slq setting (cli --resume restores it "
            f"automatically)")


def red_window_words(nw: int) -> int:
    """The reduced-subset window in word rows: a tenth of them, whole
    32-row tiles, at least 32 (reference LBglob = mbytes / 10,
    vamp.cpp:563; ``gvamp_tpu/linear.py:480-481``)."""
    return min(nw, max(32, (nw // 10) // 32 * 32))


def red_window_start(seed: int, S: int, it: int, nw: int, lbw: int) -> int:
    """Iteration ``it``'s window start, a multiple of 32 drawn uniformly
    from [0, nw - lbw] on the host by a CPU generator seeded by
    (seed + 3, S, it), so that no device value is read.  JAX draws it with
    ``jax.random`` (``gvamp_tpu/linear.py:739-742``), a stream torch cannot
    reproduce: parity tests pass JAX's starts through ``red_sbw``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((((seed + 3) & 0xFFFFFFFF) << 32)
                    | ((S * 65537 + it) & 0xFFFFFFFF))
    n = (nw - lbw) // 32 + 1
    return int(torch.randint(0, n, (1,), generator=gen)) * 32


class LinState(NamedTuple):
    """The fields of ``gvamp_tpu.linear.LinState``; ``it`` is a host int.
    The ``*_n`` fields carry the dual solve and stay zero in primal mode;
    ``cv_r2`` is -1 until the cross-validation tuner accepts an iterate."""

    it: int
    x1: torch.Tensor
    x2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    z1: torch.Tensor          # [4, Nb] planar
    mu_cg: torch.Tensor       # LMMSE CG warm start
    mu_cg_n: torch.Tensor     # dual CG warm start [4, Nb]
    mu_probe: torch.Tensor    # [Mpad, P] (P = 0 under SLQ)
    mu_probe_n: torch.Tensor  # [4, Nb, P]
    gam1: torch.Tensor
    gam2: torch.Tensor
    gamw: torch.Tensor
    eta1: torch.Tensor
    eta2: torch.Tensor
    alpha1: torch.Tensor
    alpha2: torch.Tensor
    rho: torch.Tensor
    probs: torch.Tensor
    vars: torch.Tensor
    cv_r2: torch.Tensor       # cross-validation: last accepted held-out R2
    gmu: torch.Tensor         # A^T A [mu_cg | mu_probe], tracked
    gmu_n: torch.Tensor       # A A^T [mu_cg_n | mu_probe_n], tracked
    mu_prevb: torch.Tensor    # the previous exit block and its tracked
    gmu_prev: torch.Tensor    # Gram product (the secant pair)


def init_state(geno, cfg: VampConfig, probs, vars_user,
               r1_init: Optional[np.ndarray] = None,
               x1_init: Optional[np.ndarray] = None,
               gam1: Optional[float] = None,
               gamw: Optional[float] = None) -> LinState:
    """Initial state; ``vars_user`` are user-scale (multiplied by N here,
    vamp.cpp:153-155), ``r1_init``/``x1_init`` stored-scale (times sqrt(N),
    vamp.cpp:226-258)."""
    dt, dev, Mp = geno.dtype, geno.device, geno.Mpad
    P = probe_cols(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def scalar(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    sqn = float(np.sqrt(geno.N))
    r1 = zeros(Mp) if r1_init is None else geno.pad_m(np.asarray(r1_init) * sqn)
    x1 = zeros(Mp) if x1_init is None else geno.pad_m(np.asarray(x1_init) * sqn)
    if x1_init is not None:
        r1 = x1
    return LinState(
        it=0, x1=x1, x2=zeros(Mp), r1=r1, r2=zeros(Mp),
        z1=zeros(*geno.y_planar.shape), mu_cg=zeros(Mp),
        mu_cg_n=zeros(*geno.y_planar.shape), mu_probe=zeros(Mp, P),
        mu_probe_n=zeros(*geno.y_planar.shape, P),
        gam1=scalar(cfg.gam1_init if gam1 is None else gam1),
        gam2=scalar(0.0),
        gamw=scalar(cfg.gamw_init if gamw is None else gamw),
        eta1=scalar(0.0), eta2=scalar(0.0), alpha1=scalar(0.0),
        alpha2=scalar(0.0), rho=scalar(cfg.rho), probs=scalar(probs),
        vars=scalar(np.asarray(vars_user) * geno.N), cv_r2=scalar(-1.0),
        gmu=zeros(Mp, 1 + P), gmu_n=zeros(*geno.y_planar.shape, 1 + P),
        mu_prevb=zeros(Mp, 1 + P), gmu_prev=zeros(Mp, 1 + P))


def make_bern_probe(geno, seed: int, n_probes: int = 1) -> torch.Tensor:
    """Deterministic Rademacher probes u_j ~ +-1/sqrt(Mt) as [Mpad, P]
    (vamp.cpp:871-883).  Drawn from a CPU ``torch.Generator`` seeded by
    (seed, S) and moved to the container's device, so the CPU and the card
    see the same probe.  JAX's ``jax.random`` stream cannot be reproduced:
    tests pass the JAX package's probe in through ``make_aux(bern=...)``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | (geno.S & 0xFFFFFFFF))
    u = torch.randint(0, 2, (geno.Mpad, n_probes), generator=gen) * 2 - 1
    return (u.to(device=geno.device, dtype=geno.dtype)
            * geno.m_mask[:, None] / math.sqrt(geno.Mt))


class Aux(NamedTuple):
    """Per-run tensors of the step."""

    op: object               # data.BedOp
    y: torch.Tensor          # filtered planar phenotype [4, Nb]
    bern: torch.Tensor       # Onsager probes [Mpad, P]
    aty: torch.Tensor        # A^T y, iteration-invariant
    z_bern: torch.Tensor     # A @ probes [4, Nb, P]
    frz: torch.Tensor        # freeze mask [Mpad]
    m_mask: torch.Tensor     # real-marker mask [Mpad]
    ts: torch.Tensor         # true signal (zeros when absent) [Mpad]
    xxt_diag_base: torch.Tensor  # sum_m A^2 per slot / N (dual Jacobi)
    slq: Optional[slq.SlqBasis]  # quadrature of the fixed Gram (A^T A;
                                 # A A^T started at z_bern in dual mode);
                                 # None on the probe path
    defl: Optional[tuple] = None  # (V [Mpad, k], lam [k]): the top
                                  # eigenpairs of A^T A (deflate_k > 0)
    red_sbw: Optional[tuple] = None  # window starts by iteration (entry
                                     # it - 1), else drawn per iteration
    hold: Optional["HoldAux"] = None  # cross-validation's held-out window


class HoldAux(NamedTuple):
    """The held-out sample window of the cross-validation damping tuner
    (``gvamp_tpu/linear.py:350-356``)."""

    op: object               # the window's data.BedOp
    y: torch.Tensor          # its filtered planar phenotype
    rescale: torch.Tensor    # sqrt(N_hold / N_train): train-scale prediction
    denom: torch.Tensor      # var(y_hold) N_hold (reference vamp.cpp:382-383)


def make_hold(geno, geno_hold) -> HoldAux:
    """The held-out window's tensors (``gvamp_tpu/linear.py:363-374``): the
    variance is that of the window's phenotype slots, the NA ones included
    as zeros, as the reference's y_cross stdev (vamp.cpp:377-383)."""
    y_h = geno_hold.filter_pheno()
    n_h = geno_hold.N
    var_h = float(np.var(geno_hold.deplanarize(y_h)[:n_h], ddof=1))
    return HoldAux(
        op=geno_hold.op, y=y_h,
        rescale=torch.as_tensor(np.sqrt(geno_hold.N / geno.N),
                                dtype=geno.dtype, device=geno.device),
        denom=torch.as_tensor(var_h * n_h, dtype=geno.dtype,
                              device=geno.device))


def xxt_diag_base(geno) -> torch.Tensor:
    """sum_m A_planar^2 per slot / N from the people statistics: the
    reference's (n_i - 1)/sig_i^2 + mu_i^2 n_i (denoiserXXT.cpp:60), so
    that the dual Jacobi diagonal is gamw * base + gam2
    (``gvamp_tpu/linear.py:375-382``)."""
    mave_p, msig_p, numb_p = geno.compute_people_statistics()
    sumsq = (torch.where(msig_p > 0, (numb_p - 1) / torch.square(
        torch.where(msig_p == 0, 1.0, msig_p)), 0.0)
        + torch.square(mave_p) * numb_p)
    return sumsq.to(geno.dtype) / geno.N


def make_deflation(geno, cfg: VampConfig, defl_v0=None):
    """The deflation basis of every engine (``deflate_k > 0``): the top
    ``deflate_k`` eigenpairs of A^T A from ``deflate_iters`` + 1 Gram
    passes at width k, fused where fn_gram is on; ``defl_v0`` replaces the
    drawn start block.  None when deflation is off."""
    from gvamp_tpu_torch import probit
    if cfg.deflate_k <= 0:
        return None
    mult, op = probit._gram_mult(geno), geno.op
    return cg.top_eigs(lambda X: mult(op, X), geno.Mpad, cfg.deflate_k,
                       seed=cfg.seed, n_iter=cfg.deflate_iters,
                       dtype=geno.dtype, device=geno.device, V0=defl_v0)


def make_aux(geno, cfg: VampConfig, freeze=None, true_signal=None,
             bern=None, defl_v0=None, red_sbw=None, geno_hold=None) -> Aux:
    """Set-up: the probe, the deflation basis (``deflate_k > 0``, primal
    and not under red, as in ``gvamp_tpu/linear.py:386-395``), A @ probe,
    the SLQ basis (``cfg.slq_k`` Gram passes, over A A^T in dual mode;
    none on the probe path) and A^T y; in dual mode also the people
    statistics; with ``geno_hold`` the cross-validation window's tensors.
    ``bern``, ``defl_v0`` and ``red_sbw`` replace the drawn probe,
    deflation start block and window starts."""
    from gvamp_tpu_torch import probit
    m_mask = geno.m_mask
    if bern is None:
        bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    else:
        bern = torch.tensor(np.asarray(bern), dtype=geno.dtype,
                            device=geno.device)
    defl = make_deflation(geno, cfg, defl_v0) if not cfg.red else None
    y = geno.filter_pheno()
    z_bern = geno.axm(bern)
    basis = None
    if cfg.use_xxt:
        diag_base = xxt_diag_base(geno)
        if slq_on(cfg):
            basis = probit.make_slq_basis_dual(geno, cfg, z_bern)
    else:
        diag_base = torch.zeros_like(y)
        if slq_on(cfg):
            basis = probit.make_slq_basis(geno, cfg, bern)
    return Aux(
        op=geno.op, y=y, bern=bern, aty=geno.atx(y), z_bern=z_bern,
        frz=(geno.pad_m(freeze) if freeze is not None
             else torch.zeros_like(m_mask)),
        m_mask=m_mask,
        ts=(geno.pad_m(true_signal) if true_signal is not None
            else torch.zeros_like(m_mask)),
        xxt_diag_base=diag_base, slq=basis, defl=defl,
        red_sbw=None if red_sbw is None else tuple(int(b) for b in red_sbw),
        hold=None if geno_hold is None else make_hold(geno, geno_hold))




def make_step(geno, cfg: VampConfig, init_est: bool = False,
              with_truth: bool = False, timer_device=None, geno_hold=None):
    """The per-iteration step: (state, aux) -> (state, metrics); with
    ``timer_device`` the step times each phase (``make_phase_step``).
    ``geno_hold`` is cross-validation's held-out window, whose forward
    product scores each try of the damping tuner."""
    from gvamp_tpu_torch import probit
    Mt = float(geno.Mt)
    N = float(geno.N)
    axm_fn, atxm_fn = geno.fns_multi()
    atx_fn = geno.fns()[1]
    # A A^T: the fused dual Gram, or two passes where fn_gram_aat says None
    gram_aat = probit._gram_aat_mult(geno) if cfg.use_xxt else None
    # A^T A: the fused primal Gram where fn_gram offers it (opt-in)
    gram_fn = geno.fn_gram()
    # the noise-EM pass folded into the CG exit (linear.py:464-468): the
    # fused Gram never forms A P, so z1 cannot ride its first pass, and
    # red's windowed operator has its own trace pass
    fold_noise = (cfg.fold_noise and not cfg.use_xxt and not cfg.red
                  and gram_fn is None
                  and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    use_slq = slq_on(cfg)
    P_cg = probe_cols(cfg)
    P = cfg.n_probes
    hold_ax = geno_hold.fns()[0] if geno_hold is not None else None
    # the reduced-subset window: the dual solve draws none, as in JAX
    red_win = cfg.red and not cfg.use_xxt
    if red_win:
        # the fused Gram never runs on it
        nw = geno.layout.n_words
        red_lbw = red_window_words(nw)
        axm_w, atxm_w = geno.window_fns_multi(red_lbw)

    def denoise(state: LinState, aux: Aux, it: int):
        """The re-estimation loop (vamp.cpp:289-338) and damping
        (vamp.cpp:348-414); its while-loop test reads gam1 on the host.
        Returns x1 and alpha1 both raw and damped."""
        m_mask, frz = aux.m_mask, aux.frz
        live = m_mask * (1.0 - frz)
        x1, gam1, alpha1, eta1 = state.x1, state.gam1, state.alpha1, state.eta1
        probs, vars_ = state.probs, state.vars
        prev_gam1 = None
        i = 0
        while i < cfg.auto_var_max_iter:
            if i > 0 and not (it > 1 and host_bool(
                    torch.abs(gam1 - prev_gam1) >= cfg.revar_tol)):
                break
            pr = Prior(probs=probs, vars=vars_)
            x1 = g1(state.r1, gam1, pr) * m_mask
            d = g1d(state.r1, gam1, pr)
            alpha1 = (d * live).sum() / Mt
            eta1 = gam1 / alpha1
            l2diff = torch.square((x1 - state.r1) * m_mask).sum()
            prev_gam1 = gam1
            if it > 1:
                gam1 = _clamp_gamma(1.0 / (1.0 / eta1 + l2diff / Mt))
                p2 = update_prior(state.r1, gam1, pr, m_mask, Mt,
                                  em_max_iter=cfg.em_max_iter,
                                  em_err_thr=cfg.em_err_thr,
                                  learn_vars=cfg.learn_vars)
                probs, vars_ = p2.probs, p2.vars
            i += 1
        rho = state.rho
        x1_d, alpha1_d = x1, alpha1
        if it > 1:  # damping; frozen coordinates keep the raw g1 output
            x1_d = torch.where(frz == 0, rho * x1 + (1 - rho) * state.x1, x1)
            alpha1_d = rho * alpha1 + (1 - rho) * state.alpha1
        return x1, x1_d, gam1, alpha1, alpha1_d, eta1, probs, vars_

    def cross_val(state: LinState, aux: Aux, it: int, x1, x1_raw, alpha1_raw):
        """The within-iteration re-damping on the held-out R2
        (``gvamp_tpu/linear.py:550-583``, vamp.cpp:356-409): while the
        held-out R2 of the damped x1 falls below the last accepted one,
        rho_cross shrinks by 0.9 and x1 is damped again against the
        previous iterate, up to ``cv_max_retry`` tries; alpha1 is then
        damped with the accepted rho_cross.  Iteration 1 accepts its first
        try; each later try reads its test on the host (one sync)."""
        hold = aux.hold
        rho_c, prev = state.rho, state.cv_r2
        for _ in range(cfg.cv_max_retry):
            z = hold_ax(hold.op, x1) * hold.rescale
            r2v = 1.0 - torch.square(hold.y - z).sum() / hold.denom
            if it == 1 or host_bool(r2v >= prev):
                prev = r2v
                break
            rho_c = rho_c * 0.9
            x1 = rho_c * x1_raw + (1 - rho_c) * state.x1
        alpha1 = (rho_c * alpha1_raw + (1 - rho_c) * state.alpha1 if it > 1
                  else alpha1_raw)
        return x1, alpha1, prev, rho_c

    def phase_denoise(w, state: LinState, aux: Aux):
        it = state.it + 1
        x1_raw, x1, gam1, alpha1_raw, alpha1, eta1, probs, vars_ = denoise(
            state, aux, it)
        if init_est and it == 1:
            x1 = state.r1  # first iteration keeps the injected estimate
        if cfg.use_cross_val:
            x1, alpha1, cv_r2, rho_cross = cross_val(state, aux, it, x1,
                                                     x1_raw, alpha1_raw)
            w.update(cv_r2=cv_r2, rho_cross=rho_cross)
        w.update(it=it, x1_prev=state.x1, x1=x1, gam1=gam1, alpha1=alpha1,
                 eta1=eta1, probs=probs, vars=vars_)
        return w

    def phase_project(w, state: LinState, aux: Aux):
        it, x1 = w["it"], w["x1"]
        gam1, alpha1, eta1 = w["gam1"], w["alpha1"], w["eta1"]
        probs, vars_ = w["probs"], w["vars"]
        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1 * x1 - gam1 * state.r1) / gam2) * aux.m_mask
        if cfg.use_lmmse_damp and it > 1:
            xi = torch.clamp(2.0 * state.rho, max=1.0)
            gam_before = state.gam2
            gam2 = torch.where(
                gam_before > 0,
                1.0 / torch.square(xi / torch.sqrt(gam2)
                                   + (1 - xi) / torch.sqrt(gam_before)),
                gam2)
        # adaptive rho (vamp.cpp:501-502); alpha2 from the previous iteration
        xi = torch.clamp(2.0 * torch.minimum(alpha1, state.alpha2), max=1.0)
        rho = torch.maximum(state.rho, xi)
        if cfg.auto_var_max_iter == 0 or it <= 1:
            p2 = update_prior(state.r1, gam1, Prior(probs, vars_), aux.m_mask,
                              Mt, em_max_iter=cfg.em_max_iter,
                              em_err_thr=cfg.em_err_thr,
                              learn_vars=cfg.learn_vars)
            probs, vars_ = p2.probs, p2.vars
        w.update(gam2=gam2, r2=r2, rho=rho, probs=probs, vars=vars_,
                 l2y=torch.square(aux.y).sum())
        return w

    def lmmse_dual(w, state: LinState, aux: Aux):
        """The dual / N-space solve (lmmse_denoiserAAT, denoiserXXT.cpp:31-50;
        ``gvamp_tpu/linear.py:648-728``):
        x2 = gamw A^T (gamw A A^T + gam2 I)^{-1} (y - A r2) + r2, with
        alpha2 = 1 - gamw <z_u, Q_N^{-1} z_u> (Woodbury) from the SLQ basis
        over A A^T, or from the probe columns z_u = A u riding the same
        N-space block CG.  gamma_damp's gam2_eff builds Q_N, as in the
        primal branch.  Returns the update of ``w``."""
        op, y, m_mask = aux.op, aux.y, aux.m_mask
        it, r2 = w["it"], w["r2"]
        gamw = state.gamw
        gam2_eff = w["gam2"] * cfg.gamma_damp
        nb4 = y.numel()
        # one wide pass: A r2 (the dual right-hand side) and A x1 (z1)
        Vr = axm_fn(op, torch.stack([r2, w["x1"]], dim=1))
        z_bern_f = aux.z_bern.reshape(nb4, P)
        V_n = torch.cat([(y - Vr[..., 0]).reshape(nb4, 1),
                         z_bern_f[:, :P_cg]], dim=1)
        mu0 = torch.cat([state.mu_cg_n.reshape(nb4, 1),
                         state.mu_probe_n.reshape(nb4, P_cg)], dim=1)

        def mult_aat_b(U):
            Up = U.reshape(4, nb4 // 4, U.shape[1])
            return (gamw * gram_aat(op, Up) + gam2_eff * Up).reshape(
                nb4, U.shape[1])

        diag_n = (gamw * aux.xxt_diag_base + gam2_eff).reshape(nb4)[:, None]
        r0 = None
        gmu_n = state.gmu_n
        if cfg.gram_refresh > 1:
            # state.gmu_n carries A A^T mu0 (exact at the previous exit)
            mu0, r0 = cg.tracked_warm_start(
                V_n, mu0, state.gmu_n.reshape(nb4, 1 + P_cg), gamw, gamw,
                gam2_eff, it, cfg.gram_refresh, mult_aat_b)
        sol = cg.solve_block(mult_aat_b, V_n, mu0, diag_n, gam2_eff,
                             cfg.cg_max_iter, modes=(0,) + (1,) * P_cg,
                             err_tol=cfg.cg_err_tol_xxt,
                             onsager_tol=cfg.onsager_tol,
                             plateau=cfg.cg_plateau, r0=r0)
        if cfg.gram_refresh > 1:
            gmu_n = cg.gram_from_exit(V_n, sol, gamw, gam2_eff).reshape(
                gmu_n.shape)
        s0 = sol.mu[:, 0]
        x2 = (gamw * atx_fn(op, s0.reshape(y.shape)) + r2) * m_mask
        if use_slq:
            alpha2 = (1.0 - gamw * slq.quad_inv(aux.slq, gamw, gam2_eff)
                      ).mean()
        else:
            alpha2 = (1.0 - gamw * (z_bern_f * sol.mu[:, 1:]).sum(dim=0)
                      ).mean()
        # A x2 = y - gam2 s0 - r_cg EXACTLY for the returned s0: the noise
        # update needs no pass, and its trace is Mt (1 - alpha2) / gamw
        ax2 = y - (gam2_eff * s0 + sol.r[:, 0]).reshape(y.shape)
        return dict(
            x2=x2, alpha2=alpha2, invq=state.mu_probe, mu_cg=state.mu_cg,
            mu_cg_n=s0.reshape(y.shape),
            mu_probe_n=sol.mu[:, 1:].reshape(y.shape + (P_cg,)),
            gmu_n=gmu_n, sol=sol, z1=Vr[..., 1],
            resid2=torch.square(ax2 - y).sum(),
            trace_corr=Mt * (1.0 - alpha2) / gamw)

    def lmmse_primal(w, state: LinState, aux: Aux):
        """The joint block solve (``gvamp_tpu/linear.py:730-853``): column
        0 the LMMSE right-hand side (residual exit, vamp.cpp:594-596), the
        rest the Onsager probes (quadform exit, vamp.cpp:871-889); under
        red on this iteration's window of the sample word rows."""
        op, m_mask, bern = aux.op, aux.m_mask, aux.bern
        it, gam2, r2 = w["it"], w["gam2"], w["r2"]
        gamw = state.gamw
        gam2_eff = gam2 * cfg.gamma_damp
        out = {}
        if cfg.red:
            # reduced-subset stochastic solves (vamp.cpp:561-596): this
            # iteration's window, drawn on the host
            sbw = (aux.red_sbw[it - 1] if aux.red_sbw is not None
                   else red_window_start(cfg.seed, geno.S, it, nw, red_lbw))
            y_w = aux.y[:, 4 * sbw:4 * (sbw + red_lbw)]
            v = (gamw * atxm_w(op, y_w[:, :, None], sbw)[:, 0]
                 + gam2_eff * r2)
            multb = cg.make_lmmse_mult_block(
                lambda o, X: axm_w(o, X, sbw),
                lambda o, V_: atxm_w(o, V_, sbw), op, gamw, gam2_eff)
            diag = cg.jacobi_diag(gamw, gam2_eff, 16.0 * red_lbw)
            out.update(red_sbw=sbw)
        else:
            v = gamw * aux.aty + gam2_eff * r2
            multb = cg.make_lmmse_mult_block(axm_fn, atxm_fn, op, gamw,
                                             gam2_eff, gram_fn=gram_fn)
            diag = cg.jacobi_diag(gamw, gam2_eff, N)
        # fold_noise: z1 = A x1 rides the first CG iteration's forward pass
        rider_mult = (cg.make_lmmse_mult_block_rider(axm_fn, atxm_fn, op,
                                                     gamw, gam2_eff)
                      if fold_noise else None)
        V = torch.cat([v[:, None], bern[:, :P_cg]], dim=1)
        mu_start = torch.cat([state.mu_cg[:, None], state.mu_probe], dim=1)
        mu0, r0 = mu_start, None
        if not cfg.red and cfg.gram_refresh > 1:
            gmu_c = state.gmu
            if cfg.cg_extrapolate:
                mu0, gmu_c = cg.extrapolate_pair(
                    V, mu0, state.gmu, state.mu_prevb, state.gmu_prev,
                    gamw, gam2_eff)
            mu0, r0 = cg.tracked_warm_start(V, mu0, gmu_c, gamw, gamw,
                                            gam2_eff, it, cfg.gram_refresh,
                                            multb)
        precond = None
        if aux.defl is not None:
            precond = cg.make_deflated_precond(aux.defl[0], aux.defl[1],
                                               gamw, gam2_eff, diag)
        sol = cg.solve_block(multb, V, mu0, diag, gam2_eff, cfg.cg_max_iter,
                             modes=(0,) + (1,) * P_cg, err_tol=cfg.cg_err_tol,
                             onsager_tol=cfg.onsager_tol,
                             plateau=cfg.cg_plateau, r0=r0, precond=precond,
                             rider=w["x1"][:, None] if fold_noise else None,
                             rider_mult=rider_mult)
        mu = sol.mu[:, 0]
        invq = sol.mu[:, 1:]
        if use_slq:
            # the noise-EM trace term Mt <u, G Q^{-1} u> as a quadrature of
            # f(lam) = lam / (gamw lam + gam2) on the fixed Gram's basis
            out.update(trace_corr=Mt * slq.quad_ratio(aux.slq, gamw,
                                                      gam2_eff).mean())
        if fold_noise:
            # exit Gram identity: gamw A^T A mu = V - r - gam2 mu, exact for
            # any mu, gives the noise-EM residual with no extra pass
            quad = ((mu * V[:, 0]).sum() - (mu * sol.r[:, 0]).sum()
                    - gam2_eff * torch.square(mu).sum()) / gamw
            out.update(resid2=torch.clamp(
                quad - 2.0 * (mu * aux.aty).sum() + w["l2y"], min=0.0),
                z1=sol.rider_out[..., 0])
            if not use_slq:
                # the Hutchinson term <u, A^T A q> from the same identity,
                # with the probe columns' residuals at their own exits
                tr = ((bern * bern).sum(dim=0)
                      - (bern * sol.r[:, 1:]).sum(dim=0)
                      - gam2_eff * (bern * invq).sum(dim=0)) / gamw
                out.update(trace_corr=Mt * tr.mean())
        if not cfg.red:
            # carry A^T A mu for the next iteration's init residual
            out.update(gmu=cg.gram_from_exit(V, sol, gamw, gam2_eff))
            if cfg.cg_extrapolate:
                # this iteration's start pair becomes the one-older member
                out.update(mu_prevb=mu_start, gmu_prev=state.gmu)
        if use_slq:
            alpha2 = gam2_eff * slq.quad_inv(aux.slq, gamw, gam2_eff).mean()
        else:
            alpha2 = gam2_eff * (bern * invq).sum(dim=0).mean()
        out.update(x2=mu * m_mask, alpha2=alpha2, invq=invq, mu_cg=mu,
                   sol=sol)
        return out

    def phase_lmmse(w, state: LinState, aux: Aux):
        """The solve, alpha2, then eta2, the gam2 re-estimate, gam1 and r1
        (vamp.cpp:556-693)."""
        w.update(lmmse_dual(w, state, aux) if cfg.use_xxt
                 else lmmse_primal(w, state, aux))
        m_mask, it, gam2, r2 = aux.m_mask, w["it"], w["gam2"], w["r2"]
        x2, alpha2 = w["x2"], w["alpha2"]
        eta2 = gam2 / alpha2
        if cfg.auto_var_max_iter >= 1 and it > 2:  # vamp.cpp:691-693
            l2_x2r2 = torch.square((x2 - r2) * m_mask).sum()
            gam2 = _clamp_gamma(1.0 / (1.0 / eta2 + l2_x2r2 / Mt))
        gam1_new = _clamp_gamma(eta2 - gam2)
        sol = w["sol"]
        w.update(eta2=eta2, gam2=gam2, gam1_new=gam1_new,
                 r1=((eta2 * x2 - gam2 * r2) / gam1_new) * m_mask,
                 cg_iters=sol.iters[0], cg_rel_err=sol.rel_err[0],
                 probe_iters=(sol.iters[1:].max() if P_cg else 0))
        return w

    def phase_noise(w, state: LinState, aux: Aux):
        """The noise precision EM update (updateNoisePrec,
        vamp.cpp:892-927): the dual solve and the folded primal one left
        |A x2 - y|^2 and the trace term in ``w``; otherwise one forward
        pass here."""
        op, y, x2, invq = aux.op, aux.y, w["x2"], w["invq"]
        if red_win:
            # full-data residual (vamp.cpp:897) and the windowed trace
            # <u, Aw^T Aw q> = <Aw u, Aw q> in one windowed pass over
            # [invq | bern] (vamp.cpp:907-916); z1 = A x1 rides the first
            Zf = axm_fn(op, torch.stack([x2, w["x1"]], dim=1))
            Zw = axm_w(op, torch.cat([invq, aux.bern], dim=1), w["red_sbw"])
            w.update(resid2=torch.square(Zf[..., 0] - y).sum(), z1=Zf[..., 1],
                     trace_corr=Mt * (Zw[..., :P] * Zw[..., P:]).sum(
                         dim=(0, 1)).mean())
        elif "resid2" not in w:
            # the explicit noise pass (linear.py:911-926): one wide forward
            # pass computes A x2, A invq and the deferred z1 = A x1, and
            # the trace term <u, A^T A q> = <A u, A q> with A u from set-up
            Z2 = axm_fn(op, torch.cat([x2[:, None], invq, w["x1"][:, None]],
                                      dim=1))
            w.update(resid2=torch.square(Z2[..., 0] - y).sum(), z1=Z2[..., -1])
            if not use_slq:
                w.update(trace_corr=Mt * (aux.z_bern * Z2[..., 1:-1]).sum(
                    dim=(0, 1)).mean())
        w.update(gamw_new=N / (w["resid2"] + w["trace_corr"]))
        return w

    def phase_finish(w, state: LinState, aux: Aux):
        it, x1, x1_prev = w["it"], w["x1"], w["x1_prev"]
        y, l2y = aux.y, w["l2y"]
        metrics = {
            "it": it, "gam1": w["gam1"], "gam2": w["gam2"],
            "gamw": w["gamw_new"], "eta1": w["eta1"], "eta2": w["eta2"],
            "alpha1": w["alpha1"], "alpha2": w["alpha2"], "rho": w["rho"],
            "R2_train_1": 1.0 - torch.square(y - w["z1"]).sum() / l2y,
            "R2_train_2": 1.0 - w["resid2"] / l2y,
            # stopping criterion (vamp.cpp:741-749)
            "rel_change": torch.sqrt(
                torch.square(x1_prev - x1).sum()
                / torch.clamp(torch.square(x1_prev).sum(), min=1e-300)),
            "cg_iters": w["cg_iters"], "cg_rel_err": w["cg_rel_err"],
            "probe_iters": w["probe_iters"],
            "probs": w["probs"], "vars": w["vars"],
        }
        if red_win:
            metrics["red_sbw"] = w["red_sbw"]
        if cfg.use_cross_val:
            metrics["cv_r2"] = w["cv_r2"]
            metrics["rho_cross"] = w["rho_cross"]
        if with_truth:
            ts, sqn = aux.ts, math.sqrt(N)

            def diag_for(xh, rv):
                corr = (xh * ts).sum() / torch.sqrt(
                    torch.square(xh).sum() * torch.square(ts).sum())
                l2sig = torch.sqrt(torch.square(xh / sqn - ts).sum()
                                   / torch.square(ts).sum())
                return corr, l2sig, Mt / torch.square(rv - sqn * ts).sum()

            (metrics["corr_x1"], metrics["l2_sig_err1"],
             metrics["true_gam2"]) = diag_for(x1, w["r2"])
            (metrics["corr_x2"], metrics["l2_sig_err2"],
             metrics["true_gam1"]) = diag_for(w["x2"], w["r1"])
        new_state = state._replace(
            it=it, x1=x1, x2=w["x2"], r1=w["r1"], r2=w["r2"], z1=w["z1"],
            mu_cg=w["mu_cg"], mu_cg_n=w.get("mu_cg_n", state.mu_cg_n),
            mu_probe=w["invq"],
            mu_probe_n=w.get("mu_probe_n", state.mu_probe_n),
            gam1=w["gam1_new"], gam2=w["gam2"], gamw=w["gamw_new"],
            eta1=w["eta1"], eta2=w["eta2"], alpha1=w["alpha1"],
            alpha2=w["alpha2"], rho=w["rho"], probs=w["probs"],
            vars=w["vars"], cv_r2=w.get("cv_r2", state.cv_r2),
            gmu=w.get("gmu", state.gmu),
            gmu_n=w.get("gmu_n", state.gmu_n),
            mu_prevb=w.get("mu_prevb", state.mu_prevb),
            gmu_prev=w.get("gmu_prev", state.gmu_prev))
        return new_state, metrics

    phases = (("denoise", phase_denoise), ("z1_project", phase_project),
              ("lmmse_cg", phase_lmmse), ("noise_em", phase_noise),
              ("finish", phase_finish))
    return make_phase_step(phases, timer_device)


def make_phase_step(phases, timer_device=None):
    """Compose (name, phase) pairs into a step (state, aux, w=None) ->
    (state, metrics); ``w`` seeds the phases' carry (the Huber draws).
    Each phase is a span of its name under a profiler.  With
    ``timer_device`` each phase is timed between two synchronises of a card
    (``trace.timed``) into ``phase_ms_<name>`` (``timed_step_from_phases``,
    ``gvamp_tpu/linear.py:1061-1094``); the phases and their order are the
    same, so a timed step gives the untimed one's numbers bit for bit."""

    def step(state, aux, w=None):
        out = {} if w is None else dict(w)
        times = {}
        for name, fn in phases:
            if timer_device is None:
                with trace.span(name):
                    out = fn(out, state, aux)
            else:
                with trace.timed(name, timer_device) as t:
                    out = fn(out, state, aux)
                times[name] = t.ms
        new_state, metrics = out
        for name, ms in times.items():
            metrics[f"phase_ms_{name}"] = ms
        return new_state, metrics

    return step


@trace.spanned("fetch")
def fetch_metrics(metrics_list: list) -> list:
    """Every tensor metric of several steps to the host in one transfer
    (one counted sync); ``cg_iters`` and ``probe_iters`` as ints (int
    arrays over the traits of a multi-trait step) and ``stopped`` as
    bools."""
    refs = [(i, k) for i, m in enumerate(metrics_list)
            for k, v in m.items() if isinstance(v, torch.Tensor)]
    vals = host_values([metrics_list[i][k] for i, k in refs]) if refs else []
    out = [dict(m) for m in metrics_list]
    for (i, k), v in zip(refs, vals):
        if k in ("cg_iters", "probe_iters"):
            v = int(v) if v.ndim == 0 else v.astype(np.int64)
        out[i][k] = v.astype(bool) if k == "stopped" else v
    return out


def run_chunks(step, state, aux, max_iter: int, chunk: int = 1,
               draws=None):
    """The driver loop of every engine (``dispatch_chunk`` and the chunked
    loops of ``gvamp_tpu/linear.py:1046-1058, 1153-1187``): chunks of
    ``chunk`` eager steps whose metrics reach the host in one transfer at
    the chunk's end; where less than a chunk of the budget is left, single
    steps, so that the state stops exactly at ``max_iter``.  ``draws``
    feeds each step its Huber draws.  Yields (state, [metrics of each
    step]) per chunk, for the caller's callbacks and stopping test; each
    entry holds ``host_syncs`` (its step's, the chunk's fetch counted on
    the last).  Under a profiler each step is an ``iteration`` span (``it``:
    the iteration it makes) and each fetch a ``fetch`` span."""
    chunk = max(1, int(chunk))
    while state.it < max_iter:
        k = chunk if max_iter - state.it >= chunk else 1
        raw, syncs = [], []
        for _ in range(k):
            s0 = SYNCS["count"]
            with trace.span("iteration", it=state.it + 1):
                if draws is None:
                    state, metrics = step(state, aux)
                else:
                    state, metrics = step(state, aux, next(draws))
            raw.append(metrics)
            syncs.append(SYNCS["count"] - s0)
        s0 = SYNCS["count"]
        ms = fetch_metrics(raw)
        syncs[-1] += SYNCS["count"] - s0
        for m, s in zip(ms, syncs):
            m["host_syncs"] = s
        yield state, ms


def print_phase_ms(m: dict) -> None:
    """The per-phase wall clock line of a timed step (vamp.cpp:752-755)."""
    pk = [k for k in m if k.startswith("phase_ms_")]
    if pk:
        print("        " + "  ".join(
            f"{k[len('phase_ms_'):]}={float(m[k]):.1f}ms" for k in pk),
            flush=True)


@trace.spanned("infer", engine="linear")
def infer(geno, cfg: VampConfig, probs, vars_user, true_signal=None,
          freeze=None, callbacks=None, r1_init=None, x1_init=None, gam1=None,
          gamw=None, verbose: bool = True, sync_every: int = 1,
          phase_timers: bool = False, resume_state: LinState = None,
          bern=None, defl_v0=None, red_sbw=None):
    """Run the linear VAMP loop; returns (x1_hat_stored, state, history).

    ``x1_hat_stored`` is the /sqrt(N)-scaled estimate of the reference's
    per-iteration .bin dumps (vamp.cpp:802).  ``sync_every`` > 1 runs
    chunks of that many iterations between metrics fetches; the callbacks
    and the stopping test run once per chunk (``run_chunks``).
    ``phase_timers`` times each phase into ``phase_ms_*`` and overrides
    ``sync_every``.  Each history entry also holds ``host_syncs`` (device
    values read on the host, the metrics fetch included).  ``bern``, ``defl_v0`` and ``red_sbw`` replace the drawn
    probe, deflation start block and window starts (entry it - 1 for
    iteration it; parity tests pass JAX's).

    With ``cfg.use_cross_val`` the first 98% of the sample bytes train and
    the rest are held out for the damping tuner (SB_cross = 0.98 mbytes,
    vamp.cpp:158-166): the engine, the callbacks and the returned scale see
    the training window (``GenoBed.sample_window``)."""
    geno_hold = None
    if cfg.use_cross_val:
        sb_cross = int(0.98 * geno.layout.mbytes)
        geno_hold = geno.sample_window(sb_cross,
                                       geno.layout.mbytes - sb_cross)
        geno = geno.sample_window(0, sb_cross)
    if resume_state is not None:
        _check_resume_probe_cols(resume_state, cfg)
    state = resume_state if resume_state is not None else init_state(
        geno, cfg, probs, vars_user, r1_init=r1_init, x1_init=x1_init,
        gam1=gam1, gamw=gamw)
    aux = make_aux(geno, cfg, freeze=freeze, true_signal=true_signal,
                   bern=bern, defl_v0=defl_v0, red_sbw=red_sbw,
                   geno_hold=geno_hold)
    step = make_step(geno, cfg, init_est=x1_init is not None,
                     with_truth=true_signal is not None,
                     timer_device=geno.device if phase_timers else None,
                     geno_hold=geno_hold)
    history = []
    chunk = 1 if phase_timers else sync_every
    for state, ms in run_chunks(step, state, aux, cfg.max_iter, chunk):
        for m in ms:
            history.append(m)
            if verbose:
                print(f"[it {m['it']}] gam1={m['gam1']:.6g} "
                      f"gam2={m['gam2']:.6g} gamw={m['gamw']:.6g} "
                      f"alpha1={m['alpha1']:.4g} alpha2={m['alpha2']:.4g} "
                      f"R2={m['R2_train_1']:.4f} rel={m['rel_change']:.3e} "
                      f"cg={int(m['cg_iters'])}", flush=True)
                print_phase_ms(m)
        for cb in callbacks or ():
            cb(state.it, state, ms[-1], geno)
        if state.it > 1 and float(ms[-1]["rel_change"]) < cfg.stop_criteria_thr:
            if verbose:
                print(f"VAMP stopping criterion met "
                      f"(thr={cfg.stop_criteria_thr})")
            break
    sqn = float(np.sqrt(geno.N))
    return state.x1[: geno.M].cpu().numpy() / sqn, state, history


def state_evolution_from_draws(beta, beta_b, e, e_b, prior: Prior, gam1,
                               rho, prior_before: Prior, gam1_before):
    """State-evolution prediction (alpha1_bar, eta1_bar, gam2_bar) from
    given draws: ``beta`` from the current prior, ``beta_b`` from the one
    before, ``e`` and ``e_b`` standard normals, all [n_mc]
    (``gvamp_tpu/linear.py:1193-1219``, the reference's dormant
    ``state_evo`` ind=1, vamp.cpp:1376-1401).  The noisy observations are
    beta + e / sqrt(gam1) and beta_b + e_b / sqrt(gam1_before); the damped
    denoiser derivative is averaged over them."""
    noise = e / math.sqrt(gam1)
    noise_b = e_b / math.sqrt(gam1_before)
    d = (rho * g1d(beta + noise, gam1, prior)
         + (1 - rho) * g1d(beta_b + noise_b, gam1_before, prior))
    alpha_bar = d.mean()
    eta_bar = gam1 / alpha_bar
    return alpha_bar, eta_bar, eta_bar - gam1


def state_evolution_draws(seed: int, it: int, prior: Prior,
                          prior_before: Prior, n_mc: int):
    """The four draws of ``state_evolution_from_draws`` from a CPU
    generator seeded by (seed + 11, it), in float64, on the priors' device
    and in their dtype.  JAX draws them from ``fold_in(key(seed + 11),
    it)``, a stream torch cannot reproduce: parity tests pass JAX's draws
    to ``state_evolution_from_draws``."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed((((seed + 11) & 0xFFFFFFFF) << 32) | (it & 0xFFFFFFFF))

    def mix(pr):
        probs = pr.probs.detach().cpu().to(torch.float64)
        comp = torch.multinomial(probs, n_mc, replacement=True, generator=gen)
        z = torch.randn(n_mc, generator=gen, dtype=torch.float64)
        return z * torch.sqrt(pr.vars.detach().cpu().to(torch.float64)[comp])

    beta, beta_b = mix(prior), mix(prior_before)
    e = torch.randn(n_mc, generator=gen, dtype=torch.float64)
    e_b = torch.randn(n_mc, generator=gen, dtype=torch.float64)
    return tuple(v.to(device=prior.probs.device, dtype=prior.probs.dtype)
                 for v in (beta, beta_b, e, e_b))


def state_evolution(seed: int, it: int, prior: Prior, gam1, rho,
                    prior_before: Prior, gam1_before, mt: int,
                    n_mc: Optional[int] = None):
    """State-evolution prediction of (alpha1_bar, eta1_bar, gam2_bar) at
    iteration ``it`` from Mt (or ``n_mc``) Monte-Carlo draws
    (``state_evolution_draws``)."""
    draws = state_evolution_draws(seed, it, prior, prior_before, n_mc or mt)
    return state_evolution_from_draws(*draws, prior, gam1, rho, prior_before,
                                      gam1_before)
