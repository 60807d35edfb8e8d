"""Huber-loss robust VAMP (heavy-tailed noise).

Port of ``gvamp_tpu/robust.py`` (reference ``infere_robust``,
vamp_Huber.cpp:24-441): the probit engine's skeleton with the closed-form
Huber proximal as the z-denoiser (vamp_Huber.cpp:443-503) and the Huber
threshold ``deltaH`` learned every iteration by Monte-Carlo EM over a
fixed grid (vamp_Huber.cpp:522-586).  One iteration runs four phases, as
JAX's:

  denoise_x       the re-estimation loop x1 = g1(r1, gam1) with the EM
                  prior update, damping, gam2 and r2;
  denoise_z       z1 = g1_huber(p1), beta1 (the reference's sign-mixed
                  derivative), tau1, deltaH, p2, tau2;
  lmmse_cg        the warm-started block CG on (tau2 A^T A + gam2 I),
                  deflated when ``deflate_k > 0``, with the SLQ Onsager
                  term or probe columns riding the solve
                  (``use_slq=False``); z2 = A x2 tracked through the CG
                  recursion on the
                  two-pass route, or one forward pass after the solve when
                  the fused Gram runs it;
  lmmse_z_finish  beta2, tau2, p1 and tau1 from z2.

The engine runs eagerly; each loop exit or branch on a device value is a
counted host sync (``gvamp_tpu_torch.sync``).  The Monte-Carlo draws of
``em_deltaH`` come from a CPU ``torch.Generator`` carried in the state
(seeded ``cfg.seed + 2``; jax.random cannot be reproduced) and move to the
device; parity tests pass JAX's draws in through ``infer(mc_draws=...)``.
The driver, ``sync_every`` and ``phase_timers`` are the linear engine's
(``linear.run_chunks``, ``linear.make_phase_step``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gvamp_tpu_torch import cg, slq, trace
from gvamp_tpu_torch.linear import (VampConfig, _check_resume_probe_cols,
                                    _clamp_gamma, make_bern_probe,
                                    make_deflation, make_phase_step,
                                    print_phase_ms, probe_cols, run_chunks,
                                    slq_on)
from gvamp_tpu_torch.prior import GAMMA_MIN, Prior, g1, g1d, update_prior
from gvamp_tpu_torch.probit import geo_damp, make_slq_basis
from gvamp_tpu_torch.sync import host_bool

# deltaH M-step grid (vamp_Huber.cpp:259)
DELTA_GRID = np.array([1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1,
                       0.2, 0.4, 0.6, 0.8, 1.0, 1.5, 2.0, 3.0])


# --------------------------------------------------------------------------
# Huber proximal denoisers (vamp_Huber.cpp:443-503)
# --------------------------------------------------------------------------


def g1_huber(p1, tau1, delta, y):
    """Posterior-mode z under Huber loss: y - prox_{var*huber}(y - p1)."""
    var = 1.0 / tau1
    thr = (1.0 + var) * delta
    w = y - p1
    est = torch.where(torch.abs(w) <= thr, w / (1.0 + var),
                      torch.where(w > thr, w - var * delta, w + var * delta))
    return y - est


def g1d_huber(p1, tau1, delta, y):
    """g1_huber - p1 in prox form, branched on |w| (Bradic-Chen Ex. 2;
    ``gvamp_tpu/robust.py:46-59``)."""
    var = 1.0 / tau1
    thr = (1.0 + var) * delta
    w = y - p1
    return torch.where(torch.abs(w) <= thr, -var * w / (1.0 + var),
                       torch.where(w > thr, -var * delta, var * delta))


def g1d_huber_der(p1, tau1, delta, y):
    """The beta1 "derivative" exactly as the reference computes it
    (vamp_Huber.cpp:485-503): branched on |p1|, with -1 on the lower tail.
    It is not the prox derivative, but the reference's published dynamics
    depend on it (``gvamp_tpu/robust.py:62-81`` says why); the
    (|p1| > thr, |w| <= thr) case the reference leaves uninitialised takes
    the lower-tail value."""
    var = 1.0 / tau1
    thr = (1.0 + var) * delta
    w = y - p1
    one = torch.ones_like(w)
    return torch.where(torch.abs(p1) <= thr, 1.0 / (1.0 + var),
                       torch.where(w > thr, one, -one))


def huber_loss(z, delta, y):
    w = y - z
    aw = torch.abs(w)
    return torch.where(aw <= delta, w * w / 2.0, delta * (aw - delta / 2.0))


def em_deltaH(eps, p1, tau1, y, n_mask, grid=DELTA_GRID):
    """MC grid search for deltaH (vamp_Huber.cpp:522-586;
    ``gvamp_tpu/robust.py:90-113``): the grid point minimising
    E_{z ~ N(p1, 1/tau1)}[huber_delta(z, y)] over the real samples, the
    expectation over the draws ``eps`` [mc, N].  One E+M step is the
    reference's EM loop (its E-step does not depend on delta).  The grid
    objective is evaluated one point at a time, so that no [grid, mc, N]
    tensor is formed.  Returns a device scalar (no host sync)."""
    num_mc = eps.shape[0]
    n = n_mask.sum()
    z = p1[None, :] + eps / torch.sqrt(tau1)
    yb, mb = y[None, :], n_mask[None, :]
    gridt = torch.as_tensor(grid, dtype=p1.dtype, device=p1.device)
    losses = torch.stack([(huber_loss(z, d, yb) * mb).sum() / (num_mc * n)
                          for d in gridt])
    return gridt[torch.argmin(losses)]


# --------------------------------------------------------------------------
# the robust VAMP loop (vamp_Huber.cpp:24-441)
# --------------------------------------------------------------------------


class RobustState(NamedTuple):
    """The fields of ``gvamp_tpu.robust.RobustState`` with the JAX key
    replaced by ``gen``, the CPU generator of the Monte-Carlo draws (a step
    draws from a copy and returns it, so an earlier state keeps its
    generator); ``it`` is a host int."""

    it: int
    x1: torch.Tensor
    x2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    z1: torch.Tensor        # planar [4, Nb]
    z2: torch.Tensor        # A x2 planar [4, Nb]
    p1: torch.Tensor
    p2: torch.Tensor
    gam1: torch.Tensor
    gam2: torch.Tensor
    tau1: torch.Tensor
    tau2: torch.Tensor
    alpha1: torch.Tensor
    deltaH: torch.Tensor
    probs: torch.Tensor
    vars: torch.Tensor
    gen: torch.Generator    # em_deltaH's draws
    mu_cg: torch.Tensor     # [Mpad] CG warm start
    mu_probe: torch.Tensor  # [Mpad, P] (P = 0 under SLQ)
    gmu: torch.Tensor       # A^T A [mu_cg | mu_probe], tracked
    tau_gmu: torch.Tensor   # the tau2 gmu was stored at


@dataclasses.dataclass(frozen=True)
class RobustConfig(VampConfig):
    """``gvamp_tpu.robust.RobustConfig``: the linear fields plus the Huber
    ones."""

    gam1_init: float = 1e-8
    auto_var_max_iter: int = 50   # vamp_Huber.cpp:92
    deltaH_init: float = 1e-3     # vamp_Huber.cpp:57
    mc_steps: int = 100


class RobustAux(NamedTuple):
    op: object               # data.BedOp
    y: torch.Tensor          # filtered planar [4, Nb]
    n_mask: torch.Tensor     # planar real-individual mask
    bern: torch.Tensor       # Onsager probes [Mpad, P]
    m_mask: torch.Tensor
    ts: torch.Tensor         # true signal * sqrt(N) (zeros if absent)
    defl: Optional[tuple]    # (V, lam): deflation basis (deflate_k > 0)
    slq: Optional[slq.SlqBasis]  # quadrature of the fixed Gram A^T A, one
                                 # basis for Huber's whole tau2 trajectory;
                                 # None on the probe path


def make_generator(seed: int) -> torch.Generator:
    """em_deltaH's CPU generator, seeded ``seed`` (the engine's
    ``cfg.seed + 2``, as JAX keys its draws, ``robust.py:182``)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    return gen


def init_state(geno, cfg: RobustConfig, probs, vars_user) -> RobustState:
    dt, dev, Mp = geno.dtype, geno.device, geno.Mpad
    nb4 = tuple(geno.y_planar.shape)
    P = probe_cols(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def scalar(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    return RobustState(
        it=0, x1=zeros(Mp), x2=zeros(Mp), r1=zeros(Mp), r2=zeros(Mp),
        z1=zeros(*nb4), z2=zeros(*nb4), p1=zeros(*nb4), p2=zeros(*nb4),
        gam1=scalar(cfg.gam1_init), gam2=scalar(0.0),
        tau1=scalar(cfg.gam1_init), tau2=scalar(0.0), alpha1=scalar(0.0),
        deltaH=scalar(cfg.deltaH_init), probs=scalar(probs),
        vars=scalar(np.asarray(vars_user) * geno.N),
        gen=make_generator(cfg.seed + 2), mu_cg=zeros(Mp),
        mu_probe=zeros(Mp, P), gmu=zeros(Mp, 1 + P), tau_gmu=scalar(0.0))


def make_aux(geno, cfg: RobustConfig, true_signal=None, bern=None,
             defl_v0=None) -> RobustAux:
    """Set-up: the deflation basis (``deflate_k > 0``), the probe and,
    unless the probe columns carry the trace (``use_slq=False`` or
    ``red``), the SLQ basis; ``bern`` and ``defl_v0`` replace the drawn
    probe and deflation start block."""
    defl = make_deflation(geno, cfg, defl_v0)
    if bern is None:
        bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    else:
        bern = torch.tensor(np.asarray(bern), dtype=geno.dtype,
                            device=geno.device)
    return RobustAux(
        op=geno.op, y=geno.filter_pheno(), n_mask=geno.n_mask_planar,
        bern=bern, m_mask=geno.m_mask,
        ts=(geno.pad_m(true_signal) * math.sqrt(geno.N)
            if true_signal is not None else torch.zeros_like(geno.m_mask)),
        defl=defl,
        slq=make_slq_basis(geno, cfg, bern) if slq_on(cfg) else None)


def make_step(geno, cfg: RobustConfig, with_truth: bool = False,
              timer_device=None):
    """The per-iteration Huber step: (state, aux, eps=None) -> (state,
    metrics); ``eps`` [mc, 4 Nb] replaces the draws from ``state.gen``.
    Its phases are timed with ``timer_device`` (``linear.make_phase_step``)."""
    Mt = float(geno.Mt)
    N = float(geno.N)
    ax_fn, atx_fn = geno.fns()
    axm_fn, atxm_fn = geno.fns_multi()
    gram_fn = geno.fn_gram()
    # z2 = A x2 tracked through the CG recursion on the two-pass route; the
    # fused Gram never forms A p, so it takes the explicit forward pass
    track_z2 = (cfg.fold_noise and gram_fn is None
                and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    P_cg = probe_cols(cfg)
    use_slq = slq_on(cfg)

    def phase_denoise_x(w, state: RobustState, aux: RobustAux):
        # the re-estimation loop (vamp_Huber.cpp:94-131); its test reads
        # gam1 on the host
        m_mask = aux.m_mask
        it = state.it + 1
        x1, gam1, alpha1 = state.x1, state.gam1, state.alpha1
        eta1 = torch.zeros_like(gam1)
        probs, vars_ = state.probs, state.vars
        prev = None
        i = 0
        while i < cfg.auto_var_max_iter:
            if i > 0 and not (it > 1 and host_bool(
                    torch.abs(gam1 - prev) >= cfg.revar_tol)):
                break
            pr = Prior(probs=probs, vars=vars_)
            x1 = g1(state.r1, gam1, pr) * m_mask
            alpha1 = (g1d(state.r1, gam1, pr) * m_mask).sum() / Mt
            eta1 = gam1 / alpha1
            l2diff = torch.square((x1 - state.r1) * m_mask).sum()
            prev = gam1
            if it > 1:
                gam1 = _clamp_gamma(1.0 / (1.0 / eta1 + l2diff / Mt))
                p2 = update_prior(state.r1, gam1, pr, m_mask, Mt,
                                  em_max_iter=cfg.em_max_iter,
                                  em_err_thr=cfg.em_err_thr,
                                  learn_vars=cfg.learn_vars)
                probs, vars_ = p2.probs, p2.vars
            i += 1
        if it > 1:
            rho = torch.as_tensor(cfg.rho, dtype=x1.dtype, device=x1.device)
            x1 = rho * x1 + (1 - rho) * state.x1
            alpha1 = rho * alpha1 + (1 - rho) * state.alpha1
        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1 * x1 - gam1 * state.r1) / gam2) * m_mask
        w.update(it=it, x1_prev=state.x1, x1=x1, gam1=gam1, alpha1=alpha1,
                 eta1=eta1, probs=probs, vars=vars_, gam2=gam2, r2=r2)
        return w

    def phase_denoise_z(w, state: RobustState, aux: RobustAux):
        # the Huber proximal (vamp_Huber.cpp:225-262)
        yf = aux.y.reshape(-1)
        nm = aux.n_mask.reshape(-1)
        p1f = state.p1.reshape(-1)
        tau1, delta = state.tau1, state.deltaH
        z1f = g1_huber(p1f, tau1, delta, yf) * nm
        beta1 = (g1d_huber_der(p1f, tau1, delta, yf) * nm).sum() / N
        zeta1 = tau1 / beta1
        l2zp = (torch.square(z1f - p1f) * nm).sum()
        if w["it"] >= 2:
            tau1 = _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N))
        # deltaH MC-EM grid update (vamp_Huber.cpp:259-260)
        gen, eps = state.gen, w.get("eps")
        if eps is None:
            gen = torch.Generator(device="cpu")
            gen.set_state(state.gen.get_state())
            eps = torch.randn((cfg.mc_steps, p1f.numel()), generator=gen,
                              dtype=p1f.dtype)
        elif not isinstance(eps, torch.Tensor):
            eps = torch.tensor(np.asarray(eps), dtype=p1f.dtype)
        eps = eps.to(dtype=p1f.dtype, device=p1f.device)
        delta = em_deltaH(eps, p1f, tau1, yf, nm)
        p2f = ((z1f - beta1 * p1f) / (1.0 - beta1)) * nm
        w.update(z1f=z1f, beta1=beta1, tau1=tau1, delta=delta, gen=gen,
                 p2f=p2f, tau2=_clamp_gamma(tau1 * (1.0 - beta1) / beta1))
        return w

    def phase_lmmse_x(w, state: RobustState, aux: RobustAux):
        # vamp_Huber.cpp:297-330
        op, m_mask = aux.op, aux.m_mask
        it, gam2, r2 = w["it"], w["gam2"], w["r2"]
        p2f, tau2 = w["p2f"], w["tau2"]
        v = tau2 * atx_fn(op, p2f.reshape(state.p2.shape)) + gam2 * r2
        multb = cg.make_lmmse_mult_block(axm_fn, atxm_fn, op, tau2, gam2,
                                         gram_fn=gram_fn)
        diag = cg.jacobi_diag(tau2, gam2, N)
        V = torch.cat([v[:, None], aux.bern[:, :P_cg]], dim=1)
        precond = None
        if aux.defl is not None:
            precond = cg.make_deflated_precond(aux.defl[0], aux.defl[1],
                                               tau2, gam2, diag)
        fwd_mult = (cg.make_lmmse_mult_block_fwd(axm_fn, atxm_fn, op, tau2,
                                                 gam2) if track_z2 else None)
        kw = dict(modes=(0,) + (1,) * P_cg, err_tol=cfg.cg_err_tol,
                  onsager_tol=cfg.onsager_tol, plateau=cfg.cg_plateau,
                  fwd_mult=fwd_mult, precond=precond)
        if cfg.gram_refresh > 1:
            # warm start with the tracked Gram product (the reference
            # zero-starts here, vamp_Huber.cpp:313)
            mu0_raw = torch.cat([state.mu_cg[:, None], state.mu_probe], dim=1)
            if track_z2:
                mu0, r0, zmu0 = cg.tracked_warm_start_fwd(
                    V, mu0_raw, state.gmu, state.z2, tau2, state.tau_gmu,
                    gam2, it, cfg.gram_refresh, fwd_mult)
            else:
                mu0, r0 = cg.tracked_warm_start(
                    V, mu0_raw, state.gmu, tau2, state.tau_gmu, gam2, it,
                    cfg.gram_refresh, multb)
                zmu0 = None
            sol = cg.solve_block(multb, V, mu0, diag, gam2, cfg.cg_max_iter,
                                 r0=r0, zmu0=zmu0, **kw)
            gmu_new = cg.gram_from_exit(V, sol, tau2, gam2)
        else:
            sol = cg.solve_block(multb, V, torch.zeros_like(V), diag, gam2,
                                 cfg.cg_max_iter, start_zero=True,
                                 zmu0=(torch.zeros_like(state.z2)
                                       if track_z2 else None), **kw)
            gmu_new = torch.zeros_like(sol.mu)
        x2 = sol.mu[:, 0] * m_mask
        # SLQ quadrature of f(lam) = 1/(tau2 lam + gam2) on the fixed Gram
        # basis or the probe columns' Hutchinson estimate, clipped into
        # (0, 1) at a bound the dtype can represent (robust.py:368-383): an
        # f32 alpha2 of 1 NaNs gam1 and r1
        if use_slq:
            alpha2 = gam2 * slq.quad_inv(aux.slq, tau2, gam2).mean()
        else:
            alpha2 = gam2 * (aux.bern * sol.mu[:, 1:]).sum(dim=0).mean()
        eps1 = 100.0 * torch.finfo(alpha2.dtype).eps
        alpha2 = torch.clamp(alpha2, GAMMA_MIN, 1.0 - eps1)
        eta2 = gam2 / alpha2
        if it > 1:
            l2x2r2 = torch.square((x2 - r2) * m_mask).sum()
            gam2 = _clamp_gamma(1.0 / (1.0 / eta2 + l2x2r2 / Mt))
        r1 = ((x2 - alpha2 * r2) / (1.0 - alpha2)) * m_mask
        gam1_new = gam2 * (1.0 - alpha2) / alpha2
        if cfg.stab_gamma < 1.0:
            gam1_new = geo_damp(gam1_new, state.gam1, cfg.stab_gamma, it > 1)
        w.update(x2=x2, alpha2=alpha2, gam2=gam2, r1=r1, gam1_new=gam1_new,
                 cg_iters=sol.iters[0], mu_cg=sol.mu[:, 0],
                 mu_probe=sol.mu[:, 1:], gmu=gmu_new, tau_gmu=tau2,
                 z2=sol.zmu if track_z2 else None)
        return w

    def phase_lmmse_z(w, state: RobustState, aux: RobustAux):
        # vamp_Huber.cpp:368-412
        nm = aux.n_mask.reshape(-1)
        it, x1 = w["it"], w["x1"]
        p2f, tau2, alpha2 = w["p2f"], w["tau2"], w["alpha2"]
        z2 = w["z2"] if w["z2"] is not None else ax_fn(aux.op, w["x2"])
        z2f = z2.reshape(-1)
        beta2 = Mt / N * (1.0 - alpha2)
        zeta2 = tau2 / beta2
        l2z2p2 = (torch.square(z2f - p2f) * nm).sum()
        if it > 1:
            tau2 = 1.0 / (1.0 / zeta2 + l2z2p2 / N)
        p1_new = ((z2f - beta2 * p2f) / (1.0 - beta2)) * nm
        tau1_new = _clamp_gamma(tau2 * (1.0 - beta2) / beta2)
        if cfg.stab_gamma < 1.0:
            tau1_new = geo_damp(tau1_new, state.tau1, cfg.stab_gamma, it > 1)
        x1_prev = w["x1_prev"]
        metrics = {
            "it": it, "gam1": w["gam1_new"], "gam2": w["gam2"],
            "tau1": tau1_new, "tau2": tau2, "alpha1": w["alpha1"],
            "alpha2": alpha2, "beta1": w["beta1"], "deltaH": w["delta"],
            "rel_change": torch.sqrt(
                torch.square(x1_prev - x1).sum()
                / torch.clamp(torch.square(x1_prev).sum(), min=1e-30)),
            "cg_iters": w["cg_iters"], "probs": w["probs"],
            "vars": w["vars"],
        }
        if with_truth:
            ts = aux.ts
            metrics["corr_x1"] = (x1 * ts).sum() / torch.sqrt(
                torch.square(x1).sum() * torch.square(ts).sum())
        shape = state.p2.shape
        new_state = RobustState(
            it=it, x1=x1, x2=w["x2"], r1=w["r1"], r2=w["r2"],
            z1=w["z1f"].reshape(shape), z2=z2, p1=p1_new.reshape(shape),
            p2=p2f.reshape(shape), gam1=w["gam1_new"], gam2=w["gam2"],
            tau1=tau1_new, tau2=tau2, alpha1=w["alpha1"], deltaH=w["delta"],
            probs=w["probs"], vars=w["vars"], gen=w["gen"],
            mu_cg=w["mu_cg"], mu_probe=w["mu_probe"], gmu=w["gmu"],
            tau_gmu=w["tau_gmu"])
        return new_state, metrics

    composed = make_phase_step(
        (("denoise_x", phase_denoise_x), ("denoise_z", phase_denoise_z),
         ("lmmse_cg", phase_lmmse_x), ("lmmse_z_finish", phase_lmmse_z)),
        timer_device)

    def step(state: RobustState, aux: RobustAux, eps=None):
        return composed(state, aux, {"eps": eps})

    return step


@trace.spanned("infer", engine="robust")
def infer(geno, cfg: RobustConfig, probs, vars_user, true_signal=None,
          verbose: bool = True, callbacks=None, phase_timers: bool = False,
          sync_every: int = 1, resume_state: RobustState = None, bern=None,
          defl_v0=None, mc_draws=None):
    """Run the Huber VAMP loop; returns (x1_hat_stored /sqrt(N), state,
    history).  ``sync_every``, ``phase_timers`` and the history's
    ``host_syncs`` are the linear engine's (``linear.infer``).  ``bern`` and ``defl_v0`` replace the drawn probe
    and deflation start block, ``mc_draws`` (an iterable of per-iteration
    [mc, 4 Nb] arrays) the draws from the state's generator (parity tests
    pass JAX's)."""
    if resume_state is not None:
        _check_resume_probe_cols(resume_state, cfg)
    state = (resume_state if resume_state is not None
             else init_state(geno, cfg, probs, vars_user))
    aux = make_aux(geno, cfg, true_signal=true_signal, bern=bern,
                   defl_v0=defl_v0)
    step = make_step(geno, cfg, with_truth=true_signal is not None,
                     timer_device=geno.device if phase_timers else None)
    history = []
    chunk = 1 if phase_timers else sync_every
    for state, ms in run_chunks(step, state, aux, cfg.max_iter, chunk,
                                draws=(iter(mc_draws) if mc_draws is not None
                                       else None)):
        history += ms
        m = ms[-1]
        if verbose:
            extra = f" corr={m['corr_x1']:.4f}" if "corr_x1" in m else ""
            print(f"[robust it {state.it}] gam1={m['gam1']:.5g} "
                  f"tau1={m['tau1']:.5g} deltaH={m['deltaH']:.4g} "
                  f"alpha2={m['alpha2']:.4g} rel={m['rel_change']:.3e} "
                  f"cg={int(m['cg_iters'])}{extra}", flush=True)
            print_phase_ms(m)
        for cb in callbacks or ():
            cb(state.it, state, m, geno)
        if state.it > 1 and float(m["rel_change"]) < cfg.stop_criteria_thr:
            break
    sqn = float(np.sqrt(geno.N))
    return state.x1[: geno.M].cpu().numpy() / sqn, state, history
