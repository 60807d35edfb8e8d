"""Probit (binary-classification) VAMP with fixed covariate effects.

Port of ``gvamp_tpu/probit.py`` (reference ``infere_bin_class``,
vamp_probit.cpp:20-658): the marker-space denoise / LMMSE skeleton of the
linear model plus a z-space denoising pair (``g1_bin_class`` /
``g1d_bin_class``, erfcx-stable, vamp_probit.cpp:661-726) and a
Newton-Raphson covariate solver with backtracking line search
(vamp_probit.cpp:936-1067).  One iteration runs four phases, as JAX's:

  denoise_x       covariate effects (iteration 1), the re-estimation loop
                  x1 = g1(r1, gam1) with the EM prior update, damping,
                  gam2 and r2;
  denoise_z       z1 = g1_bin_class(p1), beta1, tau1, p2, tau2;
  lmmse_cg        the warm-started block CG on (tau2 A^T A + gam2 I),
                  deflated when ``deflate_k > 0``, with the SLQ Onsager
                  term or probe columns riding the solve
                  (``use_slq=False``); z2 = A x2 tracked through the CG
                  recursion on the two-pass route (``fold_noise``, not under
                  ``GVAMP_NOISE_PASS=1``), or one forward pass after the
                  solve when the fused Gram (``GVAMP_FUSED_GRAM=1``) runs
                  it;
  lmmse_z_finish  beta2, tau2, p1 and tau1 from z2.

The engine runs eagerly: each loop exit or branch on a device value is a
counted host sync (``gvamp_tpu_torch.sync``).  The driver, ``sync_every``
and ``phase_timers`` are the linear engine's (``linear.run_chunks``,
``linear.make_phase_step``), under JAX's phase names.  ``init_state``
draws p1 from a CPU ``torch.Generator`` seeded by ``cfg.seed + 1``
(jax.random cannot be reproduced); parity tests pass JAX's p1 in.  The module also
holds the fixed-Gram operators and SLQ bases the linear engine shares.
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
                                    make_phase_step, print_phase_ms,
                                    probe_cols, run_chunks, slq_on)
from gvamp_tpu_torch.ops.special import normal_logcdf, phi_over_Phi
from gvamp_tpu_torch.prior import GAMMA_MIN, Prior, g1, g1d, update_prior
from gvamp_tpu_torch.sync import host_bool, host_values


# --------------------------------------------------------------------------
# fixed-Gram operators and SLQ bases (shared with the linear engine)
# --------------------------------------------------------------------------


def _gram_mult(geno):
    """(op, Pk) -> A^T A Pk: the fused primal Gram where ``fn_gram`` offers
    it (``GVAMP_FUSED_GRAM=1``), else the two-pass form."""
    gram0 = geno.fn_gram()
    if gram0 is not None:
        return gram0
    axm_fn, atxm_fn = geno.fns_multi()
    return lambda op_, Pk: atxm_fn(op_, axm_fn(op_, Pk))


def _gram_aat_mult(geno):
    """(op, Up[4, Nb, C]) -> A A^T Up: the fused dual Gram where
    ``fn_gram_aat`` offers it, else the two-pass form."""
    gaat = geno.fn_gram_aat()
    if gaat is not None:
        return gaat
    axm_fn, atxm_fn = geno.fns_multi()
    return lambda op_, Up: axm_fn(op_, atxm_fn(op_, Up))


def make_slq_basis(geno, cfg, bern):
    """One-time Lanczos quadrature of the fixed marker-space Gram in the
    probes' Krylov spaces (``cfg.slq_k`` Gram passes)."""
    mult = _gram_mult(geno)
    op = geno.op
    return slq.build(lambda X: mult(op, X), bern, cfg.slq_k)


def make_slq_basis_dual(geno, cfg, z_bern):
    """The dual basis over G_N = A A^T started at z_u = A u (``z_bern``,
    [4, Nb, P]): the Woodbury form alpha2 = 1 - gamw <z_u, Q_N^{-1} z_u> is
    a quadrature of f(lam) = 1/(gamw lam + gam2) on it (``cfg.slq_k``
    N-space Gram passes)."""
    mult = _gram_aat_mult(geno)
    op = geno.op
    shape = z_bern.shape

    def mult_n(X):
        return mult(op, X.reshape(shape[:2] + X.shape[1:])).reshape(X.shape)

    return slq.build(mult_n, z_bern.reshape(-1, shape[2]), cfg.slq_k)


# --------------------------------------------------------------------------
# z-space denoisers (vamp_probit.cpp:661-726)
# --------------------------------------------------------------------------


def _sgn_y(y):
    """+-1 case/control sign: sign(2y - 1), exact for raw 0/1 and for
    scaled encodings alike (``gvamp_tpu/probit.py:45-51``)."""
    return torch.sign(2.0 * y - 1.0)


def g1_bin_class(p, tau1, y, m_cov, probit_var):
    """E[z | p, y] for y = 1{z + eps > 0}, eps ~ N(0, probit_var)."""
    sgn = _sgn_y(y)
    sd = torch.sqrt(probit_var + 1.0 / tau1)
    ratio = phi_over_Phi(sgn * ((p + m_cov) / sd))
    return p + sgn * ratio / tau1 / sd


def g1d_bin_class(p, tau1, y, m_cov, probit_var):
    sgn = _sgn_y(y)
    c = (p + m_cov) / torch.sqrt(probit_var + 1.0 / tau1)
    ratio = phi_over_Phi(sgn * c)
    return 1.0 - ratio / (1.0 + tau1 * probit_var) * (sgn * c + ratio)


# --------------------------------------------------------------------------
# covariate-effect solver (vamp_probit.cpp:814-1067)
# --------------------------------------------------------------------------


def mlogL_probit(y, gg, probit_var, Z, eta, n_mask):
    """-1/N sum log Phi((2y-1)(gg + Z eta)/sqrt(pv)) (vamp_probit.cpp:841)."""
    g = gg + Z @ eta
    arg = _sgn_y(y) / math.sqrt(probit_var) * g
    return -(normal_logcdf(arg) * n_mask).sum() / n_mask.sum()


def grad_cov(y, gg, probit_var, Z, eta, n_mask):
    """Gradient of mlogL with respect to eta (vamp_probit.cpp:814-839)."""
    sgn = _sgn_y(y)
    g = gg + Z @ eta
    ratio = phi_over_Phi(sgn / math.sqrt(probit_var) * g)
    return -(Z.T @ (ratio * sgn / math.sqrt(probit_var) * n_mask)) \
        / n_mask.sum()


def newton_cov(y, gg, Z, eta0, n_mask, probit_var=1.0, max_iter=500,
               max_ls=300, rel_tol=1e-4):
    """Newton-Raphson with backtracking line search (vamp_probit.cpp:936-1067;
    ``gvamp_tpu/probit.py:91-138``).  y, gg: [N]; Z: [N, C].  The Newton
    system ignores probit_var while the line-search gradient uses it, as
    the reference does.  Each loop test is a counted host sync."""
    sgn = 2.0 * y - 1.0
    eta = eta0
    it, rel, bad = 0, float("inf"), False
    while it < max_iter and rel >= rel_tol and not bad:
        g = gg + Z @ eta
        lam = phi_over_Phi(sgn * g) * sgn * n_mask
        H = Z.T @ (Z * (lam * (lam + g))[:, None])
        d, info = torch.linalg.solve_ex(H, Z.T @ lam)
        ok_d = torch.isfinite(d).all() & (info == 0)
        d = torch.where(ok_d, d, torch.zeros_like(d))
        grad = grad_cov(y, gg, probit_var, Z, eta, n_mask)
        f0 = mlogL_probit(y, gg, probit_var, Z, eta, n_mask)
        scale = torch.ones((), dtype=eta.dtype, device=eta.device)
        for _ in range(max_ls):
            fz = mlogL_probit(y, gg, probit_var, Z, eta + scale * d, n_mask)
            if host_bool(fz <= f0 + torch.dot(scale * d, grad) / 2.0):
                break
            scale = scale * 0.9
        eta_new = eta + scale * d
        norm_eta = torch.sqrt(torch.square(eta).sum())
        rel_t = torch.where(
            norm_eta == 0, 1.0,
            torch.sqrt(torch.square(eta_new - eta).sum()) / norm_eta)
        f1 = mlogL_probit(y, gg, probit_var, Z, eta_new, n_mask)
        rel_h, bad_h = host_values([rel_t, f1 > f0])
        rel, bad = float(rel_h), bool(bad_h)
        eta = eta_new
        it += 1
    return eta


# --------------------------------------------------------------------------
# probit-variance EM (vamp_probit.cpp:728-812; not called by the loop)
# --------------------------------------------------------------------------


def update_probit_var(gen: torch.Generator, v, eta, z_hat, y, n_mask,
                      max_iter_bisec: int = 50):
    """MC-EM + log-bisection for the probit noise variance
    (``gvamp_tpu/probit.py:174-198``); the Monte-Carlo draws come from
    ``gen`` (a CPU generator, moved to z_hat's device), one per bisection
    step.  Runs on the device without host syncs."""
    dt, dev = z_hat.dtype, z_hat.device
    sgn = 2.0 * y - 1.0
    lo = torch.tensor(1e-10, dtype=dt, device=dev)
    hi = torch.tensor(1e10, dtype=dt, device=dev)
    v = torch.as_tensor(v, dtype=dt, device=dev)
    for _ in range(max_iter_bisec):
        noise = torch.randn(z_hat.shape, generator=gen, dtype=dt).to(dev)
        z = z_hat + noise / torch.sqrt(torch.as_tensor(eta, dtype=dt))
        c = sgn * z / v
        der = (c * torch.exp(-c * c / 2) / math.sqrt(2 * math.pi) * z / v
               / torch.clamp(0.5 * torch.erfc(-c * 0.7071067811865476),
                             min=1e-300))
        fv = (der * n_mask).sum()
        lo = torch.where(fv > 0, v, lo)
        hi = torch.where(fv <= 0, v, hi)
        v = torch.sqrt(lo * hi)
    return v


# --------------------------------------------------------------------------
# the probit VAMP loop
# --------------------------------------------------------------------------


class ProbitState(NamedTuple):
    """The fields of ``gvamp_tpu.probit.ProbitState``; ``it`` is a host
    int."""

    it: int
    x1: torch.Tensor
    x2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    z1: torch.Tensor        # z1_hat planar [4, Nb]
    z2: torch.Tensor        # A x2 planar [4, Nb]
    p1: torch.Tensor
    p2: torch.Tensor
    gam1: torch.Tensor
    gam2: torch.Tensor
    tau1: torch.Tensor
    tau2: torch.Tensor
    alpha1: torch.Tensor
    probs: torch.Tensor
    vars: torch.Tensor
    cov_eff: torch.Tensor   # [max(C, 1)]
    mu_cg: torch.Tensor     # [Mpad] CG warm start
    mu_probe: torch.Tensor  # [Mpad, P] (P = 0 under SLQ)
    gmu: torch.Tensor       # A^T A [mu_cg | mu_probe], tracked
    tau_gmu: torch.Tensor   # the tau2 gmu was stored at


@dataclasses.dataclass(frozen=True)
class ProbitConfig(VampConfig):
    """``gvamp_tpu.probit.ProbitConfig``: the linear fields plus the probit
    ones (main_real_probit defaults)."""

    gam1_init: float = 1e-8
    gamw_init: float = 1.0
    probit_var: float = 1.0
    auto_var_max_iter: int = 50    # vamp_probit.cpp:158
    z_revar_max_iter: int = 1      # vamp_probit.cpp:335
    newton_max_iter: int = 500


class ProbitAux(NamedTuple):
    op: object               # data.BedOp
    y: torch.Tensor          # filtered planar [4, Nb] (binary, NA -> 0)
    n_mask: torch.Tensor     # planar real-individual mask
    bern: torch.Tensor       # Onsager probes [Mpad, P]
    m_mask: torch.Tensor
    Z: torch.Tensor          # covariates planar-dense [4 Nb, C]
    ts: torch.Tensor         # true signal * sqrt(N) (zeros if absent)
    slq: Optional[slq.SlqBasis]  # quadrature of the fixed Gram A^T A;
                                 # None on the probe path
    defl: Optional[tuple] = None  # (V, lam): deflation basis (deflate_k > 0)


def init_state(geno, cfg: ProbitConfig, probs, vars_user,
               p1: Optional[np.ndarray] = None) -> ProbitState:
    """Initial state; p1 starts as unit Gaussian noise on the real samples
    (vamp_probit.cpp:52), drawn from a CPU generator seeded by
    ``cfg.seed + 1`` unless ``p1`` (planar [4, Nb]) is given."""
    dt, dev, Mp = geno.dtype, geno.device, geno.Mpad
    nb4 = tuple(geno.y_planar.shape)
    if p1 is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(cfg.seed + 1)
        p1_t = torch.randn(nb4, generator=gen, dtype=dt).to(dev)
    else:
        p1_t = torch.tensor(np.asarray(p1), dtype=dt, device=dev)
    p1_t = p1_t * geno.n_mask_planar
    C = geno.covs.shape[1] if geno.covs is not None else 0
    P = probe_cols(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    def scalar(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    return ProbitState(
        it=0, x1=zeros(Mp), x2=zeros(Mp), r1=zeros(Mp), r2=zeros(Mp),
        z1=zeros(*nb4), z2=zeros(*nb4), p1=p1_t, p2=zeros(*nb4),
        gam1=scalar(cfg.gam1_init), gam2=scalar(0.0),
        tau1=scalar(cfg.gam1_init), tau2=scalar(0.0), alpha1=scalar(0.0),
        probs=scalar(probs), vars=scalar(np.asarray(vars_user) * geno.N),
        cov_eff=zeros(max(C, 1)), mu_cg=zeros(Mp), mu_probe=zeros(Mp, P),
        gmu=zeros(Mp, 1 + P), tau_gmu=scalar(0.0))


def make_aux(geno, cfg: ProbitConfig, true_signal=None,
             bern=None, defl_v0=None) -> ProbitAux:
    """Set-up: covariates, the deflation basis (``deflate_k > 0``;
    ``defl_v0`` replaces its drawn start block), the probe (``bern``
    replaces the drawn one) and, unless the probe columns carry the trace
    (``use_slq=False``; ``red`` here means probe columns only, as in JAX),
    the SLQ basis (``cfg.slq_k`` Gram passes, fused where fn_gram is on)."""
    from gvamp_tpu_torch.linear import make_deflation
    defl = make_deflation(geno, cfg, defl_v0)
    C = geno.covs.shape[1] if geno.covs is not None else 0
    nb4 = geno.y_planar.numel()
    Z = (geno.covs_planar().reshape(nb4, C) if C > 0
         else torch.zeros((nb4, 1), dtype=geno.dtype, device=geno.device))
    if bern is None:
        bern = make_bern_probe(geno, cfg.seed, cfg.n_probes)
    else:
        bern = torch.tensor(np.asarray(bern), dtype=geno.dtype,
                            device=geno.device)
    return ProbitAux(
        op=geno.op, y=geno.filter_pheno(), n_mask=geno.n_mask_planar,
        bern=bern, m_mask=geno.m_mask, Z=Z,
        ts=(geno.pad_m(true_signal) * math.sqrt(geno.N)
            if true_signal is not None else torch.zeros_like(geno.m_mask)),
        slq=make_slq_basis(geno, cfg, bern) if slq_on(cfg) else None,
        defl=defl)


def geo_damp(new, old, s: float, active: bool):
    """old^(1-s) new^s where ``active``, else ``new`` (``--stab-gamma``,
    ``gvamp_tpu/linear.py:43-52``)."""
    if not active:
        return new
    return torch.exp((1.0 - s) * torch.log(torch.clamp(old, min=GAMMA_MIN))
                     + s * torch.log(torch.clamp(new, min=GAMMA_MIN)))


def make_step(geno, cfg: ProbitConfig, n_cov: int = 0,
              with_truth: bool = False, timer_device=None):
    """The per-iteration probit step: (state, aux) -> (state, metrics),
    its phases timed with ``timer_device`` (``linear.make_phase_step``)."""
    Mt = float(geno.Mt)
    N = float(geno.N)
    ax_fn, atx_fn = geno.fns()
    axm_fn, atxm_fn = geno.fns_multi()
    gram_fn = geno.fn_gram()
    # z2 = A x2 tracked through the CG recursion (zmu += alpha_0 A p_0) on
    # the two-pass route; the fused Gram never forms A p, so it takes the
    # explicit forward pass (probit.py:348-354)
    track_z2 = (cfg.fold_noise and gram_fn is None
                and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    P_cg = probe_cols(cfg)
    use_slq = slq_on(cfg)
    pv = cfg.probit_var

    def phase_denoise_x(w, state: ProbitState, aux: ProbitAux):
        m_mask = aux.m_mask
        yf = aux.y.reshape(-1)
        nm = aux.n_mask.reshape(-1)
        it = state.it + 1
        # covariate effects (iteration 1 only; vamp_probit.cpp:110-126)
        cov_eff = state.cov_eff
        if n_cov > 0:
            if it == 1:
                cov_eff = newton_cov(yf, state.z1.reshape(-1), aux.Z,
                                     torch.zeros_like(cov_eff), nm,
                                     probit_var=pv,
                                     max_iter=cfg.newton_max_iter)
            m_cov = (aux.Z @ cov_eff) * nm
        else:
            m_cov = torch.zeros_like(yf)
        # the re-estimation loop (vamp_probit.cpp:158-197); its test reads
        # gam1 on the host
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
        # damping (vamp_probit.cpp:199-204), rho in the engine dtype
        if it > 1:
            rho = torch.as_tensor(cfg.rho, dtype=x1.dtype, device=x1.device)
            x1 = rho * x1 + (1 - rho) * state.x1
            alpha1 = rho * alpha1 + (1 - rho) * state.alpha1
        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1 * x1 - gam1 * state.r1) / gam2) * m_mask
        w.update(it=it, x1_prev=state.x1, x1=x1, gam1=gam1, alpha1=alpha1,
                 eta1=eta1, probs=probs, vars=vars_, cov_eff=cov_eff,
                 m_cov=m_cov, gam2=gam2, r2=r2)
        return w

    def phase_denoise_z(w, state: ProbitState, aux: ProbitAux):
        # vamp_probit.cpp:330-390, one z-revar pass (vamp_probit.cpp:335)
        yf = aux.y.reshape(-1)
        nm = aux.n_mask.reshape(-1)
        p1f = state.p1.reshape(-1)
        tau1 = state.tau1
        z1f = g1_bin_class(p1f, tau1, yf, w["m_cov"], pv) * nm
        beta1 = (g1d_bin_class(p1f, tau1, yf, w["m_cov"], pv) * nm).sum() / N
        zeta1 = tau1 / beta1
        l2zp = (torch.square(z1f - p1f) * nm).sum()
        if w["it"] > 1:
            tau1 = _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N))
        p2f = ((z1f - beta1 * p1f) / (1.0 - beta1)) * nm
        w.update(z1f=z1f, beta1=beta1, tau1=tau1, p2f=p2f,
                 tau2=tau1 * (1.0 - beta1) / beta1)
        return w

    def phase_lmmse_x(w, state: ProbitState, aux: ProbitAux):
        # vamp_probit.cpp:495-560
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
            # warm start from the previous solutions with the tracked Gram
            # product (the reference zero-starts, vamp_probit.cpp:507)
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
        # basis (g2d_onsager, vamp.cpp:871-889) or the probe columns'
        # Hutchinson estimate, clipped into (0, 1) at a bound the dtype can
        # represent: the probe quadform can reach 1 (probit.py:522-533)
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

    def phase_lmmse_z(w, state: ProbitState, aux: ProbitAux):
        # vamp_probit.cpp:567-614
        nm = aux.n_mask.reshape(-1)
        it, x1 = w["it"], w["x1"]
        p2f, tau2, alpha2 = w["p2f"], w["tau2"], w["alpha2"]
        # z2 = A x2: tracked through the CG recursion, or one forward pass
        z2 = w["z2"] if w["z2"] is not None else ax_fn(aux.op, w["x2"])
        z2f = z2.reshape(-1)
        beta2 = Mt / N * (1.0 - alpha2)
        zeta2 = tau2 / beta2
        l2z2p2 = (torch.square(z2f - p2f) * nm).sum()
        if it > 1:
            tau2 = 1.0 / (1.0 / zeta2 + l2z2p2 / N)
        p1_new = ((z2f - beta2 * p2f) / (1.0 - beta2)) * nm
        tau1_new = tau2 * (1.0 - beta2) / beta2
        if cfg.stab_gamma < 1.0:
            tau1_new = geo_damp(tau1_new, state.tau1, cfg.stab_gamma, it > 1)
        x1_prev = w["x1_prev"]
        metrics = {
            "it": it, "gam1": w["gam1_new"], "gam2": w["gam2"],
            "tau1": tau1_new, "tau2": tau2, "alpha1": w["alpha1"],
            "alpha2": alpha2, "beta1": w["beta1"], "beta2": beta2,
            "eta1": w["eta1"],
            "rel_change": torch.sqrt(
                torch.square(x1_prev - x1).sum()
                / torch.clamp(torch.square(x1_prev).sum(), min=1e-30)),
            "cg_iters": w["cg_iters"], "probs": w["probs"],
            "vars": w["vars"], "cov_eff": w["cov_eff"],
        }
        if with_truth:
            ts = aux.ts
            metrics["corr_x1"] = (x1 * ts).sum() / torch.sqrt(
                torch.square(x1).sum() * torch.square(ts).sum())
        shape = state.p2.shape
        new_state = ProbitState(
            it=it, x1=x1, x2=w["x2"], r1=w["r1"], r2=w["r2"],
            z1=w["z1f"].reshape(shape), z2=z2, p1=p1_new.reshape(shape),
            p2=p2f.reshape(shape), gam1=w["gam1_new"], gam2=w["gam2"],
            tau1=tau1_new, tau2=tau2, alpha1=w["alpha1"], probs=w["probs"],
            vars=w["vars"], cov_eff=w["cov_eff"], mu_cg=w["mu_cg"],
            mu_probe=w["mu_probe"], gmu=w["gmu"], tau_gmu=w["tau_gmu"])
        return new_state, metrics

    return make_phase_step(
        (("denoise_x", phase_denoise_x), ("denoise_z", phase_denoise_z),
         ("lmmse_cg", phase_lmmse_x), ("lmmse_z_finish", phase_lmmse_z)),
        timer_device)


@trace.spanned("infer", engine="probit")
def infer(geno, cfg: ProbitConfig, probs, vars_user, true_signal=None,
          verbose: bool = True, callbacks=None, phase_timers: bool = False,
          sync_every: int = 1, resume_state: ProbitState = None, bern=None,
          p1=None, defl_v0=None):
    """Run the probit VAMP loop; returns (x1_hat_stored /sqrt(N), state,
    history).  ``sync_every``, ``phase_timers`` and the history's
    ``host_syncs`` are the linear engine's (``linear.infer``).  ``bern``,
    ``p1`` and ``defl_v0`` replace the
    drawn probe, initial p1 and deflation start block (parity tests pass
    JAX's)."""
    n_cov = geno.covs.shape[1] if geno.covs is not None else 0
    if resume_state is not None:
        _check_resume_probe_cols(resume_state, cfg)
    state = (resume_state if resume_state is not None
             else init_state(geno, cfg, probs, vars_user, p1=p1))
    aux = make_aux(geno, cfg, true_signal=true_signal, bern=bern,
                   defl_v0=defl_v0)
    step = make_step(geno, cfg, n_cov=n_cov,
                     with_truth=true_signal is not None,
                     timer_device=geno.device if phase_timers else None)
    history = []
    chunk = 1 if phase_timers else sync_every
    for state, ms in run_chunks(step, state, aux, cfg.max_iter, chunk):
        history += ms
        m = ms[-1]
        if verbose:
            extra = f" corr={m['corr_x1']:.4f}" if "corr_x1" in m else ""
            print(f"[probit it {state.it}] gam1={m['gam1']:.5g} "
                  f"tau1={m['tau1']:.5g} beta1={m['beta1']:.4g} "
                  f"alpha2={m['alpha2']:.4g} rel={m['rel_change']:.3e} "
                  f"cg={int(m['cg_iters'])}{extra}", flush=True)
            print_phase_ms(m)
        for cb in callbacks or ():
            cb(state.it, state, m, geno)
        if state.it > 1 and float(m["rel_change"]) < cfg.stop_criteria_thr:
            break
    sqn = float(np.sqrt(geno.N))
    return state.x1[: geno.M].cpu().numpy() / sqn, state, history
