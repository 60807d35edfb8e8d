"""Multi-trait VAMP: T phenotypes in one run over a shared .bed.

Port of ``gvamp_tpu/multi.py``: the linear, probit and Huber engines with a
trailing trait axis.  Every marker-space vector is [Mpad, T] (planar ones
[4, Nb, T]), every scalar a [T] vector, and the T LMMSE solves share one
block CG whose column j carries trait ``cols[j]``'s operator (its own marker
statistics over its own phenotype-NA support, reference data.cpp:446-483),
so that each pass over the packed words serves every trait.  Per-trait
semantics are those of the single-trait engines: each trait has its own
prior and EM trajectory, noise precision, damping and stopping; traits that
converge freeze while the rest continue, and a run ends when every trait
has stopped or at ``max_iter``.

Routing (``MultiPhen.fns``): float32 on complete genotypes runs
``matvec.axm_i8a`` / ``atxm_i8a`` with b's contractions collapsed to
per-column scalars; float32 with missing calls ``matvec.axm_i8`` /
``atxm_i8``; float64 the dense plain products on the CPU.  Under
``GVAMP_FUSED_GRAM=1`` the CG's products go through the fused primal Grams
``gram_i8a`` / ``gram_i8`` with per-column [4, Nb, B] phenotype-NA masks.

As in the single-trait engines the step runs eagerly, with ``it`` a host
int; each loop exit on a device value is a counted host sync
(``gvamp_tpu_torch.sync``).  The JAX step's fixed-count re-estimation loop
stops here once no trait is active (an inactive trait never becomes active
again, so the skipped passes change nothing), and the batched EM prior
update reads one flag per pass (``prior.update_prior``).  Huber's
Monte-Carlo draws come from a CPU generator in the state (``gen``, seeded
``cfg.seed + 2``), T blocks of [mc, 4 Nb] per iteration; parity tests pass
JAX's draws in.  ``use_slq=False`` (or ``red``, which means probe columns
only here) takes the Onsager traces from T*P probe columns riding the
block CG.  ``sync_every`` > 1 runs chunks of that many iterations between
metrics fetches (``linear.run_chunks``); the callbacks and the all-stopped
exit run once per chunk, with no exit inside a chunk, where stopped traits
stay frozen.  ``use_cross_val`` raises: the JAX package's CLI refuses it
for several phenotypes (``gvamp_tpu/cli.py:247-262``), and its multi-trait
engines have no damping tuner.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from gvamp_tpu_torch import cg, linear, probit, robust, slq, trace
from gvamp_tpu_torch.linear import (VampConfig, _check_resume_probe_cols,
                                    _clamp_gamma, probe_cols, run_chunks,
                                    slq_on)
from gvamp_tpu_torch.ops import matvec
from gvamp_tpu_torch.prior import Prior, g1, g1d, update_prior
from gvamp_tpu_torch.sync import host_bool


class MultiOp(NamedTuple):
    """The shared packed words and the per-trait standardisation."""

    words: torch.Tensor   # int32[Nw, Mpad] (shared; a mesh: the slabs)
    mave: torch.Tensor    # [Mpad, T]
    msig: torch.Tensor    # [Mpad, T]
    na: torch.Tensor      # [4, Nb, T] per-trait phenotype-NA indicator
    m_mask: torch.Tensor  # [Mpad]


@dataclasses.dataclass
class MultiPhen:
    """T phenotypes bound to one GenoBed's packed words."""

    geno: object           # data.GenoBed
    T: int
    mave: torch.Tensor     # [Mpad, T]
    msig: torch.Tensor
    na: torch.Tensor       # [4, Nb, T]
    y: torch.Tensor        # [4, Nb, T] standardised, NA slots zero
    nonas: np.ndarray      # int[T]
    intercepts: np.ndarray
    scales: np.ndarray

    @classmethod
    def build(cls, geno, ys: list, standardize: bool = True) -> "MultiPhen":
        """Per-trait standardisation and marker statistics: one statistics
        pass per trait over its own phenotype-NA support (reference
        data.cpp:128-192, 446-483)."""
        maves, msigs, nas, yps = [], [], [], []
        nonas, icepts, scales = [], [], []
        for y_raw in ys:
            y_raw = np.asarray(y_raw, np.float64)
            isna = np.isnan(y_raw)
            nn = int((~isna).sum())
            if standardize and nn > 1:
                avg = float(np.nanmean(y_raw))
                sqn = float(np.sqrt((nn - 1) / np.nansum((y_raw - avg) ** 2)))
            else:
                avg, sqn = 0.0, 1.0
            na_p = geno.planarize((~isna).astype(np.float64))
            mave, msig = geno.marker_stats_for(na_p, nn)
            maves.append(mave)
            msigs.append(msig)
            nas.append(na_p)
            yps.append(geno.planarize(np.where(isna, 0.0, y_raw) * sqn))
            nonas.append(nn)
            icepts.append(avg)
            scales.append(sqn)
        return cls(geno=geno, T=len(ys), mave=torch.stack(maves, dim=1),
                   msig=torch.stack(msigs, dim=1), na=torch.stack(nas, dim=-1),
                   y=torch.stack(yps, dim=-1), nonas=np.asarray(nonas),
                   intercepts=np.asarray(icepts), scales=np.asarray(scales))

    @property
    def op(self) -> MultiOp:
        return MultiOp(words=self.geno.words, mave=self.mave, msig=self.msig,
                       na=self.na, m_mask=self.geno.m_mask)

    def filter_pheno(self) -> torch.Tensor:
        return self.y * self.na

    def cols(self, cols) -> torch.Tensor:
        """A per-column trait index (numpy or list) as an index tensor on
        the container's device, made once where a step is built."""
        return torch.as_tensor(np.asarray(cols, dtype=np.int64),
                               device=self.geno.device)

    def fns(self):
        """(axm_fn, atxm_fn) with per-column standardisation: X [Mpad, B]
        -> [4, Nb, B] and V [4, Nb, B] -> [Mpad, B], column j under trait
        ``cols[j]``'s statistics and NA mask (``cols`` from ``self.cols``).
        Under a mesh the kernels run per slab, as ``GenoBed``'s."""
        geno = self.geno
        dtype, scale = geno.dtype, geno.inv_sqrt_n

        if dtype == torch.float32 and geno.geno_complete:
            # complete genotypes: b's contractions collapse to per-column
            # scalars as in the single-trait path; the phenotype-NA masks
            # stay per trait (multi.py:110-147)
            axm_a = geno._sharded(matvec.axm_i8a, ("m",), "sum")
            atxm_a = geno._sharded(matvec.atxm_i8a, (None,), "m")

            def axm_fn(op: MultiOp, X, cols):
                W = op.msig[:, cols] * X.to(dtype)
                U = op.mave[:, cols] * W
                z = axm_a(op.words, W) - U.sum(dim=0)[None, None, :]
                return z * op.na[:, :, cols] * scale

            def atxm_fn(op: MultiOp, V, cols):
                v = V.to(dtype) * op.na[:, :, cols]
                av = atxm_a(op.words, v)
                sv = v.sum(dim=(0, 1))
                return ((av - op.mave[:, cols] * sv[None, :])
                        * op.msig[:, cols] * scale)

            return axm_fn, atxm_fn

        if dtype == torch.float64:
            def axm_raw(words, W, U):
                return matvec.axm_ref(words, W, U, dtype)

            def atxm_raw(words, V):
                return matvec.atxm_ref(words, V, dtype)
        else:
            axm_raw, atxm_raw = matvec.axm_i8, matvec.atxm_i8
        axm_raw = geno._sharded(axm_raw, ("m", "m"), "sum")
        atxm_raw = geno._sharded(atxm_raw, (None,), "m")

        def axm_fn(op: MultiOp, X, cols):
            W = op.msig[:, cols] * X.to(dtype)
            z = axm_raw(op.words, W, op.mave[:, cols] * W)
            return z * op.na[:, :, cols] * scale

        def atxm_fn(op: MultiOp, V, cols):
            v = V.to(dtype) * op.na[:, :, cols]
            av, bv = atxm_raw(op.words, v)
            return (av - op.mave[:, cols] * bv) * op.msig[:, cols] * scale

        return axm_fn, atxm_fn

    def fn_gram(self):
        """The fused per-column Gram ``gram_fn(op, X, cols) -> A^T (A X)``
        in one read of the words, or None: the routing of
        ``GenoBed.fn_gram`` (opt-in under ``GVAMP_FUSED_GRAM=1``; None
        under ``GVAMP_NO_FUSED_GRAM=1``, in float64, under a mesh and past
        ``matvec.gram_fits``), with each column's trait NA mask passed to
        the kernel as a [4, Nb, B] mask."""
        geno = self.geno
        if os.environ.get("GVAMP_FUSED_GRAM", "") != "1":
            return None
        if os.environ.get("GVAMP_NO_FUSED_GRAM", "") == "1":
            return None
        if (geno.dtype == torch.float64 or geno.mesh is not None
                or not matvec.gram_fits(geno.words)):
            return None
        dtype = geno.dtype
        scale2 = geno.inv_sqrt_n * geno.inv_sqrt_n

        if geno.geno_complete:
            def gram_fn(op: MultiOp, X, cols):
                W = op.msig[:, cols] * X.to(dtype)
                cu = (op.mave[:, cols] * W).sum(dim=0)
                av, sv = matvec.gram_i8a(op.words, W, op.na[:, :, cols], cu)
                return ((av - op.mave[:, cols] * sv[None, :])
                        * op.msig[:, cols] * scale2)
        else:
            def gram_fn(op: MultiOp, X, cols):
                W = op.msig[:, cols] * X.to(dtype)
                av, bv = matvec.gram_i8(op.words, W, op.mave[:, cols] * W,
                                        op.na[:, :, cols])
                return ((av - op.mave[:, cols] * bv)
                        * op.msig[:, cols] * scale2)

        return gram_fn

    def gram_mult(self):
        """(op, X, cols) -> A^T A X per column: the fused Gram where
        ``fn_gram`` offers it, else the two-pass form."""
        gram = self.fn_gram()
        if gram is not None:
            return gram
        axm_fn, atxm_fn = self.fns()
        return lambda op, X, cols: atxm_fn(op, axm_fn(op, X, cols), cols)


# --------------------------------------------------------------------------
# the linear state and set-up
# --------------------------------------------------------------------------


class MultiState(NamedTuple):
    """The fields of ``gvamp_tpu.multi.MultiState``; ``it`` is a host int."""

    it: int
    x1: torch.Tensor        # [Mpad, T]
    x2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    z1: torch.Tensor        # [4, Nb, T]
    mu_cg: torch.Tensor     # [Mpad, T]
    mu_probe: torch.Tensor  # [Mpad, T*P] (P = 0 under SLQ)
    gam1: torch.Tensor      # [T]
    gam2: torch.Tensor
    gamw: torch.Tensor
    eta1: torch.Tensor
    eta2: torch.Tensor
    alpha1: torch.Tensor
    alpha2: torch.Tensor
    rho: torch.Tensor
    probs: torch.Tensor     # [T, L]
    vars: torch.Tensor      # [T, L]
    stopped: torch.Tensor   # bool[T]: converged traits freeze
    gmu: torch.Tensor       # [Mpad, T+T*P] A^T A [mu_cg | mu_probe], tracked
    tau_gmu: torch.Tensor   # [T] the per-trait tau gmu was stored at
    mu_prevb: torch.Tensor  # the one-older exit block and its tracked Gram
    gmu_prev: torch.Tensor  # product: the secant pair


def _prior_rows(mp: MultiPhen, probs, vars_user):
    """probs and N-scaled vars as [T, L] rows of every trait."""
    dt, dev, T = mp.geno.dtype, mp.geno.device, mp.T
    p = torch.as_tensor(np.asarray(probs, np.float64), dtype=dt, device=dev)
    v = torch.as_tensor(np.asarray(vars_user, np.float64) * mp.geno.N,
                        dtype=dt, device=dev)
    return (p.expand(T, p.shape[-1]).contiguous(),
            v.expand(T, v.shape[-1]).contiguous())


def _zeros(mp: MultiPhen):
    dt, dev = mp.geno.dtype, mp.geno.device
    return lambda *shape: torch.zeros(shape, dtype=dt, device=dev)


def _full(mp: MultiPhen, x):
    return torch.full((mp.T,), float(x), dtype=mp.geno.dtype,
                      device=mp.geno.device)


def init_state(mp: MultiPhen, cfg: VampConfig, probs, vars_user) -> MultiState:
    zeros = _zeros(mp)
    Mp, T = mp.geno.Mpad, mp.T
    P = probe_cols(cfg)
    probs_t, vars_t = _prior_rows(mp, probs, vars_user)
    return MultiState(
        it=0, x1=zeros(Mp, T), x2=zeros(Mp, T), r1=zeros(Mp, T),
        r2=zeros(Mp, T), z1=torch.zeros_like(mp.y), mu_cg=zeros(Mp, T),
        mu_probe=zeros(Mp, T * P), gam1=_full(mp, cfg.gam1_init),
        gam2=zeros(T), gamw=_full(mp, cfg.gamw_init), eta1=zeros(T),
        eta2=zeros(T), alpha1=zeros(T), alpha2=zeros(T),
        rho=_full(mp, cfg.rho), probs=probs_t, vars=vars_t,
        stopped=torch.zeros((T,), dtype=torch.bool, device=mp.geno.device),
        gmu=zeros(Mp, T * (1 + P)), tau_gmu=zeros(T),
        mu_prevb=zeros(Mp, T * (1 + P)), gmu_prev=zeros(Mp, T * (1 + P)))


class MultiAux(NamedTuple):
    op: MultiOp
    y: torch.Tensor          # [4, Nb, T] filtered
    bern: torch.Tensor       # [Mpad, P] probes shared by every trait
    aty: torch.Tensor        # [Mpad, T] per-trait A_t^T y_t
    m_mask: torch.Tensor
    slq: Optional[slq.SlqBasis]  # T*P columns: probe j under trait t's own
                                 # Gram; None on the probe path
    defl: Optional[tuple] = None  # (V [Mpad, k], lam [k]) shared basis
    z_bern: Optional[torch.Tensor] = None  # [4, Nb, T*P] A_t u_j on the
                                           # probe path


def _bern(mp: MultiPhen, cfg, bern):
    if bern is None:
        return linear.make_bern_probe(mp.geno, cfg.seed, cfg.n_probes)
    return torch.tensor(np.asarray(bern), dtype=mp.geno.dtype,
                        device=mp.geno.device)


def make_deflation(mp: MultiPhen, cfg, defl_v0=None):
    """The shared CG deflation basis (``deflate_k > 0``; multi.py:293-313):
    the top eigenpairs of trait 0's Gram.  The other traits' Grams differ
    only through their phenotype-NA supports, so the basis stays an SPD
    preconditioner for every column.  ``defl_v0`` replaces the drawn start
    block."""
    if cfg.deflate_k <= 0:
        return None
    mult, op = mp.gram_mult(), mp.op
    cols0 = mp.cols(np.zeros(cfg.deflate_k, dtype=int))
    return cg.top_eigs(lambda X: mult(op, X, cols0), mp.geno.Mpad,
                       cfg.deflate_k, seed=cfg.seed, n_iter=cfg.deflate_iters,
                       dtype=mp.geno.dtype, device=mp.geno.device, V0=defl_v0)


def make_slq_basis(mp: MultiPhen, cfg, bern) -> slq.SlqBasis:
    """T*P-column Lanczos quadrature: probe j in trait t's Krylov space
    under trait t's own Gram (``cfg.slq_k`` Gram passes at width T*P)."""
    mult, op = mp.gram_mult(), mp.op
    cols_tp = mp.cols(np.repeat(np.arange(mp.T), cfg.n_probes))
    return slq.build(lambda X: mult(op, X, cols_tp), bern.repeat(1, mp.T),
                     cfg.slq_k)


def _check_cfg(cfg: VampConfig) -> None:
    """Raise on the linear option the multi-trait engines do not run."""
    if cfg.use_cross_val:
        raise NotImplementedError(
            "use_cross_val: the multi-trait engines have no cross-validation "
            "damping tuner (the JAX CLI refuses --use-cross-val for several "
            "--phen-files)")


def make_aux(mp: MultiPhen, cfg: VampConfig, bern=None,
             defl_v0=None) -> MultiAux:
    """Set-up: the probe (``bern`` replaces the drawn one), the deflation
    basis, A_t^T y_t, and the SLQ basis or, on the probe path, the T*P-wide
    pass A_t u_j (``gvamp_tpu/multi.py:340-360``)."""
    _check_cfg(cfg)
    bern = _bern(mp, cfg, bern)
    axm_fn, atxm_fn = mp.fns()
    yf = mp.filter_pheno()
    use_slq = slq_on(cfg)
    cols_tp = mp.cols(np.repeat(np.arange(mp.T), cfg.n_probes))
    return MultiAux(op=mp.op, y=yf, bern=bern,
                    aty=atxm_fn(mp.op, yf, mp.cols(np.arange(mp.T))),
                    m_mask=mp.geno.m_mask,
                    defl=make_deflation(mp, cfg, defl_v0),
                    slq=make_slq_basis(mp, cfg, bern) if use_slq else None,
                    z_bern=(None if use_slq else
                            axm_fn(mp.op, bern.repeat(1, mp.T), cols_tp)))


# --------------------------------------------------------------------------
# the x-side denoiser shared by the three engines
# --------------------------------------------------------------------------


def _revar(mp: MultiPhen, cfg, state, m_mask, it: int, eta1):
    """The re-estimation loop (multi.py:402-440) with per-trait convergence
    masking, then the prior update of iteration 1 (or of a run without the
    loop).  JAX runs ``max(auto_var_max_iter, 1)`` masked passes; a trait
    whose gam1 settles becomes inactive and stays so, since neither its
    gam1 nor its previous gam1 moves again, so the loop stops at the first
    pass with no active trait (one host read per pass).  Returns (x1, gam1,
    alpha1, eta1, probs, vars) before damping."""
    Mt = float(mp.geno.Mt)
    mm = m_mask[:, None]
    r1 = state.r1
    x1, gam1, alpha1 = state.x1, state.gam1, state.alpha1
    probs, vars_ = state.probs, state.vars
    prev = torch.full_like(gam1, math.inf)
    act = torch.ones_like(state.stopped)
    for i in range(max(cfg.auto_var_max_iter, 1)):
        if i > 0:
            if it <= 1:
                break
            act = torch.abs(gam1 - prev) >= cfg.revar_tol
            if not host_bool(act.any()):
                break
        pr = Prior(probs=probs, vars=vars_)
        x1n = g1(r1, gam1, pr) * mm
        alpha1n = (g1d(r1, gam1, pr) * mm).sum(dim=0) / Mt
        eta1n = gam1 / alpha1n
        l2diff = torch.square((x1n - r1) * mm).sum(dim=0)
        gam1n = (_clamp_gamma(1.0 / (1.0 / eta1n + l2diff / Mt)) if it > 1
                 else gam1)
        if it > 1:
            # prior re-estimation from it > 1 only (vamp.cpp:318-330)
            p2 = update_prior(r1, gam1n, pr, m_mask, Mt,
                              em_max_iter=cfg.em_max_iter,
                              em_err_thr=cfg.em_err_thr,
                              learn_vars=cfg.learn_vars, active=act)
            probs = torch.where(act[:, None], p2.probs, probs)
            vars_ = torch.where(act[:, None], p2.vars, vars_)
        x1 = torch.where(act[None, :], x1n, x1)
        prev = torch.where(act, gam1, prev)
        gam1 = torch.where(act, gam1n, gam1)
        alpha1 = torch.where(act, alpha1n, alpha1)
        eta1 = torch.where(act, eta1n, eta1)
    if cfg.auto_var_max_iter == 0 or it <= 1:
        # the single prior update when the loop is off or at it == 1
        # (linear.py post-loop update, vamp.cpp:518-519)
        p1 = update_prior(r1, gam1, Prior(probs=probs, vars=vars_), m_mask,
                          Mt, em_max_iter=cfg.em_max_iter,
                          em_err_thr=cfg.em_err_thr,
                          learn_vars=cfg.learn_vars)
        probs, vars_ = p1.probs, p1.vars
    return x1, gam1, alpha1, eta1, probs, vars_


def _rel_change(x1_prev, x1, floor: float):
    return torch.sqrt(torch.square(x1_prev - x1).sum(dim=0)
                      / torch.clamp(torch.square(x1_prev).sum(dim=0),
                                    min=floor))


def _canonical(state):
    """Every tensor field in the contiguous layout: the products return
    [4, Nb, B] blocks with the column axis outermost, and a reduction over
    another layout sums in another order, so a state read back from a
    checkpoint (always contiguous) would step to other bits than the one
    it was saved from."""
    return state._replace(**{
        n: v.contiguous() for n, v in zip(state._fields, state)
        if isinstance(v, torch.Tensor)})


def _keep(live, new, old):
    """``new`` on live traits (the trailing axis), ``old`` on frozen ones."""
    return torch.where(live, new, old)


# --------------------------------------------------------------------------
# the linear step
# --------------------------------------------------------------------------


def make_step(mp: MultiPhen, cfg: VampConfig):
    """The per-iteration multi-trait linear step (multi.py:363-641):
    (state, aux) -> (state, metrics)."""
    _check_cfg(cfg)
    Mt = float(mp.geno.Mt)
    N = float(mp.geno.N)
    T, P = mp.T, cfg.n_probes
    axm_fn, atxm_fn = mp.fns()
    gram_fn = mp.fn_gram()
    P_cg = probe_cols(cfg)
    cols_tpc = np.repeat(np.arange(T), P_cg)
    cols_t_np = np.arange(T)
    cols_tp = mp.cols(np.repeat(np.arange(T), P))
    cols_all = mp.cols(np.concatenate([cols_t_np, cols_tpc]))
    cols_rider = mp.cols(np.concatenate([cols_t_np, cols_tpc, cols_t_np]))
    tpc = mp.cols(cols_tpc)
    # the noise-EM pass folded into the CG exit, as in the single-trait
    # engine: two-pass routing only, with the environment switch
    fold_noise = (cfg.fold_noise and gram_fn is None
                  and os.environ.get("GVAMP_NOISE_PASS", "0") != "1")
    use_slq = slq_on(cfg)

    def step(state: MultiState, aux: MultiAux):
        op, y, m_mask = aux.op, aux.y, aux.m_mask
        mm = m_mask[:, None]
        it = state.it + 1
        x1_prev = state.x1
        live = ~state.stopped

        x1, gam1, alpha1, eta1, probs, vars_ = _revar(
            mp, cfg, state, m_mask, it, state.eta1)
        # damping and adaptive rho (vamp.cpp:348-414, 501-502)
        rho = state.rho
        if it > 1:
            x1 = rho[None, :] * x1 + (1 - rho[None, :]) * state.x1
            alpha1 = rho * alpha1 + (1 - rho) * state.alpha1
            xi = torch.clamp(2.0 * torch.minimum(alpha1, state.alpha2),
                             max=1.0)
            rho = torch.maximum(rho, xi)
        # freeze converged traits
        x1 = _keep(live[None, :], x1, state.x1)
        gam1 = _keep(live, gam1, state.gam1)
        alpha1 = _keep(live, alpha1, state.alpha1)
        eta1 = _keep(live, eta1, state.eta1)

        gam2 = _clamp_gamma(eta1 - gam1)
        r2 = ((eta1[None, :] * x1 - gam1[None, :] * state.r1)
              / gam2[None, :]) * mm
        r2 = _keep(live[None, :], r2, state.r2)
        l2y = torch.square(y).sum(dim=(0, 1))

        # ---- LMMSE: T solves (+ T*P probes) in one block CG; gamma_damp
        # scales gam2 for the LMMSE only (vamp.cpp:553-554, 642-643)
        gamw = state.gamw
        gam2_eff = gam2 * cfg.gamma_damp
        tau_cols = torch.cat([gamw, gamw[tpc]])
        gam2_cols = torch.cat([gam2_eff, gam2_eff[tpc]])
        diag_cols = (tau_cols * (N - 1.0) / N + gam2_cols)[None, :]

        def multb(Pk):
            if gram_fn is not None:
                return (tau_cols[None, :] * gram_fn(op, Pk, cols_all)
                        + gam2_cols[None, :] * Pk)
            return (tau_cols[None, :]
                    * atxm_fn(op, axm_fn(op, Pk, cols_all), cols_all)
                    + gam2_cols[None, :] * Pk)

        def rider_mult(Pk, X):
            Z = axm_fn(op, torch.cat([Pk, X], dim=1), cols_rider)
            B = Pk.shape[1]
            return (tau_cols[None, :] * atxm_fn(op, Z[..., :B], cols_all)
                    + gam2_cols[None, :] * Pk), Z[..., B:]

        v = gamw[None, :] * aux.aty + gam2_eff[None, :] * r2
        bern_tp = aux.bern[:, :P_cg].repeat(1, T)
        V = torch.cat([v, bern_tp], dim=1)
        mu_start = torch.cat([state.mu_cg, state.mu_probe], dim=1)
        mu0, r0 = mu_start, None
        precond = None
        if aux.defl is not None:
            precond = cg.make_deflated_precond(
                aux.defl[0], aux.defl[1], tau_cols, gam2_cols, diag_cols)
        if cfg.gram_refresh > 1:
            tau_ref = torch.cat([state.tau_gmu, state.tau_gmu[tpc]])[None, :]
            gmu_c = state.gmu
            if cfg.cg_extrapolate:
                # per-column secant extrapolation over the last two exits
                mu0, gmu_c = cg.extrapolate_pair(
                    V, mu0, state.gmu, state.mu_prevb, state.gmu_prev,
                    tau_cols[None, :], gam2_cols[None, :])
            mu0, r0 = cg.tracked_warm_start(
                V, mu0, gmu_c, tau_cols[None, :], tau_ref,
                gam2_cols[None, :], it, cfg.gram_refresh, multb)
        sol = cg.solve_block(multb, V, mu0, diag_cols, gam2_cols,
                             cfg.cg_max_iter,
                             modes=(0,) * T + (1,) * (T * P_cg),
                             err_tol=cfg.cg_err_tol,
                             onsager_tol=cfg.onsager_tol,
                             plateau=cfg.cg_plateau, precond=precond, r0=r0,
                             rider=x1 if fold_noise else None,
                             rider_mult=rider_mult if fold_noise else None)
        gmu_new = cg.gram_from_exit(V, sol, tau_cols[None, :],
                                    gam2_cols[None, :])
        muT = sol.mu[:, :T]
        invq = sol.mu[:, T:]
        x2 = _keep(live[None, :], muT * mm, state.x2)

        # per-trait Onsager alpha2: SLQ quadrature per (trait, probe)
        # column, or the probe columns' Hutchinson estimate
        if use_slq:
            quad = slq.quad_inv(aux.slq, gamw[cols_tp], gam2_eff[cols_tp])
        else:
            quad = (bern_tp * invq).sum(dim=0)
        alpha2 = gam2_eff * quad.reshape(T, P).mean(dim=1)
        eta2 = gam2 / alpha2
        if cfg.auto_var_max_iter >= 1 and it > 2:
            l2_x2r2 = torch.square((x2 - r2) * mm).sum(dim=0)
            gam2 = _clamp_gamma(1.0 / (1.0 / eta2 + l2_x2r2 / Mt))
        gam1_new = _clamp_gamma(eta2 - gam2)
        r1 = ((eta2[None, :] * x2 - gam2[None, :] * r2)
              / gam1_new[None, :]) * mm

        # noise precision per trait (updateNoisePrec, vamp.cpp:892-927)
        if use_slq:
            trace_corr = slq.quad_ratio(aux.slq, gamw[cols_tp],
                                        gam2_eff[cols_tp]
                                        ).reshape(T, P).mean(dim=1) * Mt
        if fold_noise:
            # the exit Gram identity (tau A^T A mu = V - r - gam2 mu, exact
            # for any mu) and z1 from the rider columns: no pass here
            z1 = sol.rider_out
            rT = sol.r[:, :T]
            quad_t = ((muT * V[:, :T]).sum(dim=0) - (muT * rT).sum(dim=0)
                      - gam2_eff * torch.square(muT).sum(dim=0)) / gamw
            resid2 = torch.clamp(quad_t - 2.0 * (muT * aux.aty).sum(dim=0)
                                 + l2y, min=0.0)
            if not use_slq:
                # the Hutchinson term from the same exit identity
                trq = ((bern_tp * bern_tp).sum(dim=0)
                       - (bern_tp * sol.r[:, T:]).sum(dim=0)
                       - gam2_cols[T:] * (bern_tp * invq).sum(dim=0)
                       ) / tau_cols[T:]
                trace_corr = trq.reshape(T, P).mean(dim=1) * Mt
            R2_2 = 1.0 - resid2 / l2y
        else:
            # one wide pass computes A x2, A invq and the deferred z1 = A x1
            Z2 = axm_fn(op, torch.cat([x2, invq, x1], dim=1), cols_rider)
            ax2 = Z2[..., :T]
            z1 = Z2[..., T + T * P_cg:]
            resid2 = torch.square(ax2 - y).sum(dim=(0, 1))
            if not use_slq:
                tc = (aux.z_bern * Z2[..., T:T + T * P]).sum(dim=(0, 1))
                trace_corr = tc.reshape(T, P).mean(dim=1) * Mt
            R2_2 = 1.0 - torch.square(y - ax2).sum(dim=(0, 1)) / l2y
        gamw_new = N / (resid2 + trace_corr)
        R2_1 = 1.0 - torch.square(y - z1).sum(dim=(0, 1)) / l2y

        rel_change = _rel_change(x1_prev, x1, 1e-300)
        stopped = (state.stopped | (rel_change < cfg.stop_criteria_thr)
                   if it > 1 else state.stopped)

        # freeze all trailing state of stopped traits
        live_all = torch.cat([live, live[tpc]])[None, :]
        new_state = MultiState(
            it=it, x1=x1, x2=x2, r1=_keep(live[None, :], r1, state.r1),
            r2=r2, z1=_keep(live[None, None, :], z1, state.z1),
            mu_cg=_keep(live[None, :], muT, state.mu_cg),
            mu_probe=_keep(live[tpc][None, :], invq, state.mu_probe),
            gam1=_keep(live, gam1_new, state.gam1),
            gam2=_keep(live, gam2, state.gam2),
            gamw=_keep(live, gamw_new, state.gamw),
            eta1=eta1, eta2=_keep(live, eta2, state.eta2),
            alpha1=alpha1, alpha2=_keep(live, alpha2, state.alpha2),
            rho=rho, probs=_keep(live[:, None], probs, state.probs),
            vars=_keep(live[:, None], vars_, state.vars), stopped=stopped,
            gmu=_keep(live_all, gmu_new, state.gmu),
            tau_gmu=_keep(live, gamw, state.tau_gmu),
            # the secant pair rolls on gmu's live mask: frozen traits keep
            # theirs (delta -> 0 disarms the theta guard)
            mu_prevb=(_keep(live_all, mu_start, state.mu_prevb)
                      if cfg.cg_extrapolate else state.mu_prevb),
            gmu_prev=(_keep(live_all, state.gmu, state.gmu_prev)
                      if cfg.cg_extrapolate else state.gmu_prev))
        metrics = {
            "it": it, "gam1": gam1, "gam2": gam2, "gamw": gamw_new,
            "alpha1": alpha1, "alpha2": alpha2, "rho": rho,
            "R2_train_1": R2_1, "R2_train_2": R2_2,
            "rel_change": rel_change, "cg_iters": sol.iters[:T],
            "stopped": stopped,
        }
        return _canonical(new_state), metrics

    return step


# --------------------------------------------------------------------------
# the run loop
# --------------------------------------------------------------------------


def _run_loop(step, state, aux, cfg, mp, name, vprint, callbacks,
              sync_every: int = 1, draws=None):
    """The chunked run loop of the three engines (multi.py:660-704): each
    chunk's metrics on the host in one transfer, then the callbacks and
    the exit when every trait has stopped, once per chunk
    (``linear.run_chunks``).  No exit inside a chunk: its later steps
    leave the stopped traits frozen, and an early exit would part the
    counted iteration from ``state.it`` that the callbacks write."""
    history = []
    for state, ms in run_chunks(step, state, aux, cfg.max_iter, sync_every,
                                draws=draws):
        history += ms
        m = ms[-1]
        if vprint is not None:
            vprint(state.it, m)
        for cb in callbacks or ():
            cb(state.it, state, m, mp.geno)
        if m["stopped"].all():
            if vprint is not None:
                print(f"{name}: all traits met the stopping criterion")
            break
    return state, history


def _fmt(xs, spec):
    return " ".join(format(float(v), spec) for v in xs)


def _finish(mp: MultiPhen, state):
    sqn = float(np.sqrt(mp.geno.N))
    return state.x1[: mp.geno.M].cpu().numpy() / sqn


@trace.spanned("infer", engine="multi")
def infer(mp: MultiPhen, cfg: VampConfig, probs, vars_user,
          verbose: bool = True, callbacks=None, sync_every: int = 1,
          resume_state: MultiState = None, bern=None, defl_v0=None):
    """Run the joint multi-trait linear loop; returns (x_stored [M, T],
    state, history).  ``resume_state`` continues a checkpointed run
    (``cfg.max_iter`` is the total budget); ``sync_every`` > 1 runs that
    many iterations per metrics fetch (``_run_loop``); ``bern`` and
    ``defl_v0`` replace the drawn probe and deflation start block (parity
    tests pass JAX's)."""
    if resume_state is not None:
        _check_resume_probe_cols(resume_state, cfg, mp.T)
    state = (resume_state if resume_state is not None
             else init_state(mp, cfg, probs, vars_user))
    aux = make_aux(mp, cfg, bern=bern, defl_v0=defl_v0)
    step = make_step(mp, cfg)

    def vprint(it, m):
        print(f"[multi it {it}] R2=[{_fmt(m['R2_train_1'], '.4f')}] "
              f"gam1=[{_fmt(m['gam1'], '.3g')}] "
              f"cg=[{' '.join(map(str, m['cg_iters']))}] "
              f"stopped={int(m['stopped'].sum())}/{mp.T}", flush=True)

    state, history = _run_loop(step, state, aux, cfg, mp, "multi",
                               vprint if verbose else None, callbacks,
                               sync_every)
    return _finish(mp, state), state, history


# --------------------------------------------------------------------------
# the z-model engines: multi-trait probit and Huber
# --------------------------------------------------------------------------


class ProbitMultiState(NamedTuple):
    """The fields of ``gvamp_tpu.multi.ProbitMultiState``; ``it`` is a host
    int."""

    it: int
    x1: torch.Tensor        # [Mpad, T]
    x2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    z1: torch.Tensor        # [4, Nb, T]
    z2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    mu_probe: torch.Tensor  # [Mpad, T*P]
    gam1: torch.Tensor      # [T]
    gam2: torch.Tensor
    tau1: torch.Tensor
    tau2: torch.Tensor
    alpha1: torch.Tensor
    probs: torch.Tensor     # [T, L]
    vars: torch.Tensor
    cov_eff: torch.Tensor   # [max(C, 1), T]
    stopped: torch.Tensor   # bool[T]
    mu_cg: torch.Tensor     # [Mpad, T] LMMSE-column CG warm starts
    gmu: torch.Tensor       # [Mpad, T+T*P] tracked warm-start Gram product
    tau_gmu: torch.Tensor   # [T] the per-trait tau2 gmu was stored at


class HuberMultiState(NamedTuple):
    """The fields of ``gvamp_tpu.multi.HuberMultiState`` with the JAX key
    replaced by ``gen``, the CPU generator of em_deltaH's draws (a step
    draws from a copy and returns it); ``it`` is a host int."""

    it: int
    x1: torch.Tensor
    x2: torch.Tensor
    r1: torch.Tensor
    r2: torch.Tensor
    z1: torch.Tensor
    z2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    mu_probe: torch.Tensor
    gam1: torch.Tensor
    gam2: torch.Tensor
    tau1: torch.Tensor
    tau2: torch.Tensor
    alpha1: torch.Tensor
    deltaH: torch.Tensor    # [T]
    probs: torch.Tensor
    vars: torch.Tensor
    gen: torch.Generator
    stopped: torch.Tensor
    mu_cg: torch.Tensor
    gmu: torch.Tensor
    tau_gmu: torch.Tensor


def _zmodel_fields(mp: MultiPhen, cfg, probs, vars_user) -> dict:
    """The initial fields the probit and Huber states share: p1 starts at
    zero and tau2 at one (multi.py:780-802, 1177-1199)."""
    zeros = _zeros(mp)
    Mp, T = mp.geno.Mpad, mp.T
    P = probe_cols(cfg)
    zn = torch.zeros_like(mp.y)
    probs_t, vars_t = _prior_rows(mp, probs, vars_user)
    return dict(
        it=0, x1=zeros(Mp, T), x2=zeros(Mp, T), r1=zeros(Mp, T),
        r2=zeros(Mp, T), z1=zn, z2=zn, p1=zn, p2=zn,
        mu_probe=zeros(Mp, T * P), gam1=_full(mp, cfg.gam1_init),
        gam2=zeros(T), tau1=_full(mp, cfg.gam1_init), tau2=_full(mp, 1.0),
        alpha1=zeros(T), probs=probs_t, vars=vars_t,
        stopped=torch.zeros((T,), dtype=torch.bool, device=mp.geno.device),
        mu_cg=zeros(Mp, T), gmu=zeros(Mp, T * (1 + P)), tau_gmu=zeros(T))


def init_probit_state(mp: MultiPhen, cfg, probs, vars_user,
                      n_cov: int = 0) -> ProbitMultiState:
    return ProbitMultiState(
        cov_eff=_zeros(mp)(max(n_cov, 1), mp.T),
        **_zmodel_fields(mp, cfg, probs, vars_user))


def init_huber_state(mp: MultiPhen, cfg, probs, vars_user) -> HuberMultiState:
    return HuberMultiState(
        deltaH=_full(mp, cfg.deltaH_init),
        gen=robust.make_generator(cfg.seed + 2),
        **_zmodel_fields(mp, cfg, probs, vars_user))


class ProbitMultiAux(NamedTuple):
    """The set-up of the probit and Huber engines."""

    op: MultiOp
    y: torch.Tensor          # [4, Nb, T] filtered
    n_mask: torch.Tensor     # [4, Nb] real individuals
    bern: torch.Tensor       # [Mpad, P]
    Z: torch.Tensor          # covariates planar-dense [4 Nb, max(C, 1)]
    m_mask: torch.Tensor
    slq: Optional[slq.SlqBasis]  # T*P columns (see MultiAux.slq)
    defl: Optional[tuple] = None


def make_probit_aux(mp: MultiPhen, cfg, bern=None,
                    defl_v0=None) -> ProbitMultiAux:
    """Set-up of the z-model engines: covariates, the probe, the deflation
    basis and, unless the probe columns carry the trace, the SLQ basis."""
    geno = mp.geno
    C = geno.covs.shape[1] if geno.covs is not None else 0
    nb4 = geno.y_planar.numel()
    Z = (geno.covs_planar().reshape(nb4, C) if C > 0
         else torch.zeros((nb4, 1), dtype=geno.dtype, device=geno.device))
    bern = _bern(mp, cfg, bern)
    return ProbitMultiAux(
        op=mp.op, y=mp.filter_pheno(), n_mask=geno.n_mask_planar, bern=bern,
        Z=Z, m_mask=geno.m_mask,
        slq=make_slq_basis(mp, cfg, bern) if slq_on(cfg) else None,
        defl=make_deflation(mp, cfg, defl_v0))


def _x_denoise(mp: MultiPhen, cfg, state, m_mask, it: int, live):
    """The x-denoiser of the z-model engines (multi.py:806-864): the
    re-estimation loop from eta1 = 0, damping at the fixed cfg.rho, and
    x1 / gam1 frozen on stopped traits; then gam2 and r2.  Returns (x1,
    alpha1, probs, vars, gam2, r2)."""
    x1, gam1, alpha1, eta1, probs, vars_ = _revar(
        mp, cfg, state, m_mask, it, torch.zeros_like(state.gam1))
    if it > 1:
        rho = torch.as_tensor(cfg.rho, dtype=x1.dtype, device=x1.device)
        x1 = rho * x1 + (1 - rho) * state.x1
        alpha1 = rho * alpha1 + (1 - rho) * state.alpha1
    x1 = _keep(live[None, :], x1, state.x1)
    gam1 = _keep(live, gam1, state.gam1)
    gam2 = _clamp_gamma(eta1 - gam1)
    r2 = ((eta1[None, :] * x1 - gam1[None, :] * state.r1)
          / gam2[None, :]) * m_mask[:, None]
    return x1, alpha1, probs, vars_, gam2, r2


def _make_zmodel_lmmse(mp: MultiPhen, cfg):
    """The z-model LMMSE tail (multi.py:867-959): one block CG of T (+ T*P)
    columns, the SLQ or probe-column alpha2 clipped into
    [1e-11, 1 - 100 eps], the x and z extrinsic updates, and z2 = A x2 from
    one forward pass."""
    Mt = float(mp.geno.Mt)
    N = float(mp.geno.N)
    T, P = mp.T, cfg.n_probes
    axm_fn, atxm_fn = mp.fns()
    gram_fn = mp.fn_gram()
    P_cg = probe_cols(cfg)
    use_slq = slq_on(cfg)
    cols_tpc = np.repeat(np.arange(T), P_cg)
    tpc = mp.cols(cols_tpc)
    cols_t = mp.cols(np.arange(T))
    cols_tp = mp.cols(np.repeat(np.arange(T), P))
    cols_all = mp.cols(np.concatenate([np.arange(T), cols_tpc]))
    nb = mp.y.shape[1]

    def lmmse(state, aux, it: int, p2f, tau2, gam2, r2):
        op, m_mask = aux.op, aux.m_mask
        mm = m_mask[:, None]
        v = (tau2[None, :] * atxm_fn(op, p2f.reshape(4, nb, T), cols_t)
             + gam2[None, :] * r2)
        tau_cols = torch.cat([tau2, tau2[tpc]])
        gam2_cols = torch.cat([gam2, gam2[tpc]])
        diag_cols = (tau_cols * (N - 1.0) / N + gam2_cols)[None, :]

        def multb(Pk):
            if gram_fn is not None:
                return (tau_cols[None, :] * gram_fn(op, Pk, cols_all)
                        + gam2_cols[None, :] * Pk)
            return (tau_cols[None, :]
                    * atxm_fn(op, axm_fn(op, Pk, cols_all), cols_all)
                    + gam2_cols[None, :] * Pk)

        bern_tp = aux.bern[:, :P_cg].repeat(1, T)
        V = torch.cat([v, bern_tp], dim=1)
        warm = cfg.gram_refresh > 1
        mu0 = torch.cat([state.mu_cg if warm else torch.zeros_like(v),
                         state.mu_probe], dim=1)
        precond = None
        if aux.defl is not None:
            precond = cg.make_deflated_precond(
                aux.defl[0], aux.defl[1], tau_cols, gam2_cols, diag_cols)
        r0 = None
        if warm:
            # every column warm-starts from the previous solve with the
            # tracked Gram product (guards in cg.tracked_warm_start)
            tau_ref = torch.cat([state.tau_gmu, state.tau_gmu[tpc]])[None, :]
            mu0, r0 = cg.tracked_warm_start(
                V, mu0, state.gmu, tau_cols[None, :], tau_ref,
                gam2_cols[None, :], it, cfg.gram_refresh, multb)
        sol = cg.solve_block(multb, V, mu0, diag_cols, gam2_cols,
                             cfg.cg_max_iter,
                             modes=(0,) * T + (1,) * (T * P_cg),
                             err_tol=cfg.cg_err_tol,
                             onsager_tol=cfg.onsager_tol,
                             plateau=cfg.cg_plateau, precond=precond, r0=r0)
        gmu_new = cg.gram_from_exit(V, sol, tau_cols[None, :],
                                    gam2_cols[None, :])
        x2 = sol.mu[:, :T] * mm
        # per-(trait, probe) SLQ quadrature at this iteration's shifts, or
        # the probe columns' Hutchinson estimate
        if use_slq:
            quad = slq.quad_inv(aux.slq, tau2[cols_tp], gam2[cols_tp])
        else:
            quad = (bern_tp * sol.mu[:, T:]).sum(dim=0)
        alpha2 = gam2 * quad.reshape(T, P).mean(dim=1)
        eps1 = 100.0 * torch.finfo(alpha2.dtype).eps
        alpha2 = torch.clamp(alpha2, 1e-11, 1.0 - eps1)
        eta2 = gam2 / alpha2
        if it > 1:
            l2x2r2 = torch.square((x2 - r2) * mm).sum(dim=0)
            gam2 = _clamp_gamma(1.0 / (1.0 / eta2 + l2x2r2 / Mt))
        r1 = ((x2 - alpha2[None, :] * r2) / (1.0 - alpha2)[None, :]) * mm
        gam1_new = gam2 * (1.0 - alpha2) / alpha2
        z2 = axm_fn(op, x2, cols_t)
        return dict(sol=sol, x2=x2, invq=sol.mu[:, T:], alpha2=alpha2,
                    gam2=gam2, r1=r1, gam1_new=gam1_new, z2=z2,
                    beta2=Mt / N * (1.0 - alpha2), gmu=gmu_new)

    return lmmse


def _zmodel_finish(mp: MultiPhen, cfg, state, w, it: int, x1_prev, x1,
                   live, nmf):
    """tau2, p1 and tau1 from z2 (multi.py:1034-1053), the --stab-gamma
    trust region, the stopping test, and the fields both z-model states
    share, each frozen on stopped traits."""
    N = float(mp.geno.N)
    T = mp.T
    p2f, tau2, beta2 = w["p2f"], w["tau2"], w["beta2"]
    z2f = w["z2"].reshape(-1, T)
    zeta2 = tau2 / beta2
    l2z2p2 = (torch.square(z2f - p2f) * nmf[:, None]).sum(dim=0)
    tau2_new = 1.0 / (1.0 / zeta2 + l2z2p2 / N) if it > 1 else tau2
    p1_new = ((z2f - beta2[None, :] * p2f)
              / (1.0 - beta2)[None, :]) * nmf[:, None]
    tau1_new = _clamp_gamma(tau2_new * (1.0 - beta2) / beta2)
    gam1_new = w["gam1_new"]
    if cfg.stab_gamma < 1.0:
        gam1_new = probit.geo_damp(gam1_new, state.gam1, cfg.stab_gamma,
                                   it > 1)
        tau1_new = probit.geo_damp(tau1_new, state.tau1, cfg.stab_gamma,
                                   it > 1)
    rel_change = _rel_change(x1_prev, x1, 1e-30)
    stopped = (state.stopped | (rel_change < cfg.stop_criteria_thr)
               if it > 1 else state.stopped)
    tpc = mp.cols(np.repeat(np.arange(T), probe_cols(cfg)))
    live_all = torch.cat([live, live[tpc]])[None, :]
    lc, lp = live[None, :], live[None, None, :]
    shape = state.p1.shape
    fields = dict(
        it=it, x1=x1, x2=_keep(lc, w["x2"], state.x2),
        r1=_keep(lc, w["r1"], state.r1), r2=w["r2"],
        z1=_keep(lp, w["z1f"].reshape(shape), state.z1),
        z2=_keep(lp, w["z2"], state.z2),
        p1=_keep(lp, p1_new.reshape(shape), state.p1),
        p2=p2f.reshape(shape),
        mu_probe=_keep(live[tpc][None, :], w["invq"], state.mu_probe),
        gam1=_keep(live, gam1_new, state.gam1),
        gam2=_keep(live, w["gam2"], state.gam2),
        tau1=_keep(live, tau1_new, state.tau1),
        tau2=_keep(live, tau2_new, state.tau2), alpha1=w["alpha1"],
        probs=_keep(live[:, None], w["probs"], state.probs),
        vars=_keep(live[:, None], w["vars"], state.vars), stopped=stopped,
        mu_cg=_keep(lc, w["sol"].mu[:, :T], state.mu_cg),
        gmu=_keep(live_all, w["gmu"], state.gmu),
        tau_gmu=_keep(live, tau2, state.tau_gmu))
    metrics = {
        "it": it, "gam1": gam1_new, "gam2": w["gam2"], "tau1": tau1_new,
        "tau2": tau2_new, "alpha1": w["alpha1"], "alpha2": w["alpha2"],
        "beta1": w["beta1"], "rel_change": rel_change,
        "cg_iters": w["sol"].iters[:T], "stopped": stopped,
    }
    return fields, metrics


def _newton_multi(yf, gg, Z, cov_eff, nmf, cfg):
    """The covariate Newton solve of each trait (vmapped in
    multi.py:977-1003, where each lane runs its own loops): one
    ``probit.newton_cov`` per trait, [C, T]."""
    return torch.stack([probit.newton_cov(
        yf[:, t], gg[:, t], Z, torch.zeros_like(cov_eff[:, t]), nmf,
        probit_var=cfg.probit_var, max_iter=cfg.newton_max_iter)
        for t in range(yf.shape[1])], dim=1)


def make_probit_step(mp: MultiPhen, cfg, n_cov: int = 0):
    """The per-iteration multi-trait probit step (multi.py:962-1086)."""
    N = float(mp.geno.N)
    T = mp.T
    pv = cfg.probit_var
    lmmse = _make_zmodel_lmmse(mp, cfg)

    def step(state: ProbitMultiState, aux: ProbitMultiAux):
        m_mask = aux.m_mask
        nmf = aux.n_mask.reshape(-1)
        yf = aux.y.reshape(-1, T)
        it = state.it + 1
        live = ~state.stopped

        # covariate effects at iteration 1 (vamp_probit.cpp:110-126)
        cov_eff = state.cov_eff
        if n_cov > 0:
            if it == 1:
                cov_eff = _newton_multi(yf, state.z1.reshape(-1, T), aux.Z,
                                        cov_eff, nmf, cfg)
            m_cov = (aux.Z @ cov_eff) * nmf[:, None]
        else:
            m_cov = torch.zeros_like(yf)

        x1, alpha1, probs, vars_, gam2, r2 = _x_denoise(
            mp, cfg, state, m_mask, it, live)

        # z-denoising (vamp_probit.cpp:330-460)
        p1f = state.p1.reshape(-1, T)
        tau1 = state.tau1
        z1f = probit.g1_bin_class(p1f, tau1[None, :], yf, m_cov,
                                  pv) * nmf[:, None]
        beta1 = (probit.g1d_bin_class(p1f, tau1[None, :], yf, m_cov, pv)
                 * nmf[:, None]).sum(dim=0) / N
        zeta1 = tau1 / beta1
        l2zp = (torch.square(z1f - p1f) * nmf[:, None]).sum(dim=0)
        if it > 1:
            tau1 = _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N))
        p2f = ((z1f - beta1[None, :] * p1f)
               / (1.0 - beta1)[None, :]) * nmf[:, None]
        tau2 = _clamp_gamma(tau1 * (1.0 - beta1) / beta1)

        w = lmmse(state, aux, it, p2f, tau2, gam2, r2)
        w.update(p2f=p2f, tau2=tau2, z1f=z1f, r2=r2, alpha1=alpha1,
                 probs=probs, vars=vars_, beta1=beta1)
        fields, metrics = _zmodel_finish(mp, cfg, state, w, it, state.x1,
                                         x1, live, nmf)
        metrics.update(beta2=w["beta2"], cov_eff=cov_eff)
        return _canonical(ProbitMultiState(cov_eff=cov_eff, **fields)), metrics

    return step


def make_huber_step(mp: MultiPhen, cfg):
    """The per-iteration multi-trait Huber step (multi.py:1202-1316):
    (state, aux, eps=None) -> (state, metrics); ``eps`` [T, mc, 4 Nb]
    replaces the draws from ``state.gen``."""
    N = float(mp.geno.N)
    T = mp.T
    lmmse = _make_zmodel_lmmse(mp, cfg)

    def step(state: HuberMultiState, aux: ProbitMultiAux, eps=None):
        m_mask = aux.m_mask
        nmf = aux.n_mask.reshape(-1)
        yf = aux.y.reshape(-1, T)
        it = state.it + 1
        live = ~state.stopped

        x1, alpha1, probs, vars_, gam2, r2 = _x_denoise(
            mp, cfg, state, m_mask, it, live)

        # z-denoising with the Huber proximal (vamp_Huber.cpp:225-262)
        p1f = state.p1.reshape(-1, T)
        tau1, delta = state.tau1, state.deltaH
        z1f = robust.g1_huber(p1f, tau1[None, :], delta[None, :],
                              yf) * nmf[:, None]
        beta1 = (robust.g1d_huber_der(p1f, tau1[None, :], delta[None, :], yf)
                 * nmf[:, None]).sum(dim=0) / N
        zeta1 = tau1 / beta1
        l2zp = (torch.square(z1f - p1f) * nmf[:, None]).sum(dim=0)
        if it >= 2:
            tau1 = _clamp_gamma(1.0 / (1.0 / zeta1 + l2zp / N))
        # deltaH per trait from its own draws: T blocks of [mc, 4 Nb] from
        # one generator, trait by trait
        gen = state.gen
        if eps is None:
            gen = torch.Generator(device="cpu")
            gen.set_state(state.gen.get_state())
            eps = [torch.randn((cfg.mc_steps, p1f.shape[0]), generator=gen,
                               dtype=p1f.dtype) for _ in range(T)]
        delta = torch.stack([robust.em_deltaH(
            torch.as_tensor(eps[t], dtype=p1f.dtype).to(p1f.device),
            p1f[:, t], tau1[t], yf[:, t], nmf) for t in range(T)])
        p2f = ((z1f - beta1[None, :] * p1f)
               / (1.0 - beta1)[None, :]) * nmf[:, None]
        tau2 = _clamp_gamma(tau1 * (1.0 - beta1) / beta1)

        w = lmmse(state, aux, it, p2f, tau2, gam2, r2)
        w.update(p2f=p2f, tau2=tau2, z1f=z1f, r2=r2, alpha1=alpha1,
                 probs=probs, vars=vars_, beta1=beta1)
        fields, metrics = _zmodel_finish(mp, cfg, state, w, it, state.x1,
                                         x1, live, nmf)
        metrics["deltaH"] = delta
        return _canonical(HuberMultiState(
            deltaH=_keep(live, delta, state.deltaH), gen=gen,
            **fields)), metrics

    return step


@trace.spanned("infer", engine="multi_probit")
def infer_probit(mp: MultiPhen, cfg, probs, vars_user, verbose: bool = True,
                 callbacks=None, sync_every: int = 1, resume_state=None,
                 bern=None, defl_v0=None):
    """Joint multi-trait probit run; returns (x_stored [M, T], state,
    history).  ``bern`` and ``defl_v0`` as in ``infer``."""
    n_cov = mp.geno.covs.shape[1] if mp.geno.covs is not None else 0
    if resume_state is not None:
        _check_resume_probe_cols(resume_state, cfg, mp.T)
    state = (resume_state if resume_state is not None
             else init_probit_state(mp, cfg, probs, vars_user, n_cov=n_cov))
    aux = make_probit_aux(mp, cfg, bern=bern, defl_v0=defl_v0)

    def vprint(it, m):
        print(f"[multi-probit it {it}] gam1=[{_fmt(m['gam1'], '.3g')}] "
              f"beta1=[{_fmt(m['beta1'], '.3g')}] "
              f"stopped={int(m['stopped'].sum())}/{mp.T}", flush=True)

    state, history = _run_loop(make_probit_step(mp, cfg, n_cov=n_cov),
                               state, aux, cfg, mp, "multi-probit",
                               vprint if verbose else None, callbacks,
                               sync_every)
    return _finish(mp, state), state, history


@trace.spanned("infer", engine="multi_huber")
def infer_huber(mp: MultiPhen, cfg, probs, vars_user, verbose: bool = True,
                callbacks=None, sync_every: int = 1, resume_state=None,
                bern=None, defl_v0=None, mc_draws=None):
    """Joint multi-trait Huber run; returns (x_stored [M, T], state,
    history).  ``mc_draws`` (an iterable of per-iteration [T, mc, 4 Nb]
    draws) replaces the state's generator (parity tests pass JAX's)."""
    if resume_state is not None:
        _check_resume_probe_cols(resume_state, cfg, mp.T)
    state = (resume_state if resume_state is not None
             else init_huber_state(mp, cfg, probs, vars_user))
    aux = make_probit_aux(mp, cfg, bern=bern, defl_v0=defl_v0)

    def vprint(it, m):
        print(f"[multi-huber it {it}] gam1=[{_fmt(m['gam1'], '.3g')}] "
              f"deltaH=[{_fmt(m['deltaH'], '.2g')}] "
              f"stopped={int(m['stopped'].sum())}/{mp.T}", flush=True)

    state, history = _run_loop(make_huber_step(mp, cfg), state, aux, cfg,
                               mp, "multi-huber", vprint if verbose else None,
                               callbacks, sync_every,
                               iter(mc_draws) if mc_draws is not None
                               else None)
    return _finish(mp, state), state, history
