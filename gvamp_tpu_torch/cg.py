"""Warm-started Jacobi-preconditioned block conjugate gradient (marker space).

Port of ``gvamp_tpu/cg.py``: ``solve_block`` with its rider, its
forward-product tracking (the z-model engines' z2 = A x2) and an optional
preconditioner in place of Jacobi, the tracked and secant-extrapolated
warm starts, the exit Gram identity, the LMMSE operator (two passes, or
the fused Gram where ``fn_gram`` gives one), and spectral deflation
(``top_eigs`` and ``make_deflated_precond``).  The solver's ``lax.while_loop``
is a Python loop: its exit test reads the per-column done flags on the host,
one counted sync per CG iteration (``gvamp_tpu_torch.sync``); the
``lax.cond`` of ``tracked_warm_start`` is one more sync per solve.  Column
freezing and the exit semantics are those of ``cg.py:213-258``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from gvamp_tpu_torch.sync import host_bool
from gvamp_tpu_torch.trace import annotate, spanned


class CGResult(NamedTuple):
    mu: torch.Tensor
    iters: torch.Tensor                    # int32 [B] per-column iterations
    rel_err: torch.Tensor                  # [B]
    r: torch.Tensor                        # final residual V - Q mu
    rider_out: Optional[torch.Tensor] = None  # A @ rider (first iteration)
    zmu: Optional[torch.Tensor] = None     # tracked A @ mu[:, 0] (fwd_mult)


@spanned("cg.solve")
def solve_block(
    mult_block: Callable[[torch.Tensor], torch.Tensor],
    V: torch.Tensor,          # [M, B] right-hand sides
    mu_start: torch.Tensor,   # [M, B]
    diag,                     # scalar or [M] Jacobi preconditioner
    gam2,
    max_iter: int,
    modes: tuple,             # per column: 0 = residual exit, 1 = onsager exit
    err_tol: float = 1e-5,
    onsager_tol: float = 1e-8,
    r0: Optional[torch.Tensor] = None,  # precomputed V - mult(mu_start)
    rider: Optional[torch.Tensor] = None,  # [M, R] columns whose forward
                                           # product rides iteration 1
    rider_mult=None,          # (P, X) -> (Q P, A X); required with rider
    plateau: int = 0,         # windowed stagnation exit (cg.py:136-152)
    start_zero: bool = False,  # mu_start is 0: r0 = V, no init mult
    fwd_mult=None,            # P -> (Q P, A P): replaces mult_block and
                              # tracks zmu = A mu[:, 0] through the
                              # recursion (zmu += alpha_0 A p_0)
    zmu0: Optional[torch.Tensor] = None,  # A @ mu_start[:, 0] (fwd_mult)
    precond=None,             # R[M, B] -> Z[M, B], replaces the Jacobi step
                              # (make_deflated_precond)
) -> CGResult:
    """Batched CG: each column runs its own recursion, every iteration costs
    one wide pass; converged columns freeze (alpha = 0) while the rest keep
    iterating, and the loop exits when all columns are done."""
    if rider is not None and fwd_mult is not None:
        raise ValueError("rider and fwd_mult tracking are mutually exclusive")
    if fwd_mult is not None and zmu0 is None:
        raise ValueError("fwd_mult tracking requires zmu0 = A @ mu_start[:, 0]")
    dt, dev = V.dtype, V.device
    B = V.shape[1]
    modes_t = torch.as_tensor(list(modes), dtype=torch.int32, device=dev)
    diag_c = torch.as_tensor(diag, dtype=dt, device=dev)
    diag_c = diag_c[:, None] if diag_c.ndim == 1 else diag_c
    gam2_b = torch.as_tensor(gam2, dtype=dt, device=dev) * torch.ones(
        (B,), dtype=dt, device=dev)

    def apply_m(r):
        return r / diag_c

    if precond is not None:
        apply_m = precond

    if r0 is None:
        r0 = V if start_zero else V - mult_block(mu_start)
    z0 = apply_m(r0)
    norm_v2 = torch.square(V).sum(dim=0)
    norm_v = torch.sqrt(torch.where(norm_v2 == 0, 1.0, norm_v2))

    # the loop state of cg.py's S tuple; win_best starts at inf so the first
    # window boundary only records a baseline
    s = dict(i=0, mu=mu_start, r=r0, z=z0, p=z0, rz=(r0 * z0).sum(dim=0),
             prev_ons=torch.zeros((B,), dtype=dt, device=dev),
             rel_err=torch.full((B,), float("inf"), dtype=dt, device=dev),
             done=torch.zeros((B,), dtype=torch.bool, device=dev),
             iters=torch.zeros((B,), dtype=torch.int32, device=dev),
             best=torch.sqrt(torch.square(r0).sum(dim=0)) / norm_v,
             win_best=torch.full((B,), float("inf"), dtype=dt, device=dev),
             zmu=zmu0)

    def body_with(s, d, ap=None):
        pd = (d * s["p"]).sum(dim=0)
        alpha = torch.where(s["done"] | (pd == 0), 0.0,
                            s["rz"] / torch.where(pd == 0, 1.0, pd))
        mu = s["mu"] + alpha[None, :] * s["p"]
        ons = gam2_b * (V * mu).sum(dim=0)
        ons_rel = torch.where(ons != 0, torch.abs((ons - s["prev_ons"]) / ons),
                              1.0)
        r = s["r"] - alpha[None, :] * d
        z = apply_m(r)
        rz_new = (r * z).sum(dim=0)
        beta = torch.where(s["done"] | (s["rz"] == 0), 0.0,
                           rz_new / torch.where(s["rz"] == 0, 1.0, s["rz"]))
        p = z + beta[None, :] * s["p"]
        rel_err = torch.sqrt(torch.square(r).sum(dim=0)) / norm_v
        done = s["done"] | torch.where(modes_t == 1, ons_rel < onsager_tol,
                                       rel_err < err_tol)
        best = torch.minimum(s["best"], rel_err)
        win_best = s["win_best"]
        if plateau > 0 and (s["i"] + 1) % plateau == 0:
            done = done | (best > 0.7 * s["win_best"])
            win_best = best
        zmu = s["zmu"] if ap is None else s["zmu"] + alpha[0] * ap[..., 0]
        return dict(i=s["i"] + 1, mu=mu, r=r, z=z, p=p, rz=rz_new,
                    prev_ons=ons, rel_err=rel_err, done=done,
                    iters=s["iters"] + (~s["done"]).to(torch.int32),
                    best=best, win_best=win_best, zmu=zmu)

    ax_rider = None
    if rider is not None:
        # peel iteration 1: the same recursion, with the rider columns on the
        # wide forward pass (frozen columns take alpha = 0 steps, so peeling
        # is exact even when the warm start already meets every exit test)
        d0, ax_rider = rider_mult(s["p"], rider)
        s = body_with(s, d0)
    while s["i"] < max_iter and not host_bool(s["done"].all()):
        if fwd_mult is not None:
            s = body_with(s, *fwd_mult(s["p"]))
        else:
            s = body_with(s, mult_block(s["p"]))
    annotate("cg.solve", steps=s["i"])
    return CGResult(mu=s["mu"], iters=s["iters"], rel_err=s["rel_err"],
                    r=s["r"], rider_out=ax_rider,
                    zmu=s["zmu"] if fwd_mult is not None else None)


@spanned("cg.warm_start")
def tracked_warm_start(V, mu0_raw, gmu_raw, tau_now, tau_ref, gam2_cols,
                       it: int, refresh: int, multb):
    """Safe CG warm start from a tracked Gram product: (mu0, r0).  The
    guards of ``gvamp_tpu/cg.py:264-291``: a true init mult (warm start
    kept) on refresh ticks, a cold or stale tracked product, or non-finite
    carried state; an all-zero warm start never pays the mult."""
    finite = torch.isfinite(mu0_raw).all() & torch.isfinite(gmu_raw).all()
    mu0 = torch.where(finite, mu0_raw, torch.zeros_like(mu0_raw))
    zero = (mu0 == 0).all()
    gmu = torch.where(finite & ~zero, gmu_raw, torch.zeros_like(gmu_raw))
    tau_now_t = torch.as_tensor(tau_now)
    tau_ref_t = torch.as_tensor(tau_ref)
    stale = ((tau_ref_t <= 0) | (tau_now_t > 4.0 * tau_ref_t)).any()
    cold = (gmu == 0).all() & (mu0 != 0).any()
    need_mult = ((it % refresh == 0) | cold | stale) & ~zero
    if host_bool(need_mult):
        return mu0, V - multb(mu0)
    return mu0, V - (tau_now * gmu + gam2_cols * mu0)


@spanned("cg.warm_start")
def tracked_warm_start_fwd(V, mu0_raw, gmu_raw, zmu_raw, tau_now, tau_ref,
                           gam2_cols, it: int, refresh: int, multb_fwd):
    """``tracked_warm_start`` plus the carried forward product
    zmu = A mu0[:, 0] (``gvamp_tpu/cg.py:294-321``): the same guards, and
    the true init mult on a refresh tick also refreshes zmu from its
    forward half.  Returns (mu0, r0, zmu0)."""
    finite = (torch.isfinite(mu0_raw).all() & torch.isfinite(gmu_raw).all()
              & torch.isfinite(zmu_raw).all())
    mu0 = torch.where(finite, mu0_raw, torch.zeros_like(mu0_raw))
    zero = (mu0 == 0).all()
    gmu = torch.where(finite & ~zero, gmu_raw, torch.zeros_like(gmu_raw))
    zmu = torch.where(finite & ~zero, zmu_raw, torch.zeros_like(zmu_raw))
    tau_now_t = torch.as_tensor(tau_now)
    tau_ref_t = torch.as_tensor(tau_ref)
    stale = ((tau_ref_t <= 0) | (tau_now_t > 4.0 * tau_ref_t)).any()
    cold = (gmu == 0).all() & (mu0 != 0).any()
    need_mult = ((it % refresh == 0) | cold | stale) & ~zero
    if host_bool(need_mult):
        qp, ap = multb_fwd(mu0)
        return mu0, V - qp, ap[..., 0]
    return mu0, V - (tau_now * gmu + gam2_cols * mu0), zmu


def extrapolate_pair(V, mu1, gmu1, mu2, gmu2, tau_now, gam2_cols,
                     theta_max: float = 1.5):
    """Least-squares secant extrapolation of the tracked warm start
    (``gvamp_tpu/cg.py:323-364``): mu0 = mu1 + theta (mu1 - mu2) with the
    per-column theta minimising the init residual, clamped to
    [0, theta_max]; theta = 0 on a non-finite or all-zero previous pair or
    a degenerate direction.  Returns (mu0, gmu0)."""
    ok = (torch.isfinite(mu2).all() & torch.isfinite(gmu2).all()
          & (mu2 != 0).any() & (gmu2 != 0).any())
    dmu = mu1 - mu2
    dg = gmu1 - gmu2
    a = V - (tau_now * gmu1 + gam2_cols * mu1)
    b = tau_now * dg + gam2_cols * dmu
    ab = (a * b).sum(dim=0)
    bb = (b * b).sum(dim=0)
    tiny = torch.finfo(V.dtype).tiny
    theta = torch.where(ok & (bb > tiny),
                        torch.clamp(ab / torch.where(bb > tiny, bb, 1.0),
                                    0.0, theta_max),
                        0.0)
    return mu1 + theta[None, :] * dmu, gmu1 + theta[None, :] * dg


def gram_from_exit(V, sol: CGResult, tau_now, gam2_cols):
    """Pure Gram product of ``sol.mu`` from the CG exit residual:
    mult(mu) = V - r, so gram(mu) = (V - r - gam2 mu) / tau (guarded)."""
    dt = V.dtype
    tau_safe = torch.clamp(torch.as_tensor(tau_now, dtype=dt, device=V.device),
                           min=torch.finfo(dt).tiny ** 0.5)
    return (V - sol.r - gam2_cols * sol.mu) / tau_safe


def make_lmmse_mult_block(axm_fn, atxm_fn, op, tau, gam2, gram_fn=None):
    """P[M, B] -> tau A^T(A P) + gam2 P: two passes over the words, or one
    through ``gram_fn`` (``GenoBed.fn_gram``, the fused primal Gram)."""
    if gram_fn is not None:
        def mult(P):
            return tau * gram_fn(op, P) + gam2 * P
        return mult

    def mult(P):
        return tau * atxm_fn(op, axm_fn(op, P)) + gam2 * P

    return mult


def make_lmmse_mult_block_fwd(axm_fn, atxm_fn, op, tau, gam2):
    """Two-pass LMMSE operator exposing the forward intermediate:
    P -> (tau A^T(A P) + gam2 P, A P), for solve_block's fwd_mult."""

    def mult(P):
        Z = axm_fn(op, P)
        return tau * atxm_fn(op, Z) + gam2 * P, Z

    return mult


def make_lmmse_mult_block_rider(axm_fn, atxm_fn, op, tau, gam2):
    """(P, X) -> (tau A^T(A P) + gam2 P, A X): the riders X share the
    forward pass; the transpose pass reads the words for P alone."""

    def mult(P, X):
        B = P.shape[1]
        Z = axm_fn(op, torch.cat([P, X], dim=1))
        return tau * atxm_fn(op, Z[..., :B]) + gam2 * P, Z[..., B:]

    return mult


def jacobi_diag(tau, gam2, N):
    """tau (N-1)/N + gam2: the LMMSE operator's diagonal under marker
    standardisation (reference vamp.cpp:1137-1139)."""
    return tau * (N - 1.0) / N + gam2


def top_eigs(mult_ata, m: int, k: int, seed: int = 1, n_iter: int = 8,
             dtype=torch.float32, device="cpu", V0=None):
    """Top-k eigenpairs of the fixed Gram S = A^T A by orthogonal (block
    power) iteration (``gvamp_tpu/cg.py:438-476``): k columns ride each
    wide pass, n_iter + 1 passes in all.  ``mult_ata(V[m, k])`` applies S.
    The start block V0 [m, k], unless given (parity tests pass JAX's), is
    drawn from a CPU generator seeded by the probe's rule
    (``linear.make_bern_probe``) with the low word 2^32 - 9 in place of the
    shard offset (JAX folds 7 into ``key(seed)``, a stream torch cannot
    reproduce).  The QR factorisations and the skinny products are torch
    calls, as the JAX package computes them outside any kernel.  Returns
    (V [m, k] orthonormal, lam [k])."""
    if V0 is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(((seed & 0xFFFFFFFF) << 32) | 0xFFFFFFF7)
        V0 = torch.randn((m, k), generator=gen, dtype=dtype)
    if not isinstance(V0, torch.Tensor):
        V0 = torch.tensor(V0)
    V = V0.to(dtype=dtype, device=device)
    V, _ = torch.linalg.qr(V)
    for _ in range(n_iter):
        V, _ = torch.linalg.qr(mult_ata(V))
    lam = (V * mult_ata(V)).sum(dim=0)
    return V, lam


def make_deflated_precond(V, lam, tau, gam2, diag):
    """Deflation preconditioner for Q = tau S + gam2 I from top eigenpairs
    of S (``gvamp_tpu/cg.py:479-507``): the exact inverse on span(V),
    Jacobi on the complement,

        M^{-1} r = V ((V^T r) / (tau lam + gam2)) + (r - V V^T r) / diag.

    ``tau`` / ``gam2`` scalars, or per-column [B] vectors (one operator
    per column over the shared V, lam)."""
    tau = torch.as_tensor(tau, dtype=lam.dtype, device=lam.device)
    gam2 = torch.as_tensor(gam2, dtype=lam.dtype, device=lam.device)
    if tau.ndim or gam2.ndim:
        inv_eig = 1.0 / (tau.reshape(1, -1) * lam[:, None]
                         + gam2.reshape(1, -1))        # [k, B]
    else:
        inv_eig = (1.0 / (tau * lam + gam2))[:, None]  # [k, 1]

    def apply(r):
        c = V.T @ r
        return V @ (c * inv_eig) + (r - V @ c) / diag

    return apply
