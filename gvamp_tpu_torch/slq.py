"""Stochastic Lanczos quadrature for the Onsager trace estimator.

Port of ``gvamp_tpu/slq.py``: tridiagonalise the fixed Gram ``G = A^T A``
once in the Krylov space of each probe (k block passes at set-up), then
every iteration's bilinear forms ``u^T f(G) u`` with
``f(lam) = 1/(tau lam + gam2)`` or ``lam/(tau lam + gam2)`` are O(k) vector
math with no pass over the packed matrix.  The ``lax.scan`` over the k steps
is a Python loop; nothing in it reads a device value on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gvamp_tpu_torch.trace import spanned


class SlqBasis(NamedTuple):
    """Gauss-quadrature view of C independent Krylov spaces."""

    lam: torch.Tensor     # [C, k] Ritz values (quadrature nodes), >= 0
    wts: torch.Tensor     # [C, k] (e1 . eigvec)^2 quadrature weights
    unorm2: torch.Tensor  # [C] squared norms of the start vectors


def lanczos_block(mult, U: torch.Tensor, k: int):
    """k-step Lanczos on C columnwise SPD operators, fully reorthogonalised
    (two rounds of classical Gram-Schmidt per step).  Returns
    (alphas [k, C], betas [k, C], unorm2 [C])."""
    n, C = U.shape
    unorm2 = torch.square(U).sum(dim=0)
    inv0 = torch.where(unorm2 > 0,
                       1.0 / torch.sqrt(torch.where(unorm2 == 0, 1.0, unorm2)),
                       0.0)
    v = U * inv0[None, :]
    v_prev = torch.zeros_like(v)
    beta_prev = torch.zeros((C,), dtype=U.dtype, device=U.device)
    basis = torch.zeros((k, n, C), dtype=U.dtype, device=U.device)
    floor = 1e-7 * torch.sqrt(torch.clamp(unorm2, min=1e-30))
    alphas, betas = [], []
    for j in range(k):
        w = mult(v)
        alpha = (w * v).sum(dim=0)
        w = w - alpha[None, :] * v - beta_prev[None, :] * v_prev
        for _ in range(2):
            proj = torch.einsum("knc,nc->kc", basis, w)
            w = w - torch.einsum("knc,kc->nc", basis, proj)
        beta = torch.sqrt(torch.square(w).sum(dim=0))
        tiny = beta <= floor
        beta = torch.where(tiny, 0.0, beta)
        v_next = torch.where(tiny[None, :], 0.0,
                             w / torch.where(tiny, 1.0, beta)[None, :])
        basis[j] = v
        v_prev, v, beta_prev = v, v_next, beta
        alphas.append(alpha)
        betas.append(beta)
    return torch.stack(alphas), torch.stack(betas), unorm2


def _tridiag(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense [C, k, k] symmetric tridiagonal from a [C, k], b[:, :k-1]."""
    C, k = a.shape
    T = torch.diag_embed(a)
    if k > 1:
        off = torch.diag_embed(b[:, :k - 1], offset=1)
        T = T + off + off.transpose(1, 2)
    return T


def nodes_weights(alphas, betas):
    """(lam [C, k] clamped >= 0, wts [C, k]) from the Lanczos tridiagonals,
    in the dtype of ``alphas``.  The k x k eigendecomposition runs in
    float64: on an H100 CUDA's float32 eigh of the 32-step tridiagonal of
    config B errs 1.1e-5 on the Ritz values and 2.7e-6 on the quadrature,
    LAPACK's 2.4e-7 and 3.7e-7 (``tools/profile_huber.py``), which moved
    the Huber engine's first alpha2 on the card 4.4e-6 off the CPU's."""
    T = _tridiag(alphas.T, betas.T).to(torch.float64)
    lam, S = torch.linalg.eigh(T)
    return (torch.clamp(lam, min=0.0).to(alphas.dtype),
            torch.square(S[:, 0, :]).to(alphas.dtype))


@spanned("slq.build")
def build(mult, U: torch.Tensor, k: int) -> SlqBasis:
    """Lanczos pass + quadrature extraction (the one-time set-up)."""
    alphas, betas, unorm2 = lanczos_block(mult, U, k)
    lam, wts = nodes_weights(alphas, betas)
    return SlqBasis(lam=lam, wts=wts, unorm2=unorm2)


def _col(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device).reshape(-1, 1)


@spanned("slq.quad")
def quad_inv(basis: SlqBasis, tau, gam2) -> torch.Tensor:
    """[C] estimates of u_j^T (tau G_j + gam2 I)^{-1} u_j."""
    tau, gam2 = _col(tau, basis.lam), _col(gam2, basis.lam)
    return basis.unorm2 * (basis.wts / (tau * basis.lam + gam2)).sum(dim=-1)


@spanned("slq.quad")
def quad_ratio(basis: SlqBasis, tau, gam2) -> torch.Tensor:
    """[C] estimates of u_j^T G_j (tau G_j + gam2 I)^{-1} u_j."""
    tau, gam2 = _col(tau, basis.lam), _col(gam2, basis.lam)
    return basis.unorm2 * (basis.wts * basis.lam
                           / (tau * basis.lam + gam2)).sum(dim=-1)
