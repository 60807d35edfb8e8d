"""The two pieces of ``gvamp_tpu/probit.py`` that the linear engine imports
(``probit.py:283-306``): the fixed Gram operator and the SLQ basis built on
it, plus the dual (N-space) basis that ``gvamp_tpu/linear.py:408-425``
builds inline.  The probit engine itself is ported later (ROADMAP.md Queue
1 item 9).
"""

from __future__ import annotations

from gvamp_tpu_torch import slq


def _gram_mult(geno):
    """(op, Pk) -> A^T A Pk, the two-pass Gram (the fused primal Gram
    kernels are not ported; the JAX package also defaults to two passes)."""
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
