"""The two pieces of ``gvamp_tpu/probit.py`` that the linear engine imports
(``probit.py:283-306``): the fixed Gram operator and the SLQ basis built on
it.  The probit engine itself is ported later (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

from gvamp_tpu_torch import slq


def _gram_mult(geno):
    """(op, Pk) -> A^T A Pk, the two-pass Gram (the fused Gram kernels are
    not ported; the JAX package also defaults to two passes)."""
    axm_fn, atxm_fn = geno.fns_multi()
    return lambda op_, Pk: atxm_fn(op_, axm_fn(op_, Pk))


def make_slq_basis(geno, cfg, bern):
    """One-time Lanczos quadrature of the fixed marker-space Gram in the
    probes' Krylov spaces (``cfg.slq_k`` Gram passes)."""
    mult = _gram_mult(geno)
    op = geno.op
    return slq.build(lambda X: mult(op, X), bern, cfg.slq_k)
