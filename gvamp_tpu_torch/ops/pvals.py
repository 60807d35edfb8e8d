"""LOO / LOCO association p-values of the PyTorch port.

Counterpart of ``gvamp_tpu/ops/pvals.py`` (the reference's pvals_calc and
pvals_calc_LOCO, data.cpp:1108-1353).  With the marker-k contribution added
back,

    y_mark = y_mod + s_k * value_k,   s_k = x1_k / sqrt(N),
    value_k = (a - mave_k) * msig_k * b * na,

every sufficient statistic of the per-marker regression expands into
contractions of the decode (a, b) against the fixed vectors
{na, y_mod, y_mod^2} plus the moment sum a^2 * na, so one blocked pass over
the packed matrix (``_moments``) gives them for every marker, and several
estimates or chromosomes ride the same pass as extra vectors.

Under a marker mesh the pass runs per slab and its moments are
all-gathered; the tests then run on the replicated moments.  The pass is
plain PyTorch: the JAX package computes it in XLA, not in a
Pallas kernel.  Within an N-chunk the products run in true float32 (TF32
is switched off for the pass, as JAX asks for ``Precision.HIGHEST``), and
chunk partials combine with compensated two-sum, so the (hi, lo) pairs fold
to float64-grade sums on the host.  The t-test itself runs on the host in
float64 (scipy ``betainc``) whatever the engine dtype: f32 would flush
p-values below ~1e-38 to zero.

Under a profiler each call is a ``pvals.loo`` or ``pvals.loco`` span
holding ``pvals.predictor`` (the target vectors: for LOCO the wide forward
product of the per-chromosome predictors), ``pvals.moments`` (the moments
pass and its fold on the host, which waits for the device) and
``pvals.tests`` (the host t-tests) (``gvamp_tpu_torch.trace``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from gvamp_tpu_torch.ops import matvec
from gvamp_tpu_torch.trace import span, spanned


@contextlib.contextmanager
def _ieee_f32():
    """float32 matrix products in full float32 on CUDA (no TF32), whatever
    the global ``allow_tf32`` / ``set_float32_matmul_precision`` setting;
    the setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _moments(words, vecs, na, block=256):
    """One blocked decode pass with f64-grade N-axis accumulation.

    vecs: [V, 4, Nb] contraction vectors.  Returns six tensors
    (av_hi, av_lo [V, M], bv_hi, bv_lo [V, M], aa_hi, aa_lo [M]) whose
    hi + lo (folded in host float64 by :func:`_fold64`) are sum a * vecs[v],
    sum b * vecs[v] and sum a^2 * na (``gvamp_tpu/ops/pvals.py:48-107``)."""
    nw, m = words.shape
    dt = vecs.dtype
    V, _, nb = vecs.shape
    nc = matvec.nb_chunk(nb)
    C = nb // nc
    vc = vecs.reshape(V, 4, C, nc)
    nac = na.reshape(4, C, nc)
    dev = words.device
    av = torch.zeros((2, V, m), dtype=dt, device=dev)
    bv = torch.zeros((2, V, m), dtype=dt, device=dev)
    aa = torch.zeros((2, m), dtype=dt, device=dev)
    with _ieee_f32():
        for j in range(0, m, block):
            a, b = matvec.decode_planar_dense(words[:, j:j + block], dt)
            w = a.shape[2]
            ac = a.reshape(4, C, nc, w)
            bc = b.reshape(4, C, nc, w)
            pav = torch.einsum("kcnm,vkcn->cvm", ac, vc)
            pbv = torch.einsum("kcnm,vkcn->cvm", bc, vc)
            paa = torch.einsum("kcnm,kcn->cm", ac * ac, nac)
            del a, b, ac, bc
            zv = torch.zeros((V, w), dtype=dt, device=dev)
            zm = torch.zeros((w,), dtype=dt, device=dev)
            ah = al = bh = bl = zv
            qh = ql = zm
            for c in range(C):
                ah, al = matvec.two_sum(ah, al, pav[c])
                bh, bl = matvec.two_sum(bh, bl, pbv[c])
                qh, ql = matvec.two_sum(qh, ql, paa[c])
            av[0, :, j:j + w], av[1, :, j:j + w] = ah, al
            bv[0, :, j:j + w], bv[1, :, j:j + w] = bh, bl
            aa[0, j:j + w], aa[1, j:j + w] = qh, ql
    return av[0], av[1], bv[0], bv[1], aa[0], aa[1]


def _np64(x) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _fold64(hi, lo) -> np.ndarray:
    """Host float64 fold of a compensated (hi, lo) device pair."""
    return _np64(hi) + _np64(lo)


def _student_t_sf2_np(t: np.ndarray, df: np.ndarray) -> np.ndarray:
    """Two-sided Student-t p-value in float64 (reference linear_reg1d_pvals,
    utilities.cpp:321-334): p = I_{df/(df+t^2)}(df/2, 1/2), the regularised
    incomplete beta."""
    from scipy.special import betainc
    t = np.asarray(t, np.float64)
    df = np.asarray(df, np.float64)
    x = df / (df + t * t)
    return betainc(df / 2.0, 0.5, x)


def _reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, n):
    """1-D regression t-test in host float64 (all inputs np.float64)."""
    # padded/degenerate markers (n = 0) divide to nan and fold to p = 1
    with np.errstate(divide="ignore", invalid="ignore"):
        s2y = (sumsqy - sumy * sumy / n) / (n - 1)
        s2x = (sumsqx - sumx * sumx / n) / (n - 1)
        sxy = (sumxy - sumx * sumy / n) / (n - 1)
        rxy = sxy / np.sqrt(s2x * s2y)
        t = rxy * np.sqrt((n - 2) / np.maximum(1.0 - rxy * rxy, 1e-300))
    p = _student_t_sf2_np(np.where(np.isfinite(t), t, 0.0),
                          np.maximum(n - 2, 1.0))
    return np.where(np.isfinite(t), p, 1.0)


def _shared_stats(geno, a_na, b_na, aa):
    """(sumx, sumsqx, b_na, mave, msig) in host f64 from the na-contraction
    moments (already folded to np.float64)."""
    mave = _np64(geno.mave)
    msig = _np64(geno.msig)
    sumx = msig * (a_na - mave * b_na)
    sumsqx = msig**2 * (aa - 2 * mave * a_na + mave**2 * b_na)
    return sumx, sumsqx, b_na, mave, msig


def _pvals_of(geno, ycs, s):
    """Per-target p-values [T, Mpad] from target vectors ycs (each [4, Nb],
    NA-masked) and the add-back scales s [Mpad, T], in one moments pass."""
    na = geno.na_planar
    with span("pvals.moments", targets=len(ycs)):
        vecs = torch.stack([na] + [v for yc in ycs for v in (yc, yc * yc)])
        # under a mesh per slab, each marker's moments all-gathered: [V, M]
        # along axis 1, the a^2 sums along axis 0
        moments = geno._sharded(
            lambda g, v, n: _moments(g, v, n, block=min(256, g.shape[1])),
            (None, None), "m", dims=(1, 1, 1, 1, 0, 0))(geno.words, vecs, na)
        av_hi, av_lo, bv_hi, bv_lo, aa_hi, aa_lo = moments
        avh = _fold64(av_hi, av_lo)
        bvh = _fold64(bv_hi, bv_lo)
        aah = _fold64(aa_hi, aa_lo)
    with span("pvals.tests"):
        sumx, sumsqx, b_na, mave, msig = _shared_stats(geno, avh[0], bvh[0],
                                                       aah)
        out = np.ones((len(ycs), geno.Mpad), dtype=np.float64)
        for e in range(len(ycs)):
            a_y, b_y, b_yy = avh[1 + 2 * e], bvh[1 + 2 * e], bvh[2 + 2 * e]
            vy = msig * (a_y - mave * b_y)       # sum value * y_target
            se = s[:, e]
            sumxy = vy + se * sumsqx
            sumy = b_y + se * sumx
            sumsqy = b_yy + 2 * se * vy + se**2 * sumsqx
            out[e] = _reg1d_pvals(sumx, sumsqx, sumxy, sumy, sumsqy, b_na)
    return out


@spanned("pvals.loo")
def loo_pvals_multi(geno, z1s_planar, x1s_internal):
    """LOO p-values for E estimates in one decode pass (reference
    pvals_calc's nE batch, data.cpp:1155-1183).

    z1s_planar: [4, Nb, E] forward products A @ x1_e; x1s_internal:
    [Mpad, E] internal-scale estimates.  Returns float64[E, M]."""
    na = geno.na_planar
    with span("pvals.predictor"):
        y = geno.filter_pheno()
        E = int(x1s_internal.shape[1])
        ycs = [(y - z1s_planar[..., e].to(geno.dtype)) * na
               for e in range(E)]
        s = _np64(x1s_internal) / np.sqrt(geno.N)
    return _pvals_of(geno, ycs, s)[:, : geno.M]


def loo_pvals(geno, z1_planar, x1_internal):
    """LOO p-values (reference pvals_calc, data.cpp:1108-1226).

    z1_planar: A @ x1 (planar); x1_internal: internal-scale estimate
    [Mpad].  Returns float64[M] two-sided p-values."""
    return loo_pvals_multi(geno, z1_planar[..., None],
                           x1_internal[:, None])[0]


@spanned("pvals.loco")
def loco_pvals(geno, z1_planar, x1_internal, chroms, predictor_cb=None):
    """LOCO p-values (reference pvals_calc_LOCO, data.cpp:1235-1353).

    chroms: int[M] chromosome per local marker ('X' read as 23).  One wide
    forward product builds every present chromosome's genetic predictor
    y_chrom = A (x1 * 1[ch]) (``axm`` at B = the number of chromosomes);
    y_corr = y_mod + y_chrom feeds the same sufficient statistics, and each
    chromosome keeps the p-values of its own markers.  predictor_cb(ch,
    y_chrom_planar) is called per chromosome (the reference's
    ``*_LOCO_chr_N.csv`` dumps).  Returns float64[M]."""
    y = geno.filter_pheno()
    na = geno.na_planar
    ym = (y - z1_planar.to(geno.dtype)) * na
    chroms_pad = np.zeros(geno.Mpad, dtype=np.int32)
    chroms_pad[: geno.M] = np.asarray(chroms)
    pvals = np.ones(geno.Mpad, dtype=np.float64)
    present = [ch for ch in range(1, 24) if (chroms_pad == ch).any()]
    if not present:
        return pvals[: geno.M]

    with span("pvals.predictor"):
        masks = np.stack([(chroms_pad == ch) for ch in present], axis=1)
        masks = torch.as_tensor(masks, dtype=geno.dtype, device=geno.device)
        y_chroms = geno.axm(x1_internal.to(geno.dtype)[:, None] * masks)
        if predictor_cb is not None:
            for j, ch in enumerate(present):
                predictor_cb(ch, y_chroms[..., j])
        ycs = [(ym + y_chroms[..., j]) * na for j in range(len(present))]
        s = _np64(x1_internal) / np.sqrt(geno.N)
    p = _pvals_of(geno, ycs, np.repeat(s[:, None], len(present), axis=1))
    for j, ch in enumerate(present):
        sel = chroms_pad == ch
        pvals[sel] = p[j][sel]
    return pvals[: geno.M]
