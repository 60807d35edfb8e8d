"""Plain reference of the ``linear_fit`` driver, and the comparison that
decides ``correct``.

Plain PyTorch and NumPy: it imports neither JAX nor anything of the
program.  It starts from the benchmark's words, phenotypes and probes and
works out again, in blocks of markers decoded to float64 and multiplied in
float64:

* the marker statistics over each trait's NA support (data layer);
* the standardised products A x and A^T v (kernels), against the
  program's A u of the probe and A^T y of the trait, and the predictor
  A x1 of its estimate;
* the EM-VAMP iteration's denoiser, EM prior update and damping (engine);
* the LMMSE system of that iteration, against which the program's CG
  solution is judged by its residual (solver);
* the first two moments of the SLQ quadrature (solver);
* the LOCO p-values of the final estimate (``gwas``).

The fit is followed step by step: the reference rebuilds the last
iteration from the program's state after the last but one, and judges
that iteration's estimate, its predictor A x1 and its solve.  A cell's
limits file names the numbers that decide ``correct``; the others are
reported beside them.  The control computes the same quantities with
every product's vector operands rounded to TF32 (10 mantissa bits, as the
tensor cores do for float32 with TF32 on), and solves the LMMSE system by
its own CG in those products.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import stdtr

GAMMA_MIN, GAMMA_MAX = 1e-11, 1e11
BROKEN = 1e300  # the reading of a number that came out NaN or infinite
F64 = torch.float64


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (round to nearest on the 10 kept mantissa bits)."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32).to(x.dtype)


class Passes:
    """Blocked passes over the packed words: each block of markers decoded
    to dense float64 (dosage a, non-missing b) in person order and
    multiplied in float64.  ``rounding`` is applied to every vector
    operand (the control's TF32)."""

    def __init__(self, words: torch.Tensor, n: int, rounding=None,
                 block: int = 0):
        self.words, self.n = words, n
        self.nw, self.mpad = words.shape
        self.round = rounding or (lambda x: x)
        # about 1 GiB of decoded float64 per plane and block
        self.block = block or max(32, (2**27 // (16 * self.nw)) // 32 * 32)
        self.shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                                   device=words.device)[None, None, :, None]

    def _blocks(self):
        nw = self.nw
        for lo in range(0, self.mpad, self.block):
            hi = min(self.mpad, lo + self.block)
            w = hi - lo
            by = self.words[:, lo:hi].contiguous().view(torch.uint8)
            by = by.view(nw, w, 4).permute(0, 2, 1)[:, :, None, :]
            code = ((by >> self.shifts) & 3).reshape(16 * nw, w)[: self.n]
            lo_bit, hi_bit = code & 1, code >> 1
            a = ((1 - lo_bit) * (2 - hi_bit)).to(F64)
            b = (1 - lo_bit * (1 - hi_bit)).to(F64)
            yield lo, hi, a, b

    def transposed(self, V: torch.Tensor, squares: torch.Tensor = None):
        """(a^T V, b^T V [Mpad, C], (a*a)^T squares [Mpad, S])."""
        V = self.round(V.to(F64))
        dev = self.words.device
        av = torch.empty((self.mpad, V.shape[1]), dtype=F64, device=dev)
        bv = torch.empty_like(av)
        aa = None if squares is None else torch.empty(
            (self.mpad, squares.shape[1]), dtype=F64, device=dev)
        for lo, hi, a, b in self._blocks():
            av[lo:hi] = a.T @ V
            bv[lo:hi] = b.T @ V
            if aa is not None:
                aa[lo:hi] = (a * a).T @ squares.to(F64)
        return av, bv, aa

    def forward(self, W: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """a W - b U [N, C]."""
        W, U = self.round(W.to(F64)), self.round(U.to(F64))
        z = torch.zeros((self.n, W.shape[1]), dtype=F64,
                        device=self.words.device)
        for lo, hi, a, b in self._blocks():
            z += a @ W[lo:hi] - b @ U[lo:hi]
        return z


def person_order(v_planar: torch.Tensor, n: int) -> torch.Tensor:
    """A program vector in its planar [4, Nb(, C)] order -> person order:
    slot (k, 4w + j) holds person 16w + 4j + k."""
    nb = v_planar.shape[1]
    rest = v_planar.shape[2:]
    v = v_planar.reshape((4, nb // 4, 4) + rest)
    return v.permute((1, 2, 0) + tuple(range(3, 3 + len(rest)))).reshape(
        (4 * nb,) + rest)[:n]


# ------------------------------------------------------------ the denoiser


def _mixture(r, gam1, probs, vars_):
    """Posterior weights of the components, shrinkages s_j = v_j / (v_j +
    sigma) and 1 / (v_j + sigma), for r ~ x + N(0, 1/gam1), x ~ sum_j
    probs_j N(0, vars_j)."""
    sig = 1.0 / gam1
    vps = vars_[None, :] + sig
    logp = torch.where(probs[None, :] > 0, torch.log(
        torch.clamp(probs[None, :], min=1e-300)), -math.inf)
    logw = logp - 0.5 * torch.log(vps) - 0.5 * r[:, None] ** 2 / vps
    w = torch.softmax(logw, dim=1)
    return w, vars_[None, :] / vps, 1.0 / vps


def posterior_mean(r, gam1, probs, vars_):
    """E[x | r] and its derivative in r."""
    if 1.0 / gam1 < 1e-10:
        return r.clone(), torch.ones_like(r)
    w, s, inv = _mixture(r, gam1, probs, vars_)
    m = (w * s).sum(1)
    q = (w * inv).sum(1)
    t = (w * s * inv).sum(1)
    return r * m, m + r * r * (m * q - t)


def em_prior(r1, gam1, probs, vars_, mask, mt, em_max_iter, em_err_thr,
             merge_thr=0.5):
    """The EM update of the mixture (reference gVAMP's updatePrior): up to
    ``em_max_iter`` passes while the relative change of probs or vars is
    at least ``em_err_thr``, then components whose variances lie within
    ``merge_thr`` of each other merged into the first."""
    for _ in range(em_max_iter):
        w, _, _ = _mixture(r1, gam1, probs, vars_)
        pin = (1.0 - w[:, 0]) * mask          # P(x != 0 | r)
        slab = w[:, 1:] / torch.clamp(w[:, 1:].sum(1, keepdim=True),
                                      min=1e-300)
        vs = vars_[1:]
        post_var = 1.0 / (1.0 / vs + gam1)
        post_mean = (gam1 * r1)[:, None] * post_var[None, :]
        res = (slab * pin[:, None]).sum(0)
        res_g = (slab * (post_mean ** 2 + post_var) * pin[:, None]).sum(0)
        lam_new = pin.sum() / mt
        new_vars = torch.cat([vars_[:1], torch.where(
            res > 0, res_g / torch.where(res > 0, res, 1.0), vs)])
        omega = res / torch.clamp(pin.sum(), min=1e-300)
        new_probs = torch.cat([(1.0 - lam_new)[None], lam_new * omega])
        dist = max(float(torch.linalg.norm(new_probs - probs)
                         / torch.linalg.norm(new_probs)),
                   float(torch.linalg.norm(new_vars - vars_)
                         / torch.linalg.norm(new_vars)))
        probs, vars_ = new_probs, new_vars
        if dist < em_err_thr:
            break
    dev = probs.device
    probs, vars_ = probs.cpu().clone(), vars_.cpu().clone()
    L = probs.shape[0]
    for j in range(L):
        for k in range(j + 1, L):
            if probs[j] > 0 and probs[k] > 0:
                denom = min(vars_[j], vars_[k]) if vars_[j] != 0 else 1e-7
                if abs(vars_[j] - vars_[k]) / denom < merge_thr:
                    probs[j] = probs[j] + probs[k]
                    probs[k] = 0.0
                    vars_[k] = vars_[j]
    return probs.to(dev), vars_.to(dev)


def _clamp(x: float) -> float:
    return min(max(x, GAMMA_MIN), GAMMA_MAX)


def iteration_start(state: dict, it: int, run: dict, mask, mt):
    """Iteration ``it``'s denoiser, EM prior update and damping from the
    state before it, then the LMMSE system's right-hand side parts: returns
    (x1 damped, gam2, r2)."""
    r1, x1_prev = state["r1"], state["x1"]
    gam1, alpha1_prev = state["gam1"], state["alpha1"]
    probs, vars_ = state["probs"], state["vars"]
    prev = None
    for i in range(int(run["auto_var_max_iter"])):
        if i > 0 and not (it > 1 and abs(gam1 - prev) >= run["revar_tol"]):
            break
        g, d = posterior_mean(r1, gam1, probs, vars_)
        x1 = g * mask
        alpha1 = float((d * mask).sum()) / mt
        eta1 = gam1 / alpha1
        l2 = float((((x1 - r1) * mask) ** 2).sum())
        prev = gam1
        if it > 1:
            gam1 = _clamp(1.0 / (1.0 / eta1 + l2 / mt))
            probs, vars_ = em_prior(r1, gam1, probs, vars_, mask, mt,
                                    int(run["em_max_iter"]),
                                    float(run["em_err_thr"]))
    if it > 1:
        rho = state["rho"]
        x1 = rho * x1 + (1 - rho) * x1_prev
    gam2 = _clamp(eta1 - gam1)
    r2 = (eta1 * x1 - gam1 * r1) / gam2 * mask
    return x1, gam2, r2


def program_state(s) -> dict:
    """The fields of a program state that the next iteration reads."""
    def f(x):
        return x.detach().to(F64)
    return dict(r1=f(s.r1), x1=f(s.x1), gam1=float(s.gam1),
                gamw=float(s.gamw), alpha1=float(s.alpha1), rho=float(s.rho),
                probs=f(s.probs), vars=f(s.vars))


# ------------------------------------------------------------ p-values


def loco_pvals(sums: dict, x1, chroms, n_people: int) -> np.ndarray:
    """Two-sided LOCO p-values (reference gVAMP's pvals_calc_LOCO): for
    marker k, the regression of y_c + s_k value_k on value_k over the
    people who are neither NA nor missing at k, with y_c the phenotype
    less the estimate's predictor off chromosome c and s_k = x1_k /
    sqrt(N).  ``sums`` holds host float64 per-marker sums."""
    mave, msig = sums["mave"], sums["msig"]
    a_na, b_na, aa = sums["a_na"], sums["b_na"], sums["aa"]
    sumx = msig * (a_na - mave * b_na)
    sumsqx = msig**2 * (aa - 2 * mave * a_na + mave**2 * b_na)
    m = len(chroms)
    present = sorted(set(int(c) for c in chroms))
    p = np.ones(m)
    s = x1[:m] / math.sqrt(n_people)
    for j, ch in enumerate(present):
        sel = np.flatnonzero(chroms == ch)
        a_y, b_y, b_yy = (sums["a_y"][sel, j], sums["b_y"][sel, j],
                          sums["b_yy"][sel, j])
        vy = msig[sel] * (a_y - mave[sel] * b_y)
        sk = s[sel]
        sxx = sumsqx[sel]
        sxy = vy + sk * sxx
        sy = b_y + sk * sumx[sel]
        syy = b_yy + 2 * sk * vy + sk**2 * sxx
        nn = b_na[sel]
        with np.errstate(divide="ignore", invalid="ignore"):
            cov = sxy - sumx[sel] * sy / nn
            varx = sxx - sumx[sel] ** 2 / nn
            vary = syy - sy**2 / nn
            r = cov / np.sqrt(varx * vary)
            t = r * np.sqrt((nn - 2) / np.maximum(1 - r * r, 1e-300))
        pk = 2.0 * stdtr(np.maximum(nn - 2, 1.0), -np.abs(t))
        p[sel] = np.where(np.isfinite(t), pk, 1.0)
    return p


# ------------------------------------------------------------ the check


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """||a - b|| / ||b||; infinite where b is zero or either is not
    finite, so that an empty or broken result never passes."""
    nb = float(torch.linalg.norm(b))
    gap = float(torch.linalg.norm(a - b))
    return gap / nb if nb > 0 and math.isfinite(gap) else math.inf


def _log_gap(p, q) -> float:
    lp = np.log10(np.maximum(p, 1e-300))
    lq = np.log10(np.maximum(q, 1e-300))
    return float(np.max(np.abs(lp - lq) / np.maximum(1.0, np.abs(lq))))




def gram(passes: Passes, stats: list, nas: list, X: torch.Tensor,
         sqn: float) -> torch.Tensor:
    """Column t of X [Mpad, T] times trait t's Gram A^T A (A over that
    trait's NA support): one forward and one transposed pass for all."""
    msig = torch.stack([st["msig"] for st in stats], 1)
    mave = torch.stack([st["mave"] for st in stats], 1)
    W = msig * X
    z = passes.forward(W, mave * W) / sqn * torch.stack(nas, 1)
    av, bv, _ = passes.transposed(z)
    return msig * (av - mave * bv) / sqn


def cg_solve(gram_fn, V, mu0, tau, gam2, n: int, tol: float,
             max_iter: int) -> torch.Tensor:
    """Jacobi-preconditioned CG on (tau G + gam2 I) mu = V, every column
    at once, from mu0; a column stops when ||r|| < tol ||V|| after at
    least one step (the exit the configuration states)."""
    def mult(P):
        return tau[None, :] * gram_fn(P) + gam2[None, :] * P

    diag = tau * (n - 1.0) / n + gam2
    mu = mu0.clone()
    r = V - mult(mu)
    z = r / diag[None, :]
    p, rz = z.clone(), (r * z).sum(0)
    nv = torch.linalg.norm(V, dim=0)
    done = torch.zeros(V.shape[1], dtype=torch.bool, device=V.device)
    for _ in range(max_iter):
        d = mult(p)
        pd = (p * d).sum(0)
        alpha = torch.where(done | (pd == 0), 0.0,
                            rz / torch.where(pd == 0, 1.0, pd))
        mu = mu + alpha[None, :] * p
        r = r - alpha[None, :] * d
        z = r / diag[None, :]
        rz_new = (r * z).sum(0)
        beta = torch.where(done | (rz == 0), 0.0,
                           rz_new / torch.where(rz == 0, 1.0, rz))
        p, rz = z + beta[None, :] * p, rz_new
        done = done | (torch.linalg.norm(r, dim=0) < tol * nv)
        if bool(done.all()):
            break
    return mu


def _moments_gap(got: tuple, want: tuple) -> float:
    """The widest relative gap of the quadrature's moments u^T G^j u."""
    return max(abs(g - w) / w if w > 0 else math.inf
               for g, w in zip(got, want))


def basis_moments(basis) -> tuple:
    """u^T G u and u^T G^2 u from the program's quadrature (nodes lam,
    weights wts, ||u||^2), which a k-node Gauss rule gives exactly for
    k >= 2."""
    if basis is None:
        return (math.inf, math.inf)
    lam, wts = basis.lam.to(F64), basis.wts.to(F64)
    un = basis.unorm2.to(F64)
    return tuple(float((un * (wts * lam**j).sum(-1)).sum()) for j in (1, 2))


def check(words, config: dict, inputs: list, kept: list, chroms=None,
          control: bool = False) -> list:
    """The numbers, one dict per trait of the window:

    * ``estimate``: the last iteration's estimate x1, and its predictor
      A x1, against the reference's rebuild of that iteration;
    * ``products``: the program's A u of the probe and A^T y of the trait;
    * ``solve``: the last LMMSE solve's relative residual ||(gamw G +
      gam2 I) x2 - (gamw A^T y + gam2 r2)|| / ||gamw A^T y + gam2 r2||,
      the system rebuilt from the state before that iteration;
    * ``slq``: the quadrature's first two moments u^T G u, u^T G^2 u
      against ||A u||^2 and ||A^T A u||^2;
    * with p-values, ``pvals``: the widest gap of log10 p, relative where
      |log10 p| > 1.

    With ``control`` the same numbers of the control, which stands in the
    program's place: the reference's products with TF32 operands, and its
    CG (warm-started where the program's was) for x2."""
    torch.backends.cuda.matmul.allow_tf32 = False
    n, run = int(config["N"]), config["run"]
    m = int(config["M"])
    dev = words.device
    mpad = words.shape[1]
    mt = float(m)
    exact = Passes(words, n)
    mask = (torch.arange(mpad, device=dev) < m).to(F64)
    sqn = math.sqrt(n)
    T = len(kept)
    ys = [torch.as_tensor(np.nan_to_num(y, nan=0.0), dtype=F64, device=dev)
          for y, _ in inputs]
    nas = [torch.as_tensor(~np.isnan(y), dtype=F64, device=dev)
           for y, _ in inputs]
    probes = [torch.as_tensor(p[:, 0], dtype=F64, device=dev)
              for _, p in inputs]
    # pass 1: the marker statistics over each trait's NA support
    av, bv, aa = exact.transposed(torch.stack(nas, dim=1),
                                  torch.stack(nas, dim=1))
    stats = []
    for t in range(T):
        a_na, b_na = av[:, t], bv[:, t]
        nonas = float(nas[t].sum())
        mave = torch.where(b_na != 0, a_na / torch.where(b_na != 0, b_na, 1.0),
                           0.0)
        ssq = aa[:, t] - mave * a_na
        sd = torch.sqrt(torch.clamp(ssq, min=0.0) / (nonas - 1.0))
        msig = torch.where(ssq > 0, 1.0 / torch.where(ssq > 0, sd, 1.0), 1.0)
        stats.append(dict(mave=mave * mask, msig=msig * mask, a_na=a_na,
                          b_na=b_na, aa=aa[:, t]))
    # the last iteration rebuilt from the program's state before it: its
    # estimate, and the LMMSE system (gamw, gam2, r2) that it solves
    starts = [iteration_start(program_state(k["prev"]), k["iters"], run,
                              mask, mt) for k in kept]
    x1_ref = [s[0] for s in starts]
    gam2s = torch.tensor([s[1] for s in starts], dtype=F64, device=dev)
    r2s = torch.stack([s[2] for s in starts], 1)
    gamws = torch.tensor([float(k["prev"].gamw) for k in kept], dtype=F64,
                         device=dev)
    present = sorted(set(int(c) for c in chroms)) if chroms is not None else []
    nc = len(present)
    cmask = None
    if nc:
        cm = np.zeros((mpad, nc))
        for j, ch in enumerate(present):
            cm[:m, j] = chroms == ch
        cmask = torch.as_tensor(cm, dtype=F64, device=dev)

    def side(passes, x2s=None):
        """Passes 2 and 3 over the words, every trait at once: A x1 (and
        per chromosome), A u, A^T y, A^T A u, with ``x2s`` A^T A x2, and
        the LOCO p-values, as the side that computes them rounds
        (``passes``)."""
        Ws, Us = [], []
        lead = 2 if x2s is None else 3
        width = lead + nc
        for t in range(T):
            parts = [x1_ref[t][:, None], probes[t][:, None]]
            if x2s is not None:
                parts.append(x2s[t][:, None])
            if nc:
                parts.append(x1_ref[t][:, None] * cmask)
            W = stats[t]["msig"][:, None] * torch.cat(parts, 1)
            Ws.append(W)
            Us.append(stats[t]["mave"][:, None] * W)
        z = passes.forward(torch.cat(Ws, 1), torch.cat(Us, 1)) / sqn
        zs = [z[:, t * width:(t + 1) * width] * nas[t][:, None]
              for t in range(T)]
        vcols = []
        for t in range(T):
            y = ys[t] * nas[t]
            ycs = [(y - zs[t][:, 0] + zs[t][:, lead + j]) * nas[t]
                   for j in range(nc)]
            vcols += [y] + [zs[t][:, j] for j in range(1, lead)] + ycs + [
                c * c for c in ycs]
        av_, bv_, _ = passes.transposed(torch.stack(vcols, 1))
        out, k = [], lead + 2 * nc
        for t in range(T):
            st, at = stats[t], t * k

            def back(c, st=st, at=at):
                return (st["msig"] * (av_[:, at + c] - st["mave"]
                                      * bv_[:, at + c]) / sqn)

            o = dict(zx=zs[t][:, 0], zu=zs[t][:, 1], aty=back(0), gu=back(1))
            if x2s is not None:
                o["gx2"] = back(2)
            if nc:
                host = {key: st[key].cpu().numpy()
                        for key in ("mave", "msig", "a_na", "b_na", "aa")}
                host.update(a_y=av_[:, at + lead:at + lead + nc].cpu().numpy(),
                            b_y=bv_[:, at + lead:at + lead + nc].cpu().numpy(),
                            b_yy=bv_[:, at + lead + nc:at + k].cpu().numpy())
                o["pvals"] = loco_pvals(host, x1_ref[t].cpu().numpy(),
                                        chroms, n)
            out.append(o)
        return out

    if control:
        tf = Passes(words, n, rounding=tf32)
        got = side(tf)
        V = gamws[None, :] * torch.stack([g["aty"] for g in got], 1) \
            + gam2s[None, :] * r2s
        mu0 = torch.stack([k["prev"].mu_cg.detach().to(F64) for k in kept], 1)
        x2 = cg_solve(lambda X: gram(tf, stats, nas, X, sqn), V,
                      mu0 * mask[:, None], gamws, gam2s, n,
                      float(run["cg_err_tol"]),
                      int(run["cg_max_iter"])) * mask[:, None]
        x2s = [x2[:, t] for t in range(T)]
        x1_got = x1_ref
        moments = [(float(torch.square(g["zu"]).sum()),
                    float(torch.square(g["gu"]).sum())) for g in got]
    else:
        got = [dict(zx=person_order(k["last"].z1.detach().to(F64), n),
                    zu=person_order(k["z_probe"].detach().to(F64), n)[:, 0],
                    aty=k["aty"].detach().to(F64), pvals=k["pvals"])
               for k in kept]
        x2s = [k["last"].x2.detach().to(F64) * mask for k in kept]
        x1_got = [k["last"].x1.detach().to(F64) for k in kept]
        moments = [basis_moments(k["slq"]) for k in kept]
    ref = side(exact, x2s)
    numbers = []
    for t in range(T):
        r, g = ref[t], got[t]
        gamw, gam2 = gamws[t], gam2s[t]
        nums = dict(
            estimate=max(_rel(x1_got[t] * mask, x1_ref[t]),
                         _rel(g["zx"], r["zx"])),
            products=max(_rel(g["zu"], r["zu"]),
                         _rel(g["aty"] * mask, r["aty"])),
            solve=_rel(gamw * r["gx2"] + gam2 * x2s[t],
                       gamw * r["aty"] + gam2 * r2s[:, t]),
            slq=_moments_gap(moments[t], (float(torch.square(r["zu"]).sum()),
                                          float(torch.square(r["gu"]).sum()))))
        if nc:
            nums["pvals"] = _log_gap(np.asarray(g["pvals"])[:m], r["pvals"])
        # a result that is not a number never passes
        numbers.append({k: v if math.isfinite(v) else BROKEN
                        for k, v in nums.items()})
    return numbers
