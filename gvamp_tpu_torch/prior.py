"""Spike-and-slab Gaussian-mixture prior: denoisers + EM adaptation.

Port of ``gvamp_tpu/prior.py``: the responsibility-form denoisers ``g1`` /
``g1d`` (reference vamp.cpp:805-869), the posterior inclusion probability,
and the EM prior update with component merging in fixed-size slots
(vamp.cpp:929-1072).  The EM ``while_loop`` becomes a Python loop whose exit
test reads one device value (a counted host sync, ``gvamp_tpu_torch.sync``).

``g1``, ``g1d`` and ``update_prior`` also take a trailing trait axis (the
multi-trait engines, ``gvamp_tpu_torch.multi``): r [Mpad, T], gam1 [T] and
a prior of [T, L] rows compute what ``jax.vmap`` over traits computes in
``gvamp_tpu/multi.py:387-393``; with r [Mpad] they are the single-trait
functions.

Scale convention: ``vars`` are in the internal scale (already multiplied by
N, mirroring vamp.cpp:153-155).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gvamp_tpu_torch.sync import host_bool
from gvamp_tpu_torch.trace import span, spanned

GAMMA_MIN = 1e-11  # reference vamp.hpp:31
GAMMA_MAX = 1e11   # reference vamp.hpp:32
_SQRT_2PI = 2.5066282746310002


@dataclasses.dataclass
class Prior:
    probs: torch.Tensor  # [L] (or [T, L]); slot 0 = spike; merged slots
                         # have prob 0
    vars: torch.Tensor   # [L] (or [T, L]); slot 0 = 0; merged slots
                         # duplicate the survivor's var

    @property
    def L(self) -> int:
        return self.probs.shape[-1]


def _resp_terms(r, gam1, prior: Prior):
    """Responsibilities and shrinkages of the mixture denoiser in the
    cancellation-free form of ``gvamp_tpu/prior.py:_resp_terms``; over a
    trailing trait axis when r is [Mpad, T]."""
    sigma = 1.0 / gam1
    sig = torch.as_tensor(sigma)[..., None] if r.ndim == 2 else sigma
    vmax = prior.vars.amax(dim=-1, keepdim=True)[None]
    v = prior.vars[None]
    p = prior.probs[None]
    r2 = torch.square(r)[..., None]
    vps = v + sig
    c = p / torch.sqrt(vps) * torch.exp(
        -0.5 * r2 * (vmax - v) / (vps * (vmax + sig)))
    w = c / c.sum(dim=-1, keepdim=True)
    s = v / vps
    m = (w * s).sum(dim=-1)
    q = (w / vps).sum(dim=-1)
    t = (w * s / vps).sum(dim=-1)
    return sigma, m, q, t


def g1(r: torch.Tensor, gam1, prior: Prior) -> torch.Tensor:
    """Posterior mean E[x | r, gam1] under the mixture prior (vamp.cpp:805)."""
    sigma, m, q, t = _resp_terms(r, gam1, prior)
    return torch.where(torch.abs(torch.as_tensor(sigma)) < 1e-10, r, r * m)


def g1d(r: torch.Tensor, gam1, prior: Prior) -> torch.Tensor:
    """d g1 / d r (reference vamp.cpp:836), responsibility form."""
    sigma, m, q, t = _resp_terms(r, gam1, prior)
    val = m + torch.square(r) * (m * q - t)
    return torch.where(torch.abs(torch.as_tensor(sigma)) < 1e-10,
                       torch.ones_like(r), val)


def pip(r: torch.Tensor, gam1, prior: Prior) -> torch.Tensor:
    """Posterior inclusion probability P(x != 0 | r, gam1) per marker."""
    sigma = 1.0 / gam1
    vmax = prior.vars.max()
    v = prior.vars[None, :]
    p = prior.probs[None, :]
    r2 = torch.square(r)[:, None]
    vps = v + sigma
    c = p / torch.sqrt(vps) * torch.exp(
        -0.5 * r2 * (vmax - v) / (vps * (vmax + sigma)))
    return 1.0 - c[:, 0] / c.sum(dim=1)


@spanned("prior.update")
def update_prior(r1: torch.Tensor, gam1, prior: Prior, m_mask: torch.Tensor,
                 mt, em_max_iter: int = 2, em_err_thr: float = 1e-2,
                 learn_vars: bool = True, merge_thr: float = 5e-1,
                 active=None) -> Prior:
    """One call of the reference's updatePrior (vamp.cpp:929-1072): EM over
    (lambda, omegas, vars) with an early stop on the relative change of
    probs and vars, then the close-variance merge pass.

    With r1 [Mpad, T], gam1 [T] and a [T, L] prior each trait runs its own
    EM loop, as under ``jax.vmap``: a trait whose test fails keeps its
    values while the others go on, and the loop ends when no trait goes on
    (one host read per pass).  ``active`` (bool [T]) names the traits to
    update; the others keep their input prior through the EM (the merge
    pass runs on every trait)."""
    dt = prior.probs.dtype
    gam1 = torch.as_tensor(gam1, dtype=dt, device=r1.device)
    noise_var = 1.0 / gam1
    nv, g1c = noise_var[..., None], gam1[..., None]
    r2 = torch.square(r1)
    mm = m_mask if r1.ndim == 1 else m_mask[:, None]
    probs, vars_ = prior.probs, prior.vars

    def em_body(probs, vars_):
        lam = 1.0 - probs[..., 0]
        omegas = probs / torch.where(lam == 0, 1.0, lam)[..., None]
        vmax0 = vars_.amax(dim=-1)
        vmax = vmax0[..., None]
        vs = vars_[..., 1:]
        num = (lam[..., None] * omegas[..., 1:]
               * torch.exp(-0.5 * r2[..., None] * (vmax - vs)
                           / ((vs + nv) * (vmax + nv)))
               / torch.sqrt(vs + nv) / _SQRT_2PI)
        sum_num = num.sum(dim=-1)
        sum_safe = torch.where(sum_num == 0, 1.0, sum_num)
        beta = num / sum_safe[..., None]
        gammas = (gam1 * r1)[..., None] / (1.0 / vs + g1c)
        v_post = 1.0 / (1.0 / vs + g1c)
        pin = 1.0 / (1.0 + (1.0 - lam) / torch.sqrt(2.0 * math.pi * noise_var)
                     * torch.exp(-0.5 * r2 * vmax0
                                 / (noise_var * (noise_var + vmax0)))
                     / sum_safe)
        pin = pin * mm
        sum_pin = pin.sum(dim=0)
        lam_new = sum_pin / mt
        res = (beta * pin[..., None]).sum(dim=0)
        res_g = (beta * (torch.square(gammas) + v_post)
                 * pin[..., None]).sum(dim=0)
        new_slab = torch.where(res > 0, res_g / torch.where(res == 0, 1.0, res),
                               vars_[..., 1:])
        vars_new = (torch.cat([vars_[..., :1], new_slab], dim=-1)
                    if learn_vars else vars_)
        omg = res / torch.where(sum_pin == 0, 1.0, sum_pin)[..., None]
        probs_new = torch.cat([(1.0 - lam_new)[..., None],
                               lam_new[..., None] * omg], dim=-1).to(dt)
        vars_new = vars_new.to(dt)
        dist_p = torch.sqrt(torch.square(probs_new - probs).sum(dim=-1)
                            / torch.square(probs_new).sum(dim=-1))
        dist_v = torch.sqrt(torch.square(vars_new - vars_).sum(dim=-1)
                            / torch.square(vars_new).sum(dim=-1))
        return probs_new, vars_new, torch.maximum(dist_p, dist_v)

    # lax.while_loop(it < em_max_iter & dist >= thr): the first test passes
    # on the host (dist starts at inf), each later one reads the device
    go = (torch.ones(probs.shape[:-1], dtype=torch.bool, device=r1.device)
          if active is None else active)
    it = 0
    with span("prior.em"):
        while it < em_max_iter:
            probs_new, vars_new, dist = em_body(probs, vars_)
            probs = torch.where(go[..., None], probs_new, probs)
            vars_ = torch.where(go[..., None], vars_new, vars_)
            go = go & (dist >= em_err_thr)
            it += 1
            if it < em_max_iter and not host_bool(go.any()):
                break

    # merge close variances: merging k into j moves k's probability onto j
    # and duplicates j's variance into slot k (fixed-slot form)
    with span("prior.merge"):
        probs, vars_ = probs.clone(), vars_.clone()
        L = probs.shape[-1]
        tiny = torch.as_tensor(1e-7, dtype=dt, device=vars_.device)
        for j in range(L):
            for k in range(j + 1, L):
                pj0, pk0 = probs[..., j], probs[..., k]
                vj, vk0 = vars_[..., j], vars_[..., k]
                both_alive = (pj0 > 0) & (pk0 > 0)
                denom = torch.where(vj != 0, torch.minimum(vj, vk0), tiny)
                do = both_alive & (torch.abs(vj - vk0) / denom < merge_thr)
                pj = torch.where(do, pj0 + pk0, pj0)
                pk = torch.where(do, 0.0, pk0)
                vk = torch.where(do, vj, vk0)
                probs[..., j], probs[..., k], vars_[..., k] = pj, pk, vk
    return Prior(probs=probs, vars=vars_)


def initialize_prior(probs, vars_, N, Mt):
    """Default 23-component prior when none given (utilities.cpp:91-140);
    returns user-scale numpy arrays like ``gvamp_tpu.prior.initialize_prior``."""
    if probs is not None and len(probs) > 0:
        return np.asarray(probs, np.float64), np.asarray(vars_, np.float64)
    if Mt <= 50000:
        raise ValueError("No probs/vars specified and Mt <= 50000 "
                         "(reference utilities.cpp:96-99)")
    num_mix = 23
    p1 = min(50000.0 / Mt, 1.0) / (2.0 - 1.0 / 2.0**21)
    probs_out = [1.0 - 50000.0 / Mt] + [p1 / 2.0**i for i in range(num_mix - 1)]
    ratio = 10.0 ** (np.log10(1e2 / 1e-5) / (num_mix - 2))
    vars_out = [0.0] + [1e-5 * ratio**i for i in range(num_mix - 1)]
    return (np.asarray(probs_out, np.float64),
            np.asarray(vars_out, np.float64) / N)
