"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: a step that returns its state
unchanged, half of the people left out of a product with the mean taken
over the rest, and an answer altered where it is produced (the estimate,
the p-values).  One card holds no exchange between chips to leave out.
The solver cut to one CG step shows in the ``solve`` reading, which no
limit holds (the control reads below the program there)."""

from __future__ import annotations

import pytest
import torch

from gvamp_tpu_torch import cg, linear
from gvamp_tpu_torch.ops import matvec, pvals

from gvbench import run


def unchanged_step(monkeypatch):
    make_step = linear.make_step

    def broken(*args, **kw):
        step = make_step(*args, **kw)

        def s(state, aux, w=None):
            _, metrics = step(state, aux)
            return state._replace(it=state.it + 1), metrics
        return s

    monkeypatch.setattr(linear, "make_step", broken)


def half_the_people(monkeypatch):
    for name in ("atxm_i8a", "atxm_i8"):
        fn = getattr(matvec, name)

        def broken(words, V, _fn=fn):
            keep = torch.ones_like(V)
            keep[:, V.shape[1] // 2:] = 0
            out = _fn(words, V * keep)
            return (tuple(2 * o for o in out) if isinstance(out, tuple)
                    else 2 * out)
        monkeypatch.setattr(matvec, name, broken)


def altered_estimate(monkeypatch):
    make_step = linear.make_step

    def broken(*args, **kw):
        step = make_step(*args, **kw)

        def s(state, aux, w=None):
            new, metrics = step(state, aux)
            x1 = new.x1.clone()
            x1[0] = x1[0] + 1e-3 * x1.abs().max()
            return new._replace(x1=x1), metrics
        return s

    monkeypatch.setattr(linear, "make_step", broken)


def altered_pvals(monkeypatch):
    loco = pvals.loco_pvals

    def broken(*args, **kw):
        p = loco(*args, **kw)
        p[0] = min(1.0, p[0] * 1.5)
        return p

    monkeypatch.setattr(pvals, "loco_pvals", broken)


def cg_one_step(monkeypatch):
    solve_block = cg.solve_block

    def broken(mult, V, mu, diag, gam2, max_iter, *args, **kw):
        return solve_block(mult, V, mu, diag, gam2, 1, *args, **kw)

    monkeypatch.setattr(cg, "solve_block", broken)


@pytest.mark.parametrize("cell,fault", [
    ("array3.gwas", unchanged_step), ("array3.gwas", half_the_people),
    ("array3.gwas", altered_estimate), ("array3.gwas", altered_pvals),
    ("array3.fit", unchanged_step)],
    ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(cell, fault, tiny, monkeypatch):
    spec, here = tiny
    fault(monkeypatch)
    out = run.run(spec, cell, 31337, 0.0, False, "cpu", here=here)
    assert not out["correct"], out["checks"]
    assert out["failed"] == out["attempted"] == 1


def test_cg_cut_shows_in_the_solve_reading(tiny, monkeypatch):
    """The reference's residual of the last LMMSE solve sees a CG cut to
    one step, though no limit holds it."""
    spec, here = tiny
    sound = run.run(spec, "array3.gwas", 31337, 0.0, False, "cpu",
                    here=here)["per_trait_checks"][0]["solve"]
    cg_one_step(monkeypatch)
    cut = run.run(spec, "array3.gwas", 31337, 0.0, False, "cpu",
                  here=here)["per_trait_checks"][0]["solve"]
    assert sound < 1e-5 and cut > 100 * sound, (sound, cut)
