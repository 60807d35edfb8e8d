"""The port's sim run mode and --state-evo against the JAX CLI, on the
dataset of tests/test_torch_modes.py (f64): each --sim-model recipe's
truth, phenotype and dumps, and the state-evolution lines.  The runs take
JAX's probe (and for --state-evo JAX's draws) on both sides."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvamp_tpu.io import vecio
from gvamp_tpu_torch import linear as tlinear
from test_torch_modes import M, N, _both_clis, ds, jax_probe, one_device  # noqa: F401

torch.set_num_threads(1)


# each --sim-model recipe through both CLIs, f64: the truth and phenotype
# files within 1e-12; the linear recipes' dumps within 1e-9 (JAX's probe);
# probit's inference draws its initial p1 from generators that differ
SIM_CASES = {"default": (), "num_mix_comp": ("--num-mix-comp", "3"),
             "probit": ("--sim-model", "probit", "--cov-file", "COV", "--C",
                        "2")}


@pytest.mark.parametrize("case", SIM_CASES)
def test_sim_mode_matches_jax(ds, capsys, jax_probe, case):
    extra = [ds.cov if a == "COV" else a for a in SIM_CASES[case]]
    _both_clis(capsys, [
        "--run-mode", "sim", "--bed-file", ds.bed, "--N", str(N), "--Mt",
        str(M), "--iterations", "3", "--rho", "0.3", "--h2", "0.8", "--CV",
        "15", "--seed", "4", "--out-dir", str(ds.dir),
        "--out-name", f"sim_{case}", *extra], "float64")
    pre = str(ds.dir / f"sim_{case}")
    for name, read in (("_beta_true.bin", lambda p: vecio.read_bin_shard(
            p, M, 0)), ("_y.txt", np.loadtxt)):
        want, got = read(pre + "j" + name), read(pre + "t" + name)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    if case != "probit":
        want = vecio.read_bin_shard(pre + "j_it_3.bin", M, 0)
        got = vecio.read_bin_shard(pre + "t_it_3.bin", M, 0)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-9 * np.abs(want).max())
    else:
        x = vecio.read_bin_shard(pre + "t_probit_it_3.bin", M, 0)
        assert np.isfinite(x).all()


def test_state_evo_lines(ds, capsys, jax_probe, monkeypatch):
    """--state-evo 1 through both CLIs (f64, JAX's probe, and JAX's
    state-evolution draws: the port's state_evolution_draws replaced by
    jax.random's, made with the key splits of gvamp_tpu/linear.py:
    1205-1214): one line per iteration after the first in JAX's format,
    predicted and measured alpha1, eta1 and gam2 within 1e-5 of JAX's (the
    lines print 6 digits)."""
    import jax
    from gvamp_tpu.prior import Prior as JPrior
    from test_torch_crossval import _jax_draws

    def draws(seed, it, prior, prior_before, n_mc):
        key = jax.random.fold_in(jax.random.key(seed + 11), it)
        pr = [JPrior(jnp.asarray(p.probs.numpy()), jnp.asarray(p.vars.numpy()))
              for p in (prior, prior_before)]
        return tuple(torch.tensor(np.asarray(d), dtype=prior.probs.dtype)
                     for d in _jax_draws(key, *pr, n_mc))

    monkeypatch.setattr(tlinear, "state_evolution_draws", draws)
    (_, lj), (_, lt) = _both_clis(capsys, [
        "--run-mode", "infere", "--bed-file", ds.bed, "--phen-files",
        ds.phen, "--N", str(N), "--Mt", str(M), "--iterations", "4",
        "--rho", "0.3", "--vars", ",".join(map(str, ds.vars)),
        "--probs", ",".join(map(str, ds.probs)), "--state-evo", "1",
        "--out-dir", str(ds.dir), "--out-name", "se"], "float64")
    pat = re.compile(r"^  it (\d+): alpha1 (\S+) \| (\S+)   eta1 (\S+) \| "
                     r"(\S+)   gam2 (\S+) \| (\S+)$")
    rows = []
    for lines in (lj, lt):
        i = lines.index("state evolution (predicted | measured):")
        rows.append([[float(v) for v in pat.match(ln).groups()]
                     for ln in lines[i + 1:]])
    assert [r[0] for r in rows[1]] == [r[0] for r in rows[0]] == [2, 3, 4]
    np.testing.assert_allclose(rows[1], rows[0], rtol=1e-5)
