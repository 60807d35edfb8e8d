"""Engine options that no other port test passes, pinned against the JAX
package.  Through both CLIs (``test_torch_modes._both_clis``, its dataset
and JAX's probe, float64, 5 iterations): ``--gamma-damp``,
``--use-freeze``, ``--init-est``, ``--true-signal-files``,
``--learn-vars``, ``--EM-max-iter``, ``--CG-max-iter``, ``--slq-k``,
``--cg-plateau``, ``--alpha-scale`` and ``--dump-every``; every dump and
history file of the port within that file's float64 limit (1e-9 of the
largest entry) of JAX's.  At the library level, where the two CLIs draw
from different generators, with JAX's draws passed in:
``deflate_iters`` (JAX's start block of top_eigs) and ``stab_gamma``
(probit with JAX's p1, Huber with JAX's Monte-Carlo draws), each against
the recipe's float64 limits with the same CG counts."""

import numpy as np
import pytest
import torch

from gvamp_tpu import linear as jlinear
from gvamp_tpu import probit as jprobit
from gvamp_tpu import robust as jrobust
from gvamp_tpu.io import vecio
from gvamp_tpu_torch import linear as tlinear
from gvamp_tpu_torch import probit as tprobit
from gvamp_tpu_torch import robust as trobust
from test_torch_modes import M, N, TOL, _both_clis, ds  # noqa: F401
from test_torch_modes import jax_probe, one_device  # noqa: F401
import test_torch_deflate as td_
import test_torch_linear as tl_
import test_torch_probit as tp_
import test_torch_robust as tr_

torch.set_num_threads(1)

ITERS = 5


def _files(tmp_path, ds):
    """The option files: the first 50 markers frozen, an initial
    estimate, the truth."""
    frz = np.zeros(M)
    frz[:50] = 1.0
    paths = dict(freeze=tmp_path / "frz.bin", truth=tmp_path / "truth.bin")
    vecio.write_bin_shard(str(paths["freeze"]), frz, 0)
    vecio.write_bin_shard(str(paths["truth"]), ds.beta, 0)
    paths["est"] = ds.dir / "run_it_2.bin"
    return {k: str(v) for k, v in paths.items()}


OPTIONS = {
    "gamma_damp": lambda f: ["--gamma-damp", "0.7"],
    "use_freeze": lambda f: ["--use-freeze", "1", "--freeze-index-file",
                             f["freeze"]],
    "init_est": lambda f: ["--init-est", "1", "--estimate-file", f["est"]],
    "true_signal": lambda f: ["--true-signal-files", f["truth"]],
    "learn_vars": lambda f: ["--learn-vars", "0"],
    "em_max_iter": lambda f: ["--EM-max-iter", "3", "--EM-err-thr", "1e-3"],
    "cg_max_iter": lambda f: ["--CG-max-iter", "2"],
    "slq_k": lambda f: ["--slq-k", "12"],
    "cg_plateau": lambda f: ["--cg-plateau", "1"],
    "alpha_scale": lambda f: ["--alpha-scale", "0.5"],
    "dump_every": lambda f: ["--dump-every", "2"],
}


def _outputs(d, prefix):
    """{suffix: values} of every file a run wrote under ``prefix``."""
    out = {}
    for p in d.iterdir():
        if not p.name.startswith(prefix + "_"):
            continue
        suf = p.name[len(prefix):]
        out[suf] = (vecio.read_bin_shard(str(p), M, 0) if suf.endswith(".bin")
                    else np.loadtxt(p, delimiter=","))
    return out


@pytest.mark.parametrize("option", list(OPTIONS))
def test_option_through_both_clis(option, ds, capsys, jax_probe, tmp_path):
    args = ["--run-mode", "infere", "--bed-file", ds.bed, "--phen-files",
            ds.phen, "--N", str(N), "--Mt", str(M), "--iterations",
            str(ITERS), "--rho", "0.3", "--probs",
            ",".join(map(str, ds.probs)), "--vars",
            ",".join(map(str, ds.vars)), "--out-dir", str(tmp_path),
            "--out-name", "o"] + OPTIONS[option](_files(tmp_path, ds))
    _both_clis(capsys, args, "float64")
    got, want = _outputs(tmp_path, "ot"), _outputs(tmp_path, "oj")
    assert set(got) == set(want) and "_gam1s.csv" in got
    its = {int(s.split("_it_")[1].split(".")[0].split("_")[0])
           for s in got if "_it_" in s}
    assert its == ({2, 4} if option == "dump_every" else set(range(1, 6)))
    for suf, w in want.items():
        np.testing.assert_allclose(got[suf], w, rtol=0,
                                   atol=TOL["float64"] * np.abs(w).max(),
                                   err_msg=suf)


def test_deflate_iters_matches_jax():
    """deflate_k 4 with deflate_iters 3 (not the default) in the linear
    engine, JAX's start block passed in: x1 within 1e-8 of max|x1|, the
    same CG counts (tests/test_torch_deflate.py's f64 limits)."""
    prob = tl_._make_problem(0.02)
    beta, vars_t, probs_t = prob[2:5]
    j, t = tl_._genos(prob, torch.float64)
    kw = dict(max_iter=4, deflate_k=4, deflate_iters=3, **tl_.CFG)
    cfg_j, cfg_t = jlinear.VampConfig(**kw), tlinear.VampConfig(**kw)
    bern = np.asarray(jlinear.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    x_j, _, h_j = jlinear.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = tlinear.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                bern=bern, defl_v0=td_.jax_v0(j, cfg_j.seed,
                                                              4))
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    assert tl_._rel(x_t, x_j) < 1e-8


def test_stab_gamma_probit_matches_jax():
    """stab_gamma 0.5 in the probit engine (2% missing calls, 2
    covariates), JAX's probe and p1 passed in: x1 within 1e-8 of max|x1|
    (measured 6.6e-10) and the same CG counts."""
    prob = tp_._problem(0.02, 2)
    vars_t, probs_t = prob[3:5]
    j, t = tp_._genos(prob, torch.float64)
    kw = dict(max_iter=4, stab_gamma=0.5, **tp_.CFG)
    cfg_j, cfg_t = jprobit.ProbitConfig(**kw), tprobit.ProbitConfig(**kw)
    bern = np.asarray(jprobit.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    p1 = np.asarray(jprobit.init_state(j, cfg_j, probs_t, vars_t).p1)
    x_j, _, h_j = jprobit.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = tprobit.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                bern=bern, p1=p1)
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    assert tp_._rel(x_t, x_j) < 1e-8


def test_stab_gamma_huber_matches_jax():
    """stab_gamma 0.5 in the Huber engine (complete genotypes), JAX's probe
    and Monte-Carlo draws passed in: x1 within 1e-11 of max|x1| (measured
    2.5e-15), the same CG counts and deltaH."""
    prob = tr_._problem(0.0)
    vars_t, probs_t = prob[3:5]
    j, t = tr_._genos(prob, torch.float64)
    kw = dict(max_iter=4, stab_gamma=0.5, **tr_.CFG)
    cfg_j, cfg_t = jrobust.RobustConfig(**kw), trobust.RobustConfig(**kw)
    bern = np.asarray(jrobust.make_bern_probe(j, cfg_j.seed, cfg_j.n_probes))
    x_j, _, h_j = jrobust.infer(j, cfg_j, probs_t, vars_t, verbose=False)
    x_t, _, h_t = trobust.infer(t, cfg_t, probs_t, vars_t, verbose=False,
                                bern=bern, mc_draws=tr_.jax_draws(j, cfg_j, 4))
    assert [h["cg_iters"] for h in h_t] == [int(h["cg_iters"]) for h in h_j]
    assert [float(h["deltaH"]) for h in h_t] == [float(h["deltaH"])
                                                 for h in h_j]
    assert tr_._rel(x_t, x_j) < 1e-11
