"""Every model, option and run mode of the port's CLI on a 2-shard marker
mesh (``--device cpu --devices 2``) against the same run on one device,
float64, on tests/test_torch_modes.py's dataset: the dual solve, ``--red``,
cross-validation, the probe path, probit with covariates, Huber, a 2-trait
run with p-values, ``--type-data meth`` (a dense matrix of standard
normal probes), and the run modes test, pvals-calc, predict_single and
sim.  Every file the runs write (estimates, histories, p-values,
predictions, the simulated truth) within rtol 1e-8 of the one-device
run's (p-values rtol 1e-6, tests/test_dist.py's limit), and every printed
score within 1e-9.  The one-device run pads the markers to 512 and the
mesh to 1,024; the probes' real rows do not depend on that.  (Deflation's
start block does, so ``--deflate-k`` is held against JAX's mesh at the
library level instead: tests/test_torch_dist_engines.py covers the
engines.)"""

import re

import numpy as np
import pytest
import torch

from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch.io import plink, vecio
from test_torch_modes import M, N, ds  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _infer(ds, *extra, phen=None, model="linear", bed=None):
    return ["--run-mode", "infere", "--model", model, "--bed-file",
            bed or ds.bed,
            "--phen-files", phen or ds.phen, "--N", str(N), "--Mt", str(M),
            "--iterations", "4", "--rho", "0.3",
            "--probs", ",".join(map(str, ds.probs)),
            "--vars", ",".join(map(str, ds.vars)), *extra]


def _meth(ds):
    """A dense --type-data meth run on a matrix written beside the .bed."""
    path = ds.dir / "m.meth"
    if not path.exists():
        plink.write_meth(str(path),
                         np.random.default_rng(8).standard_normal((M, N)))
    return _infer(ds, "--type-data", "meth", bed=str(path))


RUNS = {
    "dual": lambda ds: _infer(ds, "--use-XXT-denoiser", "1"),
    "red": lambda ds: _infer(ds, "--red", "1"),
    "cross_val": lambda ds: _infer(ds, "--use-cross-val", "1"),
    "probe_path": lambda ds: _infer(ds, "--use-slq", "0", "--store-pip", "1"),
    "probit_2cov": lambda ds: _infer(ds, "--cov-file", ds.cov, "--C", "2",
                                     phen=ds.cc, model="bin_class"),
    "huber": lambda ds: _infer(ds, model="robust"),
    "meth": _meth,
    "multi_pvals": lambda ds: _infer(ds, "--store-pvals", "1", "--bim-file",
                                     ds.bim, phen=f"{ds.phen},{ds.phen2}"),
    "test": lambda ds: [
        "--run-mode", "test", "--bed-file-test", ds.bed, "--phen-files-test",
        ds.phen, "--N-test", str(N), "--Mt-test", str(M), "--estimate-file",
        str(ds.dir / "run_it_1.bin"), "--test-iter-range", "1,4"],
    "pvals_calc": lambda ds: [
        "--run-mode", "pvals-calc", "--bed-file", ds.bed, "--phen-files",
        ds.phen, "--bim-file", ds.bim, "--N", str(N), "--Mt", str(M),
        "--estimate-file", str(ds.dir / "run_it_2.bin"),
        "--test-iter-range", "2,3"],
    "predict_single": lambda ds: [
        "--run-mode", "predict_single", "--bed-file-test", ds.bed,
        "--N-test", str(N), "--Mt-test", str(M), "--estimate-file",
        str(ds.dir / "run_it_3.bin")],
    "sim": lambda ds: [
        "--run-mode", "sim", "--bed-file", ds.bed, "--N", str(N), "--Mt",
        str(M), "--iterations", "3", "--h2", "0.8", "--CV", "12"],
}


def _files(d, name):
    out = {}
    for p in sorted(d.iterdir()):
        if not p.name.startswith(name + "_"):
            continue
        suf = p.name[len(name):]
        out[suf] = (vecio.read_bin_shard(str(p), M, 0) if suf.endswith(".bin")
                    else np.loadtxt(p, delimiter=",", ndmin=1))
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_mesh_run_equals_one_device(run, ds, tmp_path, capsys):
    printed = {}
    for k in ("1", "2"):
        capsys.readouterr()
        tcli.main(["--device", "cpu", "--dtype", "float64", "--verbosity",
                   "0", "--devices", k, "--out-dir", str(tmp_path),
                   "--out-name", f"d{k}"] + RUNS[run](ds))
        printed[k] = [float(x) for x in re.findall(
            r"[-+]?\d+\.\d+(?:e[-+]?\d+)?", capsys.readouterr().out)]
    one, two = _files(tmp_path, "d1"), _files(tmp_path, "d2")
    assert set(one) == set(two)
    assert one or run == "test"
    for suf, want in one.items():
        rtol = 1e-6 if "pvals" in suf else 1e-8
        np.testing.assert_allclose(two[suf], want, rtol=rtol, atol=1e-12,
                                   err_msg=suf)
    np.testing.assert_allclose(printed["2"], printed["1"], rtol=0, atol=1e-9)
