"""The port's CLI over two processes on the CPU: the counterpart of
tests/test_dist.py:96-184 at its sizes (N=400 x M=1,500, 1% missing
calls, float64).  Two processes x ``--devices 2`` joined over gloo
(``--distributed 1 --coordinator localhost:PORT --n-processes 2
--process-id i``) against one process with ``--devices 4``, the same 4
shards: the estimates within rtol 1e-8 at every iteration, the same dump
files, the p-values within rtol 1e-6; a 2-trait run; a checkpoint written
and resumed under the two-process mesh equal to the uninterrupted run; and
the end-of-run replication check, reached by every run and raising when
the processes disagree.  Every process gets its own timeout, so that a
rank that fails cannot hang the test."""

import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_dist_cli import cli_args, free_port, make_dataset, read

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(argv):
    return subprocess.Popen([sys.executable] + argv, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _cli(args):
    return _spawn(["-m", "gvamp_tpu_torch.cli", "--device", "cpu"] + args)


def _pair(args):
    """Two processes of 2 shards each over one gloo group."""
    port = free_port()
    return [_cli(args + ["--devices", "2", "--distributed", "1",
                         "--coordinator", f"localhost:{port}",
                         "--n-processes", "2", "--process-id", str(i)])
            for i in range(2)]


def _finish(procs):
    """Each process's output; a process that fails or outlasts TIMEOUT
    fails the test (the others are killed)."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"a process outlasted {TIMEOUT} s: a rank hung")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of this file, the independent ones started together."""
    d = tmp_path_factory.mktemp("distprocs")
    vars_t, probs_t, beta = make_dataset(d)
    prior = (vars_t, probs_t)
    pv = ["--store-pvals", "1", "--bim-file", str(d / "t.bim")]
    two = "t.phen,t2.phen"
    ck = str(d / "ck.npz")
    groups = {
        "single": [_cli(cli_args(d, prior, "one") + pv + ["--devices", "4"])],
        "pair": _pair(cli_args(d, prior, "two") + pv),
        "mt_single": [_cli(cli_args(d, prior, "mts", 3, phen=two)
                           + ["--devices", "4"])],
        "mt_pair": _pair(cli_args(d, prior, "mtp", 3, phen=two)),
        "ck_first": _pair(cli_args(d, prior, "ck", 2) + ["--checkpoint", ck]),
    }
    outs = {k: _finish(v) for k, v in groups.items()}
    resume = cli_args(d, prior, "ck", 2)
    resume[resume.index("infere")] = "restart"
    outs["ck_resume"] = _finish(_pair(resume + ["--resume", ck]))
    return d, beta, outs


def test_two_processes_match_one_process(runs):
    d, beta, outs = runs
    for it in range(1, 5):
        np.testing.assert_allclose(read(d, f"two_it_{it}.bin"),
                                   read(d, f"one_it_{it}.bin"), rtol=1e-8,
                                   atol=1e-12, err_msg=f"iteration {it}")
    # the same dump files, written once (by the first process)
    names = {p.name[3:] for p in d.iterdir() if p.name.startswith("two")}
    assert names == {p.name[3:] for p in d.iterdir()
                     if p.name.startswith("one")}
    assert {"_pvals.bin", "_pvals_LOCO.bin", "_LOCO_chr_1.csv",
            "_gam1s.csv", "_z1_it_4.csv", "_it_4_x2_hat.bin"} <= names
    for name in sorted(names):
        if name.endswith(".bin") and "pvals" not in name:
            np.testing.assert_allclose(read(d, "two" + name),
                                       read(d, "one" + name), rtol=1e-8,
                                       atol=1e-12, err_msg=name)
        elif name.endswith(".csv"):
            np.testing.assert_allclose(np.loadtxt(d / ("two" + name)),
                                       np.loadtxt(d / ("one" + name)),
                                       rtol=1e-8, atol=1e-12, err_msg=name)
    for suf in ("_pvals.bin", "_pvals_LOCO.bin"):
        np.testing.assert_allclose(read(d, "two" + suf), read(d, "one" + suf),
                                   rtol=1e-6, atol=1e-300, err_msg=suf)
    assert np.corrcoef(read(d, "two_it_4.bin"), beta)[0, 1] > 0.8
    # the replication check ran, and only the first process logs it
    assert "replicated: 24 state tensors agree over 2 processes (gloo)" in \
        outs["pair"][0]
    assert "replicated" not in outs["pair"][1]


def test_two_processes_multi_trait(runs):
    d, _, outs = runs
    for t in range(2):
        for it in range(1, 4):
            np.testing.assert_allclose(
                read(d, f"mtp_phen{t}_it_{it}.bin"),
                read(d, f"mts_phen{t}_it_{it}.bin"), rtol=1e-8, atol=1e-12,
                err_msg=f"trait {t}, iteration {it}")
    assert "agree over 2 processes" in outs["mt_pair"][0]


def test_two_process_checkpoint_resumes(runs):
    """Two iterations with --checkpoint, then restart --resume for two
    more, both under the two-process mesh: the iterations 3 and 4 equal
    the uninterrupted run's bit for bit."""
    d, _, outs = runs
    for it in (3, 4):
        np.testing.assert_array_equal(read(d, f"ck_it_{it}.bin"),
                                      read(d, f"two_it_{it}.bin"))
    assert "agree over 2 processes" in outs["ck_resume"][0]


_DIVERGE = """
import sys, torch
from gvamp_tpu_torch import dist
rank = dist.initialize(sys.argv[1], 2, int(sys.argv[2]), device="cpu")
mesh = dist.Mesh(1, "cpu")
x = torch.linspace(0.0, 1.0, 1000, dtype=torch.float64)
assert mesh.assert_replicated(x) == 1
if rank == 1:
    x[17] = x[17] + 2.0 ** -40
try:
    mesh.assert_replicated(torch.ones(3), x)
except RuntimeError as e:
    print("raised:", e)
dist.finalize()
"""


def test_replication_check_raises_on_divergence():
    """One element of one process's vector 2^-40 away from the other's:
    both processes raise, naming the tensor that differs."""
    port = free_port()
    outs = _finish([_spawn(["-c", _DIVERGE, f"localhost:{port}", str(i)])
                    for i in range(2)])
    for out in outs:
        assert "raised: the 2 processes disagree on tensors [1] of 2" in out
