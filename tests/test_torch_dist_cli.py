"""The port's CLI on a marker mesh, in one process: ``--device cpu
--devices 4`` against the JAX CLI's ``--devices 4`` (a 4-device mesh over
tests/conftest.py's virtual CPU devices, its ``_mesh`` left as it is) at
the sizes of tests/test_dist.py (N=400 x M=1,500, 1% missing calls, 4
iterations, float64), with JAX's probe on both sides; a one-process
``--distributed 1`` run over gloo against the same run without it; and a
checkpoint resumed under another shard count, which raises naming both
Mpads.  The runs over two processes: tests/test_torch_dist_procs.py."""

import os
import socket

import numpy as np
import pytest
import torch

from gvamp_tpu import cli as jcli
from gvamp_tpu_torch import cli as tcli
from gvamp_tpu_torch import dist
from gvamp_tpu_torch import sim as tsim
from gvamp_tpu_torch.data import GenoBed
from gvamp_tpu_torch.io import plink, vecio
from test_torch_modes import jax_probe  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# tests/test_dist.py:46-62's dataset
SEED, N, M, CV, H2 = 5, 400, 1500, 25, 0.8
ITERS = 4


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def make_dataset(d):
    """t.bed / t.phen / t2.phen / t.bim in directory ``d``; returns the
    prior (vars, probs) and the truth."""
    rng = np.random.default_rng(SEED)
    codes = tsim.random_genotypes(rng, M, N, miss_rate=0.01)
    plink.write_bed(str(d / "t.bed"), codes)
    geno = GenoBed.from_arrays(
        plink.read_bed_slab(str(d / "t.bed"), N, M), np.zeros(N), N=N,
        standardize_phen=False, dtype=torch.float64, device="cpu")
    vars_t, probs_t = tsim.two_group_prior(M, CV, H2)
    beta = tsim.simulate_mixture(rng, M, vars_t, probs_t)
    plink.write_phen(str(d / "t.phen"), tsim.simulate_linear_phenotype(
        geno, beta, 1 / (1 - H2), rng))
    beta2 = tsim.simulate_mixture(rng, M, vars_t, probs_t)
    plink.write_phen(str(d / "t2.phen"), tsim.simulate_linear_phenotype(
        geno, beta2, 5.0, rng))
    plink.write_bim(str(d / "t.bim"), np.repeat(np.arange(1, 4), M // 3))
    return vars_t, probs_t, beta


def cli_args(d, prior, out_name, iters=ITERS, phen="t.phen"):
    vars_t, probs_t = prior
    phens = ",".join(str(d / p) for p in phen.split(","))
    return ["--run-mode", "infere", "--model", "linear",
            "--bed-file", str(d / "t.bed"), "--phen-files", phens,
            "--N", str(N), "--Mt", str(M), "--iterations", str(iters),
            "--rho", "0.3", "--vars", ",".join(map(str, vars_t)),
            "--probs", ",".join(map(str, probs_t)), "--out-dir", str(d),
            "--out-name", out_name, "--dtype", "float64", "--verbosity", "0"]


def read(d, name):
    return vecio.read_bin_shard(str(d / name), M, 0)


@pytest.fixture(scope="module")
def ds(tmp_path_factory):
    d = tmp_path_factory.mktemp("distcli")
    vars_t, probs_t, beta = make_dataset(d)
    return d, (vars_t, probs_t), beta


def test_cli_mesh_matches_jax_cli_mesh(ds, jax_probe):
    """--devices 4 on both CLIs: every iteration's dumps within rtol 1e-8
    (atol 1e-12), the LOO p-values within rtol 1e-6 (tests/test_dist.py's
    limits; the LOCO ones under the mesh: tests/test_torch_dist_procs.py),
    and the estimate recovers the truth."""
    d, prior, beta = ds
    extra = ["--devices", "4", "--store-pvals", "1"]
    jcli.main(cli_args(d, prior, "jx") + extra)
    tcli.main(["--device", "cpu"] + cli_args(d, prior, "pt") + extra)
    for it in range(1, ITERS + 1):
        for name in ("_it_{}.bin", "_r1_it_{}.bin", "_r2_it_{}.bin",
                     "_it_{}_x2_hat.bin"):
            f = name.format(it)
            np.testing.assert_allclose(read(d, "pt" + f), read(d, "jx" + f),
                                       rtol=1e-8, atol=1e-12, err_msg=f)
    np.testing.assert_allclose(read(d, "pt_pvals.bin"),
                               read(d, "jx_pvals.bin"), rtol=1e-6,
                               atol=1e-300)
    est = read(d, f"pt_it_{ITERS}.bin")
    assert np.corrcoef(est, beta)[0, 1] > 0.8


def test_one_process_group_equals_no_group(ds):
    """--distributed 1 with one process (a gloo group whose all-reduce and
    all-gather are copies) writes the dumps of the run without
    --distributed bit for bit, and leaves no process group behind."""
    d, prior, _ = ds
    tcli.main(["--device", "cpu"] + cli_args(d, prior, "np", iters=2))
    tcli.main(["--device", "cpu"] + cli_args(d, prior, "g1", iters=2) + [
        "--distributed", "1", "--coordinator", f"localhost:{free_port()}",
        "--n-processes", "1", "--process-id", "0"])
    assert not torch.distributed.is_initialized()
    for it in (1, 2):
        for name in ("_it_{}.bin", "_r1_it_{}.bin", "_z1_it_{}.csv"):
            a = (d / ("np" + name.format(it))).read_bytes()
            assert a == (d / ("g1" + name.format(it))).read_bytes(), name


def test_resume_under_another_shard_count_raises(ds):
    """A checkpoint written by a 4-shard run (Mpad 2,048) resumed on one
    device (Mpad 1,536): the port raises naming both Mpads rather than
    read a state of the wrong shape (the JAX package reads it and fails
    inside the step on mismatched shapes)."""
    d, prior, _ = ds
    ck = str(d / "ck4.npz")
    tcli.main(["--device", "cpu"] + cli_args(d, prior, "c4", iters=1)
              + ["--devices", "4", "--checkpoint", ck])
    args = cli_args(d, prior, "c1", iters=1)
    args[args.index("infere")] = "restart"
    with pytest.raises(ValueError, match="Mpad=2048.*Mpad=1536"):
        tcli.main(["--device", "cpu"] + args + ["--resume", ck])
    # the same shard count resumes
    tcli.main(["--device", "cpu"] + args + ["--resume", ck, "--devices", "4"])
    assert os.path.getsize(d / "c1_it_2.bin") > 0


def test_mesh_of_the_cli():
    """--devices on the CPU: K shards on the one CPU device; 0 and 1 mean
    one device and no mesh."""
    from gvamp_tpu_torch.options import Options
    base = ["--bed-file", "x.bed", "--phen-files", "x.phen", "--N", "10",
            "--Mt", "10"]
    assert tcli._mesh(Options.from_args(base), "cpu") is None
    assert tcli._mesh(Options.from_args(base + ["--devices", "1"]),
                      "cpu") is None
    mesh = tcli._mesh(Options.from_args(base + ["--devices", "3"]), "cpu")
    assert mesh.n_shards == 3 and set(mesh.devices) == {torch.device("cpu")}
    assert dist.world_size() == 1 and dist.is_main()
