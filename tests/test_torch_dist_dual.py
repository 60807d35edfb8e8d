"""The port's dual (XXT) linear engine and its Huber engine on a 4-shard
marker mesh against the JAX package's on a 4-device mesh, in float64, at
every iteration (the runs and limits of tests/test_torch_dist_engines.py;
the dual Jacobi diagonal comes from the meshed people statistics)."""

import pytest
import torch

from test_torch_dist_engines import RUNS, _same_run

torch.set_num_threads(1)


@pytest.mark.parametrize("run", ["linear_dual", "huber"])
def test_engine_on_mesh_matches_jax_mesh(run):
    _same_run(*RUNS[run]())
