"""The port's probit engine (2 covariates, 2% missing calls) and its
2-trait multi-trait engine on a 4-shard marker mesh against the JAX
package's on a 4-device mesh, in float64, at every iteration (the runs and
limits of tests/test_torch_dist_engines.py)."""

import pytest
import torch

from test_torch_dist_engines import RUNS, _same_run

torch.set_num_threads(1)


@pytest.mark.parametrize("run", ["probit_2cov", "multi_2trait"])
def test_engine_on_mesh_matches_jax_mesh(run):
    _same_run(*RUNS[run]())
