"""The port's marker mesh in float32 against the JAX package's: under K in
{2, 4, 8} CPU shards each kernel's plain version runs per slab (the digit
products ``axm_i8a`` / ``atxm_i8a`` / ``axm_i8`` / ``atxm_i8``, ``atx``,
``ax`` and the fused dual Grams), against JAX's Pallas kernels in
interpret mode under ``shard_map`` over K of the test run's virtual CPU
devices, on the same words; the checks and limits of
tests/test_torch_dist.py's ``check_products``."""

import pytest
import torch

from test_torch_dist import check_products

torch.set_num_threads(1)


@pytest.mark.parametrize("complete", [True, False], ids=["complete", "miss"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_kernels_match_jax_mesh(k, complete):
    check_products(k, torch.float32, complete)
