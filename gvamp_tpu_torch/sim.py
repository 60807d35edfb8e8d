"""Phenotype simulation of the PyTorch port.

The numpy helpers of ``gvamp_tpu.sim`` (``simulate_mixture``,
``two_group_prior``, ``random_genotypes``, ...) import no JAX and are used
as they are; this module holds the torch version of the one JAX-using
function the main path needs.
"""

from __future__ import annotations

import numpy as np


def simulate_linear_phenotype(geno, beta_true: np.ndarray, gamw: float,
                              rng: np.random.Generator) -> np.ndarray:
    """y = A (sqrt(N) beta_true) + N(0, 1/gamw) (sim.cpp:199-220); the
    product runs on the container's device, the noise comes from ``rng``."""
    x = geno.pad_m(beta_true * np.sqrt(geno.N))
    z = geno.deplanarize(geno.ax(x))[: geno.N]
    return z + rng.standard_normal(geno.N) / np.sqrt(gamw)
