"""Simulation toolkit of the PyTorch port: mixture signals, synthetic
phenotypes, genotypes.

The numpy helpers are the port's own copies of ``gvamp_tpu/sim.py``'s
(reference sim.cpp, sim_realistic.cpp, sim_heavy_tails.cpp and
utilities.cpp:48-153); the phenotype simulations run the product A x on the
container's device and draw their noise from a numpy ``Generator``.
"""

from __future__ import annotations

import numpy as np


def simulate_mixture(rng: np.random.Generator, m: int, vars_, probs) -> np.ndarray:
    """Draw m iid samples from sum_j probs_j N(0, vars_j) (utilities.cpp:48-88).

    vars_[j] == 0 is the spike at zero.
    """
    vars_ = np.asarray(vars_, np.float64)
    probs = np.asarray(probs, np.float64)
    comp = rng.choice(len(probs), size=m, p=probs / probs.sum())
    std = np.sqrt(vars_[comp])
    return rng.standard_normal(m) * std


def noise_precision_from_snr(snr: float, vars_, probs, mt: int) -> float:
    """gamw from SNR and the prior's signal power (utilities.cpp:143-153)."""
    expe = float(np.dot(vars_, probs))
    return snr / mt / expe


def two_group_prior(mt: int, cv: int, h2: float):
    """The sim.cpp truth: vars {0, h2/CV}, probs {1-CV/Mt, CV/Mt} (sim.cpp:78-79)."""
    return ([0.0, h2 / cv], [1.0 - cv / mt, cv / mt])


# sim_realistic.cpp:88-89 — the reference's empirical truth mixture
REALISTIC_VARS_BASE = (0.0, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
REALISTIC_PROBS = (0.9595661, 0.0008876436, 0.0367001, 0.002712435,
                   0.0001066884, 8.915961e-6, 1.814535e-5)


def realistic_prior(mt: int, h2: float):
    """sim_realistic.cpp:88-95 — 7-component empirical truth mixture.

    vars_true = {0, 1e-6, ..., 1e-1} rescaled by h2 / expe_varg where
    expe_varg = Mt * sum_j probs_j * vars_j (sim_realistic.cpp:91-95), so the
    expected genetic variance over Mt markers equals h2 exactly.
    """
    expe_varg = mt * sum(p * v for p, v in
                         zip(REALISTIC_PROBS, REALISTIC_VARS_BASE))
    scale = h2 / expe_varg
    return ([v * scale for v in REALISTIC_VARS_BASE], list(REALISTIC_PROBS))


def heavy_tails_prior(mt: int, cv: int, h2: float):
    """sim_heavy_tails.cpp:87-89 — spike + 3 slabs with vars v, 10v, 100v."""
    v = h2 / cv / (1 + 10 + 100) * 3
    p = cv / mt / 3
    return ([0.0, v, 10 * v, 100 * v], [1 - cv / mt, p, p, p])


def random_genotypes(rng: np.random.Generator, m: int, n: int,
                     maf_range=(0.05, 0.5), miss_rate: float = 0.0) -> np.ndarray:
    """Binomial(2, maf) dosage codes uint8[M, N] in PLINK 2-bit encoding."""
    maf = rng.uniform(*maf_range, size=(m, 1))
    dose = rng.binomial(2, maf, size=(m, n))
    codes = np.where(dose == 2, 0, np.where(dose == 1, 2, 3)).astype(np.uint8)
    if miss_rate > 0:
        codes[rng.random((m, n)) < miss_rate] = 1
    return codes


def _genetic_values(geno, beta_true: np.ndarray) -> np.ndarray:
    """g = A (sqrt(N) beta_true) per individual (sim.cpp:222-224), the
    product on the container's device."""
    x = geno.pad_m(beta_true * np.sqrt(geno.N))
    return geno.deplanarize(geno.ax(x))[: geno.N]


def simulate_linear_phenotype(geno, beta_true: np.ndarray, gamw: float,
                              rng: np.random.Generator) -> np.ndarray:
    """y = A (sqrt(N) beta_true) + N(0, 1/gamw) (sim.cpp:199-220); the
    product runs on the container's device, the noise comes from ``rng``."""
    z = _genetic_values(geno, beta_true)
    return z + rng.standard_normal(geno.N) / np.sqrt(gamw)


def simulate_probit_phenotype(geno, beta_true: np.ndarray, probit_var: float,
                              rng: np.random.Generator,
                              cov_effects: np.ndarray | None = None) -> np.ndarray:
    """Binary y: P(y=1) = Phi((g + Z eff)/sqrt(probit_var))
    (sim_probit.cpp:191-205), as ``gvamp_tpu/sim.py:90-102``."""
    from scipy.stats import norm

    g = _genetic_values(geno, beta_true)
    if cov_effects is not None and geno.covs is not None:
        g = g + geno.covs_np @ cov_effects
    u = rng.random(geno.N)
    return (u <= norm.cdf(g / np.sqrt(probit_var))).astype(np.float64)
