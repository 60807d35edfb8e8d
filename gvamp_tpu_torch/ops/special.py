"""Special functions of the probit denoiser, in plain PyTorch.

Port of ``gvamp_tpu/ops/special.py:19-66`` (reference utilities.cpp:336-409):
the scaled complementary error function erfcx and, built on it, Phi, its
logarithm and the inverse Mills ratio, each stable deep in the left tail.
Elementwise, so they run on whichever device their input lies.
"""

from __future__ import annotations

import torch

_SQRT1_2 = 0.7071067811865476
_SQRT_2PI = 2.5066282746310002


def erfcx(x: torch.Tensor) -> torch.Tensor:
    """exp(x^2) erfc(x), stable for both signs: the direct product for
    |x| < 4, a 16-level Laplace continued fraction beyond (relative error
    below 1e-15), and the reflection erfcx(x) = 2 exp(x^2) - erfcx(-x) for
    x < 0."""
    a = torch.abs(x)
    small = a < 4.0
    am = torch.clamp(a, max=4.0)
    direct = torch.exp(torch.square(am)) * torch.erfc(am)
    z = torch.clamp(a, min=4.0)
    cf = torch.zeros_like(z)
    for n in range(16, 0, -1):
        cf = (0.5 * n) / (z + cf)
    large = 1.0 / (_SQRT_2PI * _SQRT1_2 * (z + cf))  # 1/(sqrt(pi)(z + cf))
    pos = torch.where(small, direct, large)
    return torch.where(x >= 0, pos, 2.0 * torch.exp(torch.square(x)) - pos)


def normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """Phi(x) (reference utilities.cpp:336-339)."""
    return 0.5 * torch.erfc(-x * _SQRT1_2)


def normal_logcdf(x: torch.Tensor) -> torch.Tensor:
    """log Phi(x), stable in the deep left tail:
    Phi(x) = 0.5 erfcx(-x/sqrt2) exp(-x^2/2)."""
    return torch.log(0.5 * erfcx(-x * _SQRT1_2)) - torch.square(x) / 2.0


def phi_over_Phi(c: torch.Tensor) -> torch.Tensor:
    """N(c; 0, 1) / Phi(c), the inverse Mills ratio (reference
    vamp_probit.cpp:686): 2 / (sqrt(2 pi) erfcx(-c/sqrt(2)))."""
    return 2.0 / (_SQRT_2PI * erfcx(-c * _SQRT1_2))
