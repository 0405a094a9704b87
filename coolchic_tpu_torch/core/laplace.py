"""Laplace CDF and the differentiable rate proxy.

Reference parity: coolchic/component/core/arm.py:448-485 and
coolchic_tpu/core/laplace.py.
"""

from __future__ import annotations

import torch

from coolchic_tpu_torch.core.constants import MIN_PROBA

_LOG2 = 0.6931471805599453  # ln(2)


def laplace_cdf(x: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    shifted = x - mu
    return 0.5 - 0.5 * torch.sign(shifted) * torch.expm1(-torch.abs(shifted) / scale)


def rate_bits(x: torch.Tensor, mu: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-symbol rate in bits: -log2 max(P[x-0.5 < X <= x+0.5], 2^-16).

    torch.maximum splits the gradient at equality, as jnp.maximum does
    (torch.clamp would pass all of it)."""
    proba = laplace_cdf(x + 0.5, mu, scale) - laplace_cdf(x - 0.5, mu, scale)
    proba = torch.maximum(proba, proba.new_full((), MIN_PROBA))
    return -torch.log(proba) / _LOG2
