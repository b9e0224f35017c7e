"""Shared model building blocks: initializers."""
from __future__ import annotations

import math

import torch

_TRUNC = 3.0    # truncation at +-3 sigma, as the JAX package's dense_init


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               fan_in=None) -> torch.Tensor:
    """Truncated normal at +-3 sigma, sigma = 1/sqrt(fan_in), cast to
    ``dtype``.

    Drawn by the inverse CDF of one float32 uniform draw from ``generator``
    (a CPU generator): unlike ``torch.nn.init.trunc_normal_``, whose
    sampling algorithm has changed between torch releases, this gives the
    same weights on every device and torch version for the same seed.
    """
    fan_in = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(fan_in, 1))
    cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
    u = torch.empty(shape, dtype=torch.float32).uniform_(
        2.0 * cdf(-_TRUNC) - 1.0, 2.0 * cdf(_TRUNC) - 1.0,
        generator=generator)
    z = (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC)
    return (std * z).to(dtype)
