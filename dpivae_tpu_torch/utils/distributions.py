"""1-D distributions (counterpart of dpivae_tpu/utils/distributions.py:
27-101, 217+).

Parameters are Python floats; ``sample`` draws from an explicit
``torch.Generator`` on the generator's device, and ``log_prob``/``icdf``/
``cdf`` follow the dtype and device of their tensor argument.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from dpivae_tpu_torch.utils import GAUSSIAN_CONST, rand, randn


@dataclasses.dataclass(frozen=True)
class Normal:
    loc: float
    scale: float

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()):
        return self.loc + self.scale * randn(shape, generator, generator.device)

    def log_prob(self, z):
        zn = (z - self.loc) / self.scale
        return -0.5 * zn * zn + GAUSSIAN_CONST - math.log(self.scale)

    def icdf(self, u):
        return self.loc + self.scale * math.sqrt(2.0) * torch.special.erfinv(
            2.0 * u - 1.0
        )

    def cdf(self, z):
        return 0.5 * (1.0 + torch.special.erf(
            (z - self.loc) / (self.scale * math.sqrt(2.0))
        ))


@dataclasses.dataclass(frozen=True)
class Uniform:
    low: float
    high: float

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()):
        u = rand(shape, generator, generator.device)
        return self.low + (self.high - self.low) * u

    def log_prob(self, z):
        inside = (z >= self.low) & (z <= self.high)
        return torch.where(
            inside,
            torch.full_like(z, -math.log(self.high - self.low)),
            torch.full_like(z, -math.inf),
        )

    def icdf(self, u):
        return self.low + (self.high - self.low) * u

    def cdf(self, z):
        return torch.clamp((z - self.low) / (self.high - self.low), 0.0, 1.0)


class MarginalDistribution:
    """Product of independent 1-D distributions over the last axis.

    ``log_prob`` returns the per-dimension log density (not summed), as the
    JAX package does; callers sum over the last axis.
    """

    def __init__(self, distributions: Sequence):
        self.distributions = tuple(distributions)
        self.n_z = len(self.distributions)

    def log_prob(self, z):
        return torch.stack(
            [d.log_prob(z[..., i]) for i, d in enumerate(self.distributions)],
            dim=-1,
        )

    def icdf(self, u):
        u = torch.atleast_2d(u)
        return torch.stack(
            [d.icdf(u[..., i]) for i, d in enumerate(self.distributions)],
            dim=-1,
        )

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()):
        return torch.stack(
            [d.sample(generator, shape) for d in self.distributions], dim=-1
        )


_DIST_REGISTRY = {
    "normal": Normal,
    "uniform": Uniform,
}


def make_distribution(name: str, **kwargs):
    """Build a distribution from a declarative spec name (the case factor
    tables' ``{"dist": ..., "args": {...}}``)."""
    try:
        cls = _DIST_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown distribution {name!r}; have {sorted(_DIST_REGISTRY)}"
        ) from None
    return cls(**kwargs)
