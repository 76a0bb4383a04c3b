"""Distributions (counterpart of dpivae_tpu/utils/distributions.py).

The 1-D ``Normal`` and ``Uniform`` take Python floats; the box
distributions of the transfer study (``BoxUniform``,
``UniformBoxMixture``) take numpy arrays, and ``MixtureSameFamily``
weights and components. ``sample`` draws from an explicit
``torch.Generator`` on the generator's device, and ``log_prob``/``icdf``/
``cdf`` follow the dtype and device of their tensor argument.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
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


def _like(a, z: torch.Tensor) -> torch.Tensor:
    """A parameter array as a tensor of ``z``'s dtype and device."""
    return torch.as_tensor(np.asarray(a), dtype=z.dtype, device=z.device)


def _box_log_prob(low, high, z):
    """Per-dimension uniform log densities over [low, high] (closed), -inf
    outside."""
    inside = (z >= low) & (z <= high)
    return torch.where(inside, -torch.log(high - low),
                       torch.tensor(-math.inf, dtype=z.dtype, device=z.device))


@dataclasses.dataclass(frozen=True)
class BoxUniform:
    """Independent uniform over a box; ``low``/``high`` are 1-D arrays."""

    low: np.ndarray
    high: np.ndarray

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()):
        low = np.asarray(self.low, np.float32)
        u = rand((*shape, low.shape[-1]), generator, generator.device)
        return _like(low, u) + (_like(self.high, u) - _like(low, u)) * u

    def log_prob(self, z):
        return torch.sum(_box_log_prob(_like(self.low, z),
                                       _like(self.high, z), z), dim=-1)


@dataclasses.dataclass(frozen=True)
class UniformBoxMixture:
    """Equal-weight mixture of axis-aligned uniform boxes, the transfer
    study's 3-quadrant training domains; ``lows``/``highs`` have shape
    (n_components, n_dims)."""

    lows: np.ndarray
    highs: np.ndarray

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()):
        n_comp, n_dim = np.shape(self.lows)
        comp = torch.randint(n_comp, tuple(shape), generator=generator,
                             device=generator.device)
        u = rand((*shape, n_dim), generator, generator.device)
        low, high = _like(self.lows, u)[comp], _like(self.highs, u)[comp]
        return low + (high - low) * u

    def log_prob(self, z):
        lows = _like(self.lows, z)[:, None, :]
        highs = _like(self.highs, z)[:, None, :]
        per_comp = torch.sum(_box_log_prob(lows, highs, z[None]), dim=-1)
        n_comp = np.shape(self.lows)[0]
        return torch.logsumexp(per_comp, dim=0) - math.log(float(n_comp))


@dataclasses.dataclass(frozen=True)
class MixtureSameFamily:
    """Weighted mixture of components with the ``sample``/``log_prob``
    protocol (scalar or vector events, as ``BoxUniform``). Negative or
    zero-sum weights are refused: their log-weights would be NaN."""

    weights: Tuple[float, ...]
    components: Tuple

    def __post_init__(self):
        if len(self.weights) != len(self.components):
            raise ValueError("weights and components length mismatch")
        w = np.asarray(self.weights, np.float64)
        if (w < 0.0).any():
            raise ValueError("mixture weights must be non-negative")
        if not w.sum() > 0.0:
            raise ValueError("mixture weights must have a positive sum")

    def _log_weights(self, like: torch.Tensor) -> torch.Tensor:
        w = torch.as_tensor(np.asarray(self.weights, np.float32),
                            device=like.device)
        return torch.log(w / torch.sum(w)).to(like.dtype)

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()):
        w = torch.as_tensor(np.asarray(self.weights, np.float32),
                            device=generator.device)
        n = math.prod(shape)
        comp = torch.multinomial(w / torch.sum(w), max(n, 1), replacement=True,
                                 generator=generator)[:n].reshape(shape)
        samples = torch.stack([c.sample(generator, shape)
                               for c in self.components])
        onehot = torch.nn.functional.one_hot(comp, len(self.components))
        onehot = torch.movedim(onehot, -1, 0).to(samples.dtype)
        onehot = onehot.reshape(onehot.shape
                                + (1,) * (samples.ndim - onehot.ndim))
        return torch.sum(onehot * samples, dim=0)

    def log_prob(self, z):
        per_comp = torch.stack([c.log_prob(z) for c in self.components])
        logw = self._log_weights(per_comp).reshape(
            (-1,) + (1,) * (per_comp.ndim - 1))
        return torch.logsumexp(per_comp + logw, dim=0)


_DIST_REGISTRY = {
    "normal": Normal,
    "uniform": Uniform,
}


def make_distribution(name: str, **kwargs):
    """Build a distribution from a declarative spec name (the case factor
    tables' ``{"dist": ..., "args": {...}}``). A mixture nests component
    specs::

        make_distribution("mixture", weights=[0.3, 0.7],
                          components=[{"dist": "normal",
                                       "args": {"loc": 0., "scale": 1.}},
                                      {"dist": "uniform",
                                       "args": {"low": 2., "high": 3.}}])
    """
    if name.lower() == "mixture":
        return MixtureSameFamily(
            tuple(kwargs["weights"]),
            tuple(make_distribution(spec["dist"], **spec.get("args", {}))
                  for spec in kwargs["components"]))
    try:
        cls = _DIST_REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown distribution {name!r}; have {sorted(_DIST_REGISTRY)}"
        ) from None
    return cls(**kwargs)
