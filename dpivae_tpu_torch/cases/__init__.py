"""Declarative case studies (counterpart of dpivae_tpu/cases/__init__.py).

A case is a frozen dataclass built on demand by ``get_case(name)``. Only
``simple_beam`` is registered in this package so far; its frozen
surrogate is a tanh MLP over numpy weights read from the JAX package's
bundled archive by file path (reading a data file imports nothing).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.utils.priors import (
    factor_indices,
    get_prior_dist,
    get_shapes_from_factors,
    phys_covariate_indices,
)


@dataclasses.dataclass(frozen=True)
class Factor:
    """One ground-truth generative factor."""

    name: str
    lb: float
    ub: float
    dist: str  # "uniform" | "normal"
    args: Mapping[str, float]
    type: str  # "x" | "c" | "y" | "f"
    label: str
    val: float
    phys: bool = False


@dataclasses.dataclass(frozen=True)
class PriorSpec:
    """Fixed VAE prior on one z_x dim."""

    name: str
    lb: float
    ub: float
    dist: str
    args: Mapping[str, float]


@dataclasses.dataclass(frozen=True)
class Surrogate:
    """Frozen tanh MLP with an input StandardScaler, as a callable
    (counterpart of dpivae_tpu/cases/__init__.py:57-91).

    Weights are numpy constants in the JAX layout ``w: (in, out)``; they
    are copied to the input's device and dtype at call time.
    """

    params: Any  # {"layers": ({"w", "b"}, ...)}
    scaler_mean: np.ndarray
    scaler_scale: np.ndarray

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        def t(a):
            return torch.as_tensor(a, dtype=z.dtype, device=z.device)

        h = (z - t(self.scaler_mean)) / t(self.scaler_scale)
        layers = self.params["layers"]
        for layer in layers[:-1]:
            h = torch.tanh(h @ t(layer["w"]) + t(layer["b"]))
        return h @ t(layers[-1]["w"]) + t(layers[-1]["b"])


@dataclasses.dataclass(frozen=True)
class Case:
    """A complete case study definition."""

    name: str
    factors: Tuple[Factor, ...]
    prior_x: Tuple[PriorSpec, ...]
    nd_x: int
    t_min: float
    t_max: float
    sigma_x: float
    sigma_c: float
    sigma_y: float
    full_model: Callable
    part_model: Callable
    presets: Mapping[str, Mapping[str, Any]]
    x_unit: str = ""
    y_unit: str = ""
    ylim: Tuple[float, float] = (-1.0, 1.0)
    x_full: Optional[np.ndarray] = None
    y_full: Optional[np.ndarray] = None

    @property
    def shapes(self) -> Tuple[int, int, int, int, int]:
        """(nz_x, nd_c, nd_y, nd_f, nd_p)"""
        return get_shapes_from_factors(self.factors)

    @property
    def nz_x(self) -> int:
        return self.shapes[0]

    @property
    def nd_c(self) -> int:
        return self.shapes[1]

    @property
    def nd_y(self) -> int:
        return self.shapes[2]

    @property
    def nd_f(self) -> int:
        return self.shapes[3]

    @property
    def nd_p(self) -> int:
        return self.shapes[4]

    @property
    def t(self) -> np.ndarray:
        return np.linspace(self.t_min, self.t_max, self.nd_x)

    @property
    def idx_c_phys(self) -> Tuple[int, ...]:
        return tuple(phys_covariate_indices(self.factors))

    @property
    def z_idx_x(self) -> Tuple[int, ...]:
        return tuple(factor_indices(self.factors, "x"))

    @property
    def z_idx_c(self) -> Tuple[int, ...]:
        return tuple(factor_indices(self.factors, "c"))

    @property
    def z_idx_y(self) -> Tuple[int, ...]:
        return tuple(factor_indices(self.factors, "y"))

    def gt_dist(self):
        """Product ground-truth sampling distribution over all factors."""
        return get_prior_dist(self.factors)

    def prior_x_dist(self):
        """Fixed marginal prior over z_x."""
        return get_prior_dist(self.prior_x)


_REGISTRY: Dict[str, Callable[[], Case]] = {}


def register_case(name: str):
    def wrap(builder: Callable[[], Case]):
        _REGISTRY[name] = builder
        return builder

    return wrap


@functools.lru_cache(maxsize=None)
def get_case(name: str) -> Case:
    # Imported lazily so the artifact is read on first use
    from dpivae_tpu_torch.cases import simple_beam  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"Unknown case {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
