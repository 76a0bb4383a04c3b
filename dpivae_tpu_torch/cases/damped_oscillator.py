"""Damped oscillator case: mass-spring-dashpot displacement time series
(counterpart of dpivae_tpu/cases/damped_oscillator.py:25-97).

Factors: mass m (physics latent), dashpot zeta (damage label), temperature
T (covariate), initial displacement x_0 (nuisance "f" factor that feeds
the surrogate but is not a modality). Signal: displacement over nd_x = 64
points. Physics: the undamped analytic oscillator on the mass only;
surrogate: frozen MLP(4 -> [256, 256] -> 64, tanh) read from the JAX
package's bundled archive by path.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Dict

import numpy as np
import torch

from dpivae_tpu_torch.cases import (
    Case,
    Factor,
    PriorSpec,
    Surrogate,
    device_constants,
    register_case,
)
from dpivae_tpu_torch.physics import mass_spring
from dpivae_tpu_torch.physics.oscillator import grid_dtype
from dpivae_tpu_torch.utils.io import load_mlp_npz

_ARTIFACT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "dpivae_tpu", "cases", "artifacts", "damped_oscillator.npz",
)

ND_X = 64
# Domain: the 200-step simulator grid, subsampled to nd_x points
_NT, _DT = 200, 0.05
T_MIN, T_MAX = 0.0, _DT * (_NT - 1)

FACTORS = (
    Factor("m", 1.2, 1.8, "uniform", {"low": 1.2, "high": 1.8}, "x",
           r"$m$ [kg]", 1.5),
    Factor("zeta", 0.0, 2.0, "uniform", {"low": 0.0, "high": 2.0}, "y",
           r"$c_\mathrm{d}$ [kg/s]", 0.0),
    Factor("T", 0.01, 39.99, "uniform", {"low": 0.01, "high": 39.99}, "c",
           r"$T [\mathrm{C}^o]$", 20.0),
    Factor("x_0", 0.9, 1.1, "uniform", {"low": 0.9, "high": 1.1}, "f",
           r"$x_0$ [m]", 1.0),
)

PRIOR_X = (
    PriorSpec("m", 1.0, 2.0, "uniform", {"low": 1.0, "high": 2.0}),
)

PRESETS = {
    "vae": {
        "model_type": "P",
        "lambda_g0": -1.0,
        "lambda_x": None,
        "nz_c": 4,
        "nz_y": 4,
    },
    "dpivae": {
        "model_type": "S",
        "lambda_g0": 1 / 128,
        "lambda_x": None,
        "nz_c": 4,
        "nz_y": 4,
    },
}


@dataclasses.dataclass(frozen=True)
class UndampedPhysics:
    """The partial physics: ``mass_spring(z, t)`` on the case's time grid,
    copied once to each device it runs on."""

    t: np.ndarray
    _copies: Dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        (t,) = device_constants(self._copies, (self.t,), z,
                                dtype=grid_dtype(z))
        return mass_spring(z, t)


@register_case("damped_oscillator")
@functools.lru_cache(maxsize=None)
def build() -> Case:
    params, extras = load_mlp_npz(os.path.normpath(_ARTIFACT))
    full_model = Surrogate(
        params=params,
        scaler_mean=extras["scaler_mean"],
        scaler_scale=extras["scaler_scale"],
    )
    return Case(
        name="damped_oscillator",
        factors=FACTORS,
        prior_x=PRIOR_X,
        nd_x=ND_X,
        t_min=T_MIN,
        t_max=T_MAX,
        sigma_x=0.01,
        sigma_c=0.01,
        sigma_y=0.01,
        full_model=full_model,
        part_model=UndampedPhysics(
            np.linspace(T_MIN, T_MAX, ND_X).astype(np.float32)),
        presets=PRESETS,
        x_unit="Time [s]",
        y_unit="[m]",
        ylim=(-2.0, 2.0),
        x_full=extras["X"],
        y_full=extras["y_full"],
    )
