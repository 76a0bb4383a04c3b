"""Simple beam case: Euler-Bernoulli beam deflection under a point load
(counterpart of dpivae_tpu/cases/simple_beam.py:19-89).

Factors: Young's modulus E and load position x_F (physics latents),
vertical-spring stiffness log_kv (damage label), temperature T
(environmental covariate). Signal: deflection over nd_x = 32 points.
Physics: analytic closed form; surrogate: frozen MLP(4 -> [256, 256] -> 32,
tanh) read from the JAX package's bundled archive by path.
"""

from __future__ import annotations

import functools
import os

from dpivae_tpu_torch.cases import Case, Factor, PriorSpec, Surrogate, register_case
from dpivae_tpu_torch.physics import euler_bernoulli_point_load
from dpivae_tpu_torch.utils.io import load_mlp_npz

_ARTIFACT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "dpivae_tpu", "cases", "artifacts", "simple_beam.npz",
)

ND_X = 32

FACTORS = (
    Factor("E", 2.0, 6.0, "uniform", {"low": 2.5, "high": 4.5}, "x",
           r"$E$ [MPa]", 3.0),
    Factor("x_F", 0.01, 0.99, "uniform", {"low": 0.3, "high": 0.7}, "x",
           r"$x_F$ [m]", 0.5),
    Factor("log_kv", 5.0, 9.0, "uniform", {"low": 6.0, "high": 8.0}, "y",
           r"$\log k_\mathrm{v}$ [N/m]", 8.0),
    Factor("T", -15.0, 15.0, "uniform", {"low": -11.0, "high": 5.0}, "c",
           r"$T \ [\mathrm{C}^o]$", 5.0),
)

PRIOR_X = (
    PriorSpec("E", 2.0, 6.0, "normal", {"loc": 4.0, "scale": 1.0}),
    PriorSpec("x_F", 0.01, 0.99, "normal", {"loc": 0.5, "scale": 0.2}),
)

PRESETS = {
    "vae": {
        "model_type": "P",
        "lambda_g0": -1.0,
        "lambda_x": None,
        "nz_c": 2,
        "nz_y": 2,
    },
    "dpivae": {
        "model_type": "S",
        "lambda_g0": 1 / 256,
        "lambda_x": None,
        "nz_c": 2,
        "nz_y": 2,
    },
}


def _part_model(z):
    return euler_bernoulli_point_load(z, npts=ND_X)


@register_case("simple_beam")
@functools.lru_cache(maxsize=None)
def build() -> Case:
    params, extras = load_mlp_npz(os.path.normpath(_ARTIFACT))
    full_model = Surrogate(
        params=params,
        scaler_mean=extras["scaler_mean"],
        scaler_scale=extras["scaler_scale"],
    )
    return Case(
        name="simple_beam",
        factors=FACTORS,
        prior_x=PRIOR_X,
        nd_x=ND_X,
        t_min=0.00001,
        t_max=1.0,
        sigma_x=0.02,
        sigma_c=0.02,
        sigma_y=0.02,
        full_model=full_model,
        part_model=_part_model,
        presets=PRESETS,
        x_unit="Distance [m]",
        y_unit="[mm]",
        ylim=(-25.0, 2.0),
        x_full=extras["X"],
        y_full=extras["y_full"],
    )
