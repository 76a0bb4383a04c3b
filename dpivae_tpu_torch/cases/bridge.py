"""Bridge case: FE-benchmark strain response of a population of bridges
(counterpart of dpivae_tpu/cases/bridge.py:22-124).

Seven factors: two vertical-support stiffnesses kv1/kv2 (physics latents),
two damage indices y1/y2 (labels), vehicle-speed factor v and sensor
offset delta_xs (covariates; delta_xs is the only *physical* covariate, so
``idx_c_phys == (1,)`` and its raw column joins z_x at the physics
decoder's input), and a load factor f (nuisance). Signal: strain over
nd_x = 64 points. Both the full and the partial physics are frozen tanh
MLPs with their own input scalers, read from the JAX package's bundled
archive by path: full 7 -> 64 -> 32 -> 64 -> 64, partial (z_x || c_phys)
3 -> 64 -> 32 -> 64 -> 64.
"""

from __future__ import annotations

import functools
import os

from dpivae_tpu_torch.cases import Case, Factor, PriorSpec, Surrogate, register_case
from dpivae_tpu_torch.utils.io import load_mlp_npz

_ARTIFACT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
    "dpivae_tpu", "cases", "artifacts", "bridge.npz",
)

ND_X = 64

FACTORS = (
    Factor("kv1", 9.5, 11.5, "uniform", {"low": 9.5, "high": 11.5}, "x",
           r"$\log_{10} k_{v,1}$", 11.5),
    Factor("kv2", 9.5, 11.5, "uniform", {"low": 9.5, "high": 11.5}, "x",
           r"$\log_{10} k_{v,2}$", 11.5),
    Factor("y1", 0.0, 1.0, "uniform", {"low": 0.0, "high": 1.0}, "y",
           r"$y_1$ [-]", 0.1),
    Factor("y2", 0.0, 1.0, "uniform", {"low": 0.0, "high": 1.0}, "y",
           r"$y_2$ [-]", 0.1),
    Factor("v", 0.9, 1.1, "uniform", {"low": 0.9, "high": 1.1}, "c",
           r"$\delta_{\mathrm{v}}$ [-]", 1.0),
    Factor("delta_xs", -1.0, 1.0, "uniform", {"low": -1.0, "high": 1.0}, "c",
           r"$\delta_\mathrm{s}$ [m]", 0.0, phys=True),
    Factor("f", 0.95, 1.05, "uniform", {"low": 0.95, "high": 1.05}, "f",
           r"$\delta_{\mathrm{F}}$ [-]", 1.0),
)

PRIOR_X = (
    PriorSpec("kv1", 9.001, 11.999, "uniform", {"low": 9.001, "high": 11.999}),
    PriorSpec("kv2", 9.001, 11.999, "uniform", {"low": 9.001, "high": 11.999}),
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
        "lambda_g0": 1 / 1024,
        "lambda_x": None,
        "nz_c": 4,
        "nz_y": 4,
    },
    "DPIVAE-A": {
        "name": "DPIVAE-A",
        "model_type": "P",
        "lambda_g0": -1.0,
        "lambda_x": None,
        "nz_c": 4,
        "nz_y": 4,
    },
    "DPIVAE-B": {
        "name": "DPIVAE-B",
        "model_type": "S",
        "lambda_g0": 1 / 1024,
        "lambda_x": None,
        "nz_c": 4,
        "nz_y": 4,
    },
}


@register_case("bridge")
@functools.lru_cache(maxsize=None)
def build() -> Case:
    params, extras = load_mlp_npz(os.path.normpath(_ARTIFACT))
    full_model = Surrogate(
        params=params,
        scaler_mean=extras["scaler_mean"],
        scaler_scale=extras["scaler_scale"],
    )
    # The partial physics is itself a frozen MLP over (z_x || c_phys)
    part_layers = []
    i = 0
    while f"part_w{i}" in extras:
        part_layers.append({"w": extras[f"part_w{i}"], "b": extras[f"part_b{i}"]})
        i += 1
    part_model = Surrogate(
        params={"layers": tuple(part_layers)},
        scaler_mean=extras["part_scaler_mean"],
        scaler_scale=extras["part_scaler_scale"],
    )
    return Case(
        name="bridge",
        factors=FACTORS,
        prior_x=PRIOR_X,
        nd_x=ND_X,
        t_min=1.0,
        t_max=21.0,
        sigma_x=0.0001,
        sigma_c=0.0001,
        sigma_y=0.0001,
        full_model=full_model,
        part_model=part_model,
        presets=PRESETS,
        x_unit="Time [s]",
        y_unit=r"[$^o/_{oo}$]",
        ylim=(-1.0, 2.0),
        x_full=extras["X"],
        y_full=extras["y_full"],
        x_part=extras["X_part"],
        y_part=extras["y_part"],
    )
