"""A case study defined from scratch (counterpart of examples/custom_case.py).

The three bundled cases read pretrained surrogates, but a ``Case`` needs
only callables: this program builds a toy *cantilever* case with an
analytic data generator and physics model, registers it (when it runs,
not when this module is imported, so importing it leaves the registry
as it was), trains the S-model briefly and evaluates it (the damage
label's test R² and the disentanglement scores).

    python -m dpivae_tpu_torch.examples.custom_case [--n_iter 2000] \\
        [--device cpu]

``--device`` defaults to CUDA and raises without a card. On the card the
preset's ``use_pallas="auto"`` picks the fused-MLP kernels: the training
decode is 16 MC x 64 points = 1,024 rows of 4 -> 128 -> 32.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple, Optional, Sequence

import torch

from dpivae_tpu_torch.cases import Case, Factor, PriorSpec, register_case

ND_X = 32


def _grid(z, stop, npts):
    return torch.linspace(0.0, stop, npts, device=z.device, dtype=z.dtype)


def cantilever_tip_load(z, L=1.0, I=2e-6, npts=ND_X):
    """Deflection of a cantilever under a tip load: the known physics.
    z[..., 0] = Young's modulus E [MPa]. On ``z``'s device and dtype."""
    x = _grid(z, L, npts)
    E = z[..., 0:1] * 1e6
    w = x**2 * (3 * L - x) / (6 * E * I)
    return -1000.0 * w


def full_response(z):
    """The "true" generative process: cantilever physics plus a
    temperature-dependent stiffness effect and a damage-dependent local
    softening, the parts the data-driven branch must learn."""
    d, T = z[..., 1:2], z[..., 2:3]
    x = _grid(z, 1.0, ND_X)
    base = cantilever_tip_load(z)
    thermal = 1.0 + 0.01 * (T - 20.0)
    damage = 1.0 + d * torch.exp(-((x - 0.3) ** 2) / 0.02)
    return base * thermal * damage


FACTORS = (
    Factor("E", 2.0, 6.0, "uniform", {"low": 2.5, "high": 4.5}, "x",
           r"$E$ [MPa]", 3.5),
    Factor("d", 0.0, 1.0, "uniform", {"low": 0.0, "high": 0.8}, "y",
           r"$d$ [-]", 0.2),
    Factor("T", 0.0, 40.0, "uniform", {"low": 5.0, "high": 35.0}, "c",
           r"$T$ [C]", 20.0),
)

PRIOR_X = (PriorSpec("E", 2.0, 6.0, "normal", {"loc": 3.5, "scale": 1.0}),)

PRESETS = {
    "dpivae": {"model_type": "S", "lambda_g0": 1 / 256, "lambda_x": None,
               "nz_c": 2, "nz_y": 2},
}


def build() -> Case:
    return Case(
        name="cantilever",
        factors=FACTORS,
        prior_x=PRIOR_X,
        nd_x=ND_X,
        t_min=0.0,
        t_max=1.0,
        sigma_x=0.02,
        sigma_c=0.05,
        sigma_y=0.01,
        full_model=full_response,
        part_model=cantilever_tip_load,
        presets=PRESETS,
        x_unit="Distance [m]",
        y_unit="[mm]",
        ylim=(-6.0, 1.0),
    )


class CustomCase(NamedTuple):
    """What the program computed: the trained params and logs, the test
    metrics (``evaluate_model``'s) and the disentanglement rows."""

    params: object
    logs: object
    metrics: dict
    rows: list


def main(argv: Optional[Sequence[str]] = None) -> CustomCase:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n_iter", type=int, default=2000)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.eval import disentanglement_metric, evaluate_model
    from dpivae_tpu_torch.train import setup_model, train_model
    from dpivae_tpu_torch.utils import resolve_device
    from dpivae_tpu_torch.utils.data import sample_response

    device = resolve_device(args.device)
    register_case("cantilever")(build)
    case = get_case("cantilever")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, n_iter=args.n_iter, name="cantilever", n_mc_test=64)
    gen = torch.Generator(device=device).manual_seed(0)
    dist = case.gt_dist()
    dtr, dva, dte = (sample_response(case, gen, n, sample_dist=dist,
                                     device=device)
                     for n in (cfg.n_train, cfg.n_val, cfg.n_test))

    model = setup_model(cfg, case, dtr, device=device)
    print(f"Training the custom cantilever case for {cfg.n_iter} iters ...")
    params, logs = train_model(
        cfg, model, case, dtr, dva, device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    _, e = logs.scalars("ELBO")
    print(f"ELBO {e[0]:.3f} -> {e[-1]:.3f} (stopped at {logs.stop_iter})")

    metrics, _ = evaluate_model(cfg, case, model, params, dte)
    print(f"damage-label test R2: {metrics['cantilever']['R2']}")
    rows = disentanglement_metric(cfg, model, params, case, dtr, dte)
    for block, factor, score in rows:
        print(f"  {block} -> {factor}: R2 = {score:.3f}")
    return CustomCase(params, logs, metrics, rows)


if __name__ == "__main__":
    main()
