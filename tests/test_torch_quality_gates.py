"""The study-scale structure gates of tests/test_quality_gates.py, run on
the port (marked ``slow``: the tier-1 command skips them).

1. The λ-sweep's disentanglement structure on damped_oscillator: the
   damage factor ζ reads out of z_y at moderate λ and collapses out of
   z_y at extreme λ (the gradient reversal at work).
2. The transfer ranking on bridge: DPIVAE-B beats the MLP baseline, fitted
   by scikit-learn's ``MLPRegressor(64, 64)`` rules
   (``eval.fit_mlp_sklearn``, through ``run_comparison``), on a held-out
   quadrant.

The scale, the λ values and the margin are the JAX gates' (N_ITER 2,000,
2 seeds, 1,024 probe points, NEAR_TIE 0.12). Each test prints its
readings. They run on the card when there is one, else on the CPU:

    python -m pytest -m slow tests/test_torch_quality_gates.py -s -q
    python -m pytest -m slow tests/test_torch_quality_gates.py -s -q \\
        --noconftest     # on a host without jax
"""

import numpy as np
import pytest
import torch

from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig

pytestmark = pytest.mark.slow

NEAR_TIE = 0.12
LAMBDA_MODERATE = 100.0 / 1e4
LAMBDA_EXTREME = 10000.0 / 1e4
N_SEEDS = 2
N_ITER = 2000
N_REGRESSOR = 1024


@pytest.fixture
def device():
    return "cuda" if torch.cuda.is_available() else "cpu"


def test_lambda_sweep_disentanglement_structure(device):
    """ζ reads out of z_y at moderate λ; extreme λ collapses that readout
    (the JAX gate's calibration: z_y 0.93 against z_x 0.39 and z_c 0.02 at
    moderate λ, z_y 0.06 at extreme λ)."""
    from dpivae_tpu_torch.eval import batched_probe_scores
    from dpivae_tpu_torch.sweep import (
        sweep_disentanglement_latents,
        train_sweep,
    )

    case = get_case("damped_oscillator")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, n_iter=N_ITER)
    result = train_sweep(cfg, case, [LAMBDA_MODERATE, LAMBDA_EXTREME],
                         n_runs=N_SEEDS, seed=0, device=device)
    latents = sweep_disentanglement_latents(cfg, case, result, N_REGRESSOR,
                                            N_REGRESSOR, seed=1)
    scores = batched_probe_scores(
        {b: latents[f"{b}_train"] for b in ("zx", "zc", "zy")},
        {b: latents[f"{b}_test"] for b in ("zx", "zc", "zy")},
        latents["z_train"], latents["z_test"], n_factors=len(case.factors),
        regressor="linear", device=device)
    assert np.all(np.isfinite(scores)), "diverged sweep members"

    i_zeta = [f.name for f in case.factors].index("zeta")
    # members are λ-major: member = i_lambda * n_runs + j_run
    zx_mod, zc_mod, zy_mod = scores[:N_SEEDS, i_zeta].mean(axis=0)
    zy_ext = scores[N_SEEDS:, i_zeta, 2].mean()
    print(f"\nλ-sweep gate on {device}: ζ at moderate λ zx {zx_mod:.3f}, "
          f"zc {zc_mod:.3f}, zy {zy_mod:.3f}; zy at extreme λ {zy_ext:.3f}")
    assert zy_mod > 0.5, f"ζ→z_y readout lost at moderate λ: R²={zy_mod:.3f}"
    assert zy_mod > zx_mod + NEAR_TIE and zy_mod > zc_mod + NEAR_TIE, (
        f"z_y no longer wins ζ at moderate λ: zy={zy_mod:.3f} "
        f"zx={zx_mod:.3f} zc={zc_mod:.3f}")
    assert zy_ext < zy_mod - NEAR_TIE, (
        f"no z_y collapse at extreme λ: moderate R²={zy_mod:.3f}, extreme "
        f"R²={zy_ext:.3f}")


def test_transfer_ranking_dpivae_b_beats_mlp(device):
    """One extrapolation fold of the bridge transfer study, domain 2 (the
    JAX gate's calibration: B 0.70 against the MLP's 0.37)."""
    from dpivae_tpu_torch.eval import evaluate_model, run_comparison
    from dpivae_tpu_torch.train import setup_model, train_model
    from dpivae_tpu_torch.train.train import member_generators
    from dpivae_tpu_torch.utils.data import sample_response
    from dpivae_tpu_torch.utils.priors import make_square_dist

    case = get_case("bridge")
    cfg = TrainConfig().with_preset(case.presets["DPIVAE-B"]).replace(
        use_seed=True, n_iter=N_ITER)
    # extrapolation: train on one quadrant, test on the other three
    dists_test, dists_train = make_square_dist(case)
    i_dom = 1
    g = member_generators(123, [i_dom], device)[0]
    dtr, dva, dte = (sample_response(case, g, n, sample_dist=dist,
                                     device=device)
                     for n, dist in ((cfg.n_train, dists_train[i_dom]),
                                     (cfg.n_val, dists_train[i_dom]),
                                     (cfg.n_test, dists_test[i_dom])))
    model = setup_model(cfg, case, dtr, device=device)
    params, _ = train_model(cfg, model, case, dtr, dva, generator=g,
                            device=device)
    metrics, _ = evaluate_model(cfg, case, model, params, dte)
    r2_b = float(np.mean(metrics[cfg.name]["R2"]))
    baseline, _ = run_comparison(
        cfg, case, dtr, dte, models=("MLP",), device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    r2_mlp = float(np.mean(baseline["MLP"]["R2"]))
    print(f"\ntransfer gate on {device}: DPIVAE-B R² {r2_b:.3f}, MLP "
          f"baseline R² {r2_mlp:.3f}")
    assert r2_b > r2_mlp + NEAR_TIE, (
        f"DPIVAE-B no longer beats the MLP baseline on the transfer fold: "
        f"B R²={r2_b:.3f} vs MLP R²={r2_mlp:.3f}")
