"""The port's ELBO curves against the JAX package's at bench.py:main()'s
workload, on the CPU (marked ``slow``: the tier-1 command skips it).

The method of benchmarks/curve_parity.py, with the port in the place of
the torch replica: one simple_beam dataset drawn by the JAX package's
``sample_response`` (1,024 training and 512 validation points, passed as
numpy to both), the same initial weights (JAX-initialized, carried over
by ``convert.params_from_jax``), both trained at the preset's workload
(batch 64, 16 MC samples, a validation of 512 points x 64 MC every 10
iterations) with the early stop off, full f32 on both sides. The random
streams are each package's own and cannot match, so the comparison is
statistical:

- the final train ELBO, the mean of the last 200 logged rows, within
  ``FINAL_TOL`` = 0.1 of JAX's;
- the largest gap between the two validation curves, each smoothed over
  10 validations, at most ``CURVE_TOL`` = 0.4.

BASELINE.md records 0.066 and 0.34 between the JAX package and a torch
replica of the reference loop at 2,000 iterations (0.026 final gap at
10,000). The run length is the test's parameter (on an 8-core CPU host,
2,000 iterations about 3.5 minutes, 10,000 about 12; both print their
readings):

    JAX_PLATFORMS=cpu python -m pytest -m slow \\
        tests/test_torch_curve_parity.py -s -q -k 2000

``test_early_stopped_run_matches_jax`` runs the quality-anchor row that
the port missed on the card (bridge / "dpivae": its mean ELBO_val
-5.505 against BASELINE.md's -5.332 ± 0.15) in both packages on one
dataset at the preset's own length and early stop, and holds the
port's ELBO_val at the stop within 0.15 of JAX's (about 15 minutes).
"""

import jax
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.train import setup_model as jax_setup_model
from dpivae_tpu.train.train import get_train_fn
from dpivae_tpu.utils.data import sample_response
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax
from dpivae_tpu_torch.train import setup_model, train_model

pytestmark = pytest.mark.slow

FINAL_TOL = 0.1
CURVE_TOL = 0.4
ELBO_TOL = 0.15
TAIL_ROWS = 200
SMOOTH_VALIDATIONS = 10


def _smooth(v, w=SMOOTH_VALIDATIONS):
    return np.convolve(v, np.ones(w) / w, mode="valid")


def _data(case_name="simple_beam"):
    """benchmarks/curve_parity.py's dataset: keys split from PRNGKey(0)."""
    case = jax_get_case(case_name)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    draw = lambda k, n: tuple(
        np.asarray(a, np.float32)
        for a in sample_response(case, k, n, sample_dist=case.gt_dist())[:3])
    return draw(k1, 1024), draw(k2, 512)


def _configs(case_name, preset, **over):
    jcase = jax_get_case(case_name)
    jcfg = JaxTrainConfig().with_preset(jcase.presets[preset]).replace(
        use_seed=True, **over)
    cfg = TrainConfig().with_preset(get_case(case_name).presets[preset]
                                    ).replace(use_seed=True, **over)
    return jcfg, cfg


def _active(train, val, train_active, val_active):
    """(train ELBO column, ELBO_val column, stop iteration), active rows."""
    train_active, val_active = (np.asarray(a, bool)
                                for a in (train_active, val_active))
    return (np.asarray(train)[train_active, 0],
            np.asarray(val)[val_active, 0], int(train_active.sum()))


def _train_jax(cfg, case_name, data_train, data_val):
    case = jax_get_case(case_name)
    model = jax_setup_model(cfg, case, data_train)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    with jax.default_matmul_precision("highest"):
        _, logs = get_train_fn(cfg, case)(
            params, jax.random.PRNGKey(1), data_train, data_val,
            np.float32(cfg.lambda_g0))
    return params, _active(logs.train, logs.val, logs.train_active,
                           logs.val_active)


def _train_port(cfg, case_name, jax_params, data_train, data_val):
    case = get_case(case_name)
    model = setup_model(cfg, case, data_train, device="cpu")
    params = params_from_jax(model, jax_params, device="cpu")
    _, logs = train_model(cfg, model, case, data_train, data_val,
                          params=params,
                          generator=torch.Generator().manual_seed(1),
                          device="cpu", progress=False)
    return _active(logs.train, logs.val, logs.train_active, logs.val_active)


@pytest.mark.parametrize("n_iter", [2_000, 10_000])
def test_elbo_curves_match_jax(n_iter):
    jcfg, cfg = _configs("simple_beam", "dpivae", n_iter=n_iter,
                         patience=10**9)
    assert (cfg.n_batch, cfg.n_mc_train, cfg.n_val, cfg.n_mc_val,
            cfg.val_freq) == (64, 16, 512, 64, 10)
    data_train, data_val = _data()
    jax_params, (jax_train, jax_val, _) = _train_jax(
        jcfg, "simple_beam", data_train, data_val)
    train, val, _ = _train_port(cfg, "simple_beam", jax_params, data_train,
                                data_val)
    assert train.shape == jax_train.shape == (n_iter,)
    assert val.shape == jax_val.shape == (n_iter // cfg.val_freq,)
    assert np.isfinite(train).all() and np.isfinite(val).all()

    final_jax = float(np.mean(jax_train[-TAIL_ROWS:]))
    final = float(np.mean(train[-TAIL_ROWS:]))
    gaps = np.abs(_smooth(val) - _smooth(jax_val))
    worst = int(np.argmax(gaps))
    print(f"\ncurve parity, {n_iter} iterations: final train ELBO (mean of "
          f"the last {TAIL_ROWS} rows) port {final:.4f}, JAX "
          f"{final_jax:.4f}, gap {abs(final - final_jax):.4f} (tolerance "
          f"{FINAL_TOL}); validation curves smoothed over "
          f"{SMOOTH_VALIDATIONS}: largest gap {gaps[worst]:.4f} at "
          f"validation {worst} (tolerance {CURVE_TOL}), mean gap "
          f"{gaps.mean():.4f}; final ELBO_val port {val[-1]:.4f}, JAX "
          f"{jax_val[-1]:.4f}; first train row port {train[0]:.4f}, JAX "
          f"{jax_train[0]:.4f}")
    for name, t, v in (("port", train, val), ("JAX", jax_train, jax_val)):
        marks = [n_iter // 10, n_iter // 4, n_iter // 2, n_iter - 1]
        smooth = _smooth(v)
        print(f"  {name}: train ELBO at iterations {marks}: "
              f"{[round(float(t[i]), 4) for i in marks]}; smoothed "
              f"ELBO_val at validations {[i // 10 for i in marks]}: "
              f"{[round(float(smooth[min(i // 10, len(smooth) - 1)]), 4)
                  for i in marks]}")
    assert abs(final - final_jax) <= FINAL_TOL
    assert gaps[worst] <= CURVE_TOL


# BASELINE.md's "Quality anchors" row that the port missed on the card
# (the mean ELBO_val of three seeds -5.505 against the anchor's -5.332 ±
# 0.15): both packages on one dataset, from the same weights, at the
# preset's own length and early stop.
EARLY_STOP_ROWS = [("bridge", "dpivae", -5.332)]


@pytest.mark.parametrize("case_name,preset,anchor", EARLY_STOP_ROWS,
                         ids=[f"{c}-{p}" for c, p, _ in EARLY_STOP_ROWS])
def test_early_stopped_run_matches_jax(case_name, preset, anchor):
    """The preset's run (20,000 iterations, patience 200) in both
    packages: the ELBO_val at the stop (the validation of the returned
    params) of the port within ELBO_TOL of JAX's, the criterion's own
    tolerance. Prints both stops and ELBOs beside the anchor's."""
    jcfg, cfg = _configs(case_name, preset)
    assert cfg.n_iter == 20_000 and cfg.patience == 200
    data_train, data_val = _data(case_name)
    jax_params, (jax_train, jax_val, jax_stop) = _train_jax(
        jcfg, case_name, data_train, data_val)
    train, val, stop = _train_port(cfg, case_name, jax_params, data_train,
                                   data_val)
    assert np.isfinite(train).all() and np.isfinite(val).all()
    # the last smoothed validation both runs reached
    both = min(len(val), len(jax_val)) - SMOOTH_VALIDATIONS
    print(f"\n{case_name} / {preset} at the preset's length and early stop, "
          f"one dataset: stop port {stop}, JAX {jax_stop}; final train / "
          f"val ELBO port {train[-1]:.4f} / {val[-1]:.4f}, JAX "
          f"{jax_train[-1]:.4f} / {jax_val[-1]:.4f}; smoothed ELBO_val at "
          f"the earlier stop port {_smooth(val)[both]:.4f}, JAX "
          f"{_smooth(jax_val)[both]:.4f}; BASELINE.md's anchor val {anchor}")
    assert abs(val[-1] - jax_val[-1]) <= ELBO_TOL
