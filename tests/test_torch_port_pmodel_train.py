"""The training loss of the P model and of the other two cases against the
JAX package, on the CPU: the loss 8-tuple for damped_oscillator/"vae"
(P), bridge/"DPIVAE-A" (P) and bridge/"DPIVAE-B" (S, with bridge's
physical covariate joining z_x), for both ``use_pallas`` values, and three
optimizer steps of bridge/"DPIVAE-A". Every gradient of the same models
is in tests/test_torch_port_pmodel_grad.py, which takes its helpers from
here (the two files run on two test workers).

Small size: batch 16, 4 MC samples, n_train 64, at the presets' full
widths. Data, weights and noise as in tests/test_torch_port_pmodel.py:
numpy data, JAX-initialized weights through ``params_from_jax``, and the
encoder normals JAX's ``loss`` draws (vae.py:292, then for P the three
encoders' keys of vae.py:229), replayed. The JAX side of a train step is
``jax.grad`` of the loss and the JAX optimizer's ``update``.

Tolerances as the S model on simple_beam is held
(tests/test_torch_port_train.py): the loss 8-tuple rtol/atol 1e-4;
gradients rtol 5e-4 / atol 1e-6; parameters after three Adam steps
rtol/atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.train.optim import make_optimizer as jax_make_optimizer
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu.utils.priors import factor_indices
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax, state_dict_from_jax
from dpivae_tpu_torch.train import TRAIN_COLUMNS, setup_model
from dpivae_tpu_torch.train.train import Trainer

N_TRAIN, B, N = 64, 16, 4
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
PARAM_TOL = 1e-5
# Loss weights away from 1, so that each reaches the result.
WEIGHTS = dict(beta_x=0.7, beta_c=1.0, beta_y=1.0, alpha_x=1.1, alpha_c=0.9,
               alpha_y=1.3)
CONFIGS = [("damped_oscillator", "vae"), ("bridge", "DPIVAE-A"),
           ("bridge", "DPIVAE-B")]
_config_ids = [f"{c}-{p}" for c, p in CONFIGS]


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _data(case_name, n, seed):
    """(x, c, y) from numpy: factors uniform in their ground-truth ranges,
    x through the JAX package's frozen surrogate, the case's noise."""
    case = jax_get_case(case_name)
    rng = np.random.default_rng(seed)
    z = np.stack([rng.uniform(f.args["low"], f.args["high"], n)
                  for f in case.factors], -1).astype(np.float32)
    noise = lambda s, d: s * rng.standard_normal((n, d)).astype(np.float32)
    x = np.asarray(case.full_model(jnp.asarray(z))) + noise(case.sigma_x,
                                                            case.nd_x)
    c = z[:, factor_indices(case.factors, "c")] + noise(case.sigma_c, case.nd_c)
    y = z[:, factor_indices(case.factors, "y")] + noise(case.sigma_y, case.nd_y)
    return x.astype(np.float32), c, y


def _models(case_name, preset, **over):
    over = dict(n_train=N_TRAIN, n_batch=B, n_mc_train=N, n_mc_val=N,
                use_seed=True, **over)
    data = _data(case_name, N_TRAIN, 0)
    jcase = jax_get_case(case_name)
    jcfg = JaxTrainConfig().with_preset(jcase.presets[preset]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))

    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(**over)
    model = setup_model(cfg, case, data, device="cpu")
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return data, (jcfg, jmodel, jparams), (cfg, case, model, params)


def _replayed_eps(key, model, n, batch):
    """The encoder normals JAX's DPIVAE.loss draws from ``key``: one joint
    draw for S; for P one per encoder, joined x, c, y."""
    k_enc, _ = jax.random.split(key)
    draw = lambda k, d: np.array(jax.random.normal(k, (n, batch, d)))
    if model.model_type == "S":
        return _t(draw(k_enc, model.nz_x + model.nz_c + model.nz_y))
    k_x, k_c, k_y = jax.random.split(k_enc, 3)
    return _t(np.concatenate([draw(k_x, model.nz_x), draw(k_c, model.nz_c),
                              draw(k_y, model.nz_y)], -1))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case_name, preset", CONFIGS, ids=_config_ids)
def test_loss_matches_jax(case_name, preset, use_pallas):
    _, (jcfg, jmodel, jparams), (cfg, _, model, params) = _models(
        case_name, preset, use_pallas=use_pallas)
    x, c, y = _data(case_name, B, 1)
    key = jax.random.PRNGKey(5)
    want = jmodel.loss(jparams, key, jnp.asarray(x), jnp.asarray(c),
                       jnp.asarray(y), n=N, grl_alpha=jcfg.lambda_g0,
                       **WEIGHTS)
    with torch.no_grad():
        got = model.loss(params, _t(x), _t(c), _t(y), n=N,
                         grl_alpha=cfg.lambda_g0,
                         noise={"z": _replayed_eps(key, model, N, B)},
                         **WEIGHTS)
    assert len(got) == len(want) == 8
    for name, g, w in zip(("loss", "KLx", "KLc", "KLy", "Rx", "Rc", "Ry",
                           "reg"), got, want):
        assert g.shape == w.shape == (B,)
        _close(g, w, LOSS_TOL, LOSS_TOL, name)


def test_p_model_train_steps_match_jax():
    """Three train steps of bridge/"DPIVAE-A" through the seam (given batch
    rows and encoder noise) against JAX's optimizer update on jax.grad of
    the same normalised loss, with per-encoder learning rates and weight
    decay so that each P group's hyperparameters reach the result."""
    data, (jcfg, jmodel, jparams), (cfg, case, model, params) = _models(
        "bridge", "DPIVAE-A", use_pallas=True, lr_ex=2e-3, lr_ec=3e-3,
        lr_ey=5e-4, wd_e=0.01)
    run = Trainer(cfg, case, params, data, _data("bridge", N_TRAIN, 9),
                  cfg.lambda_g0)
    tx = jax_make_optimizer(jcfg, jparams)
    opt_state = tx.init(jparams)
    denom = B * (case.nd_x + case.nd_y + case.nd_c)
    rng = np.random.default_rng(4)
    for step in range(3):
        idx = rng.choice(N_TRAIN, B, replace=False)
        key = jax.random.PRNGKey(100 + step)
        x, c, y = (jnp.asarray(a[idx]) for a in data)

        def scalar(p):
            out = jmodel.loss(p, key, x, c, y, n=N, grl_alpha=jcfg.lambda_g0)
            return jnp.sum(out[0]) / denom

        value, grads = jax.value_and_grad(scalar)(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        row = run.step(step, batch_idx=torch.from_numpy(idx),
                       noise={"z": _replayed_eps(key, model, N, B)})
        assert row.shape == (len(TRAIN_COLUMNS),)
        _close(row[0], value, LOSS_TOL, LOSS_TOL)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in params.state_dict().items():
        _close(p, want[name], PARAM_TOL, PARAM_TOL, name)
