"""Every gradient of the training loss of the P model and of the other two
cases against the JAX package, on the CPU: damped_oscillator/"vae" (P),
bridge/"DPIVAE-A" (P) and bridge/"DPIVAE-B" (S, with bridge's physical
covariate joining z_x), for both ``use_pallas`` values. Data, weights,
replayed noise and tolerances as in tests/test_torch_port_pmodel_train.py
(gradients rtol 5e-4 / atol 1e-6, as simple_beam's are held).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu_torch.convert import state_dict_from_jax
from test_torch_port_pmodel_train import (
    B,
    CONFIGS,
    GRAD_ATOL,
    GRAD_RTOL,
    N,
    WEIGHTS,
    _close,
    _config_ids,
    _data,
    _models,
    _replayed_eps,
    _t,
)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case_name, preset", CONFIGS, ids=_config_ids)
def test_gradients_match_jax(case_name, preset, use_pallas):
    """Every parameter's gradient of the normalised loss, the three P
    encoders' included, through the GRL and (with use_pallas)
    FusedMLPFunction's backward."""
    _, (jcfg, jmodel, jparams), (cfg, case, model, params) = _models(
        case_name, preset, use_pallas=use_pallas)
    x, c, y = _data(case_name, B, 2)
    key = jax.random.PRNGKey(6)
    denom = B * (case.nd_x + case.nd_y + case.nd_c)

    def jax_scalar(p):
        out = jmodel.loss(p, key, jnp.asarray(x), jnp.asarray(c),
                          jnp.asarray(y), n=N, grl_alpha=jcfg.lambda_g0,
                          **WEIGHTS)
        return jnp.sum(out[0]) / denom

    want = state_dict_from_jax(
        jax.tree.map(np.asarray, jax.grad(jax_scalar)(jparams)))
    out = model.loss(params, _t(x), _t(c), _t(y), n=N,
                     grl_alpha=cfg.lambda_g0,
                     noise={"z": _replayed_eps(key, model, N, B)}, **WEIGHTS)
    (torch.sum(out[0]) / denom).backward()
    got = dict(params.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].grad is not None, name
        _close(got[name].grad, w, GRAD_RTOL, GRAD_ATOL, name)
