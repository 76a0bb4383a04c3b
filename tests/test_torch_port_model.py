"""The port's serving slice against the JAX package, on the CPU: encoders,
the weight converter, and simple_beam/dpivae's ``DPIVAE.sample`` and
predictor at full dpivae widths, small size (batch 16, n = 8), for both
``use_pallas`` values.

Both packages get the same numpy data and the same weights (JAX-initialized,
carried over by ``params_from_jax``). Noise is injected: the tests replay
the JAX package's own key splits (vae.py:470 -> vae.py:292 -> mvn.py:65,
then k_x/k_c/k_y) and hand the port those exact normals.

Tolerance for whole-model outputs: rtol 1e-4 / atol 1e-4. Both sides are
f32 but XLA:CPU and torch sum in different orders, and the errors of the
encoder, the squash and the decoders compound; x is in mm up to about 25,
where 1e-4 is a few ulps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.models import encoders as jax_enc
from dpivae_tpu.serving import build_predict_fn as jax_build_predict_fn
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu.utils.priors import factor_indices
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax, state_dict_from_jax
from dpivae_tpu_torch.models.encoders import FactorizedNN, FullCovNN
from dpivae_tpu_torch.ops.fused_mlp import fused_mlp
from dpivae_tpu_torch.serving import SAMPLE_SLOTS, Predictor, build_predict_fn
from dpivae_tpu_torch.train import init_params, setup_model

N_TRAIN, B, N = 64, 16, 8
RTOL = ATOL = 1e-4


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def _data(n, seed):
    """(x, c, y) for simple_beam from numpy: factors uniform in their
    ground-truth ranges, x through the JAX package's frozen surrogate."""
    case = jax_get_case("simple_beam")
    rng = np.random.default_rng(seed)
    z = np.stack([rng.uniform(f.args["low"], f.args["high"], n)
                  for f in case.factors], -1).astype(np.float32)
    noise = lambda d: 0.02 * rng.standard_normal((n, d)).astype(np.float32)
    x = np.asarray(case.full_model(jnp.asarray(z))) + noise(case.nd_x)
    c = z[:, factor_indices(case.factors, "c")] + noise(case.nd_c)
    y = z[:, factor_indices(case.factors, "y")] + noise(case.nd_y)
    return x.astype(np.float32), c, y


def _models(use_pallas):
    """JAX and port models of simple_beam/dpivae, fitted on the same data,
    with the same (JAX-initialized) weights."""
    data = _data(N_TRAIN, 0)
    over = dict(n_train=N_TRAIN, n_batch=B, use_pallas=use_pallas,
                use_seed=True)
    jcase = jax_get_case("simple_beam")
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))

    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(**over)
    model = setup_model(cfg, case, data, device="cpu")
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return (jcfg, jmodel, jparams), (cfg, model, params)


def _replayed_noise(key, model, n, batch, cond):
    """The standard normals JAX's DPIVAE.sample draws from ``key``."""
    k_fwd, k_x, k_c, k_y = jax.random.split(key, 4)
    k_enc, k_prior = jax.random.split(k_fwd)
    nz = model.nz_x + model.nz_c + model.nz_y
    draw = lambda k, d: torch.from_numpy(
        np.array(jax.random.normal(k, (n, batch, d))))
    noise = {"z": draw(k_enc, nz), "x": draw(k_x, model.nd_x),
             "c": draw(k_c, model.nd_c), "y": draw(k_y, model.nd_y)}
    if cond:
        noise["z_prior"] = draw(k_prior, model.nz_c)
    return noise


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_sample_matches_jax(use_pallas, cond):
    (jcfg, jmodel, jparams), (cfg, model, params) = _models(use_pallas)
    assert model.use_pallas is use_pallas
    x, c, _ = _data(B, 1)
    key = jax.random.PRNGKey(7)
    want = jmodel.sample(jparams, key, jnp.asarray(x), jnp.asarray(c),
                         cond=cond, n=N, grl_alpha=jcfg.lambda_g0)
    with torch.no_grad():
        got = model.sample(params, torch.from_numpy(x), torch.from_numpy(c),
                           cond=cond, n=N, grl_alpha=cfg.lambda_g0,
                           noise=_replayed_noise(key, jmodel, N, B, cond))
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_predict_fn_matches_jax(use_pallas):
    (jcfg, jmodel, jparams), (cfg, model, params) = _models(use_pallas)
    x, c, _ = _data(B, 2)
    outputs = tuple(SAMPLE_SLOTS)
    jpredict = jax_build_predict_fn(jmodel, jparams, jcfg, n=N,
                                    outputs=outputs)
    key = jax.random.PRNGKey(11)
    want = jpredict(np.asarray(jax.random.key_data(key), np.uint32), x, c)
    predict = build_predict_fn(model, params, cfg, n=N, outputs=outputs)
    got = predict(torch.from_numpy(x), torch.from_numpy(c),
                  noise=_replayed_noise(key, jmodel, N, B, False))
    for g, w in zip(got, want):
        _close(g, w)


def test_predictor_answers_requests_on_cpu():
    _, (cfg, model, params) = _models(True)
    x, c, _ = _data(B, 3)
    predictor = Predictor(model, params, cfg, n=N, outputs=("y", "x_sample"),
                          device="cpu")
    before = fused_mlp.launches
    first = predictor(x, c, seed=5)
    assert first["y"].shape == (B, 1) and first["x_sample"].shape == (B, 32)
    assert all(np.isfinite(v).all() for v in first.values())
    again = predictor(x, c, seed=5)
    np.testing.assert_array_equal(first["y"], again["y"])
    assert not np.array_equal(first["y"], predictor(x, c, seed=6)["y"])
    # On the CPU the wrapper takes the plain version: no kernel launches.
    assert fused_mlp.launches == before


def test_predict_fn_rejects_unknown_outputs():
    _, (cfg, model, params) = _models(False)
    with pytest.raises(ValueError, match="unknown outputs"):
        build_predict_fn(model, params, cfg, outputs=("nope",))


def test_params_from_jax_round_trip():
    (_, jmodel, jparams), (_, model, params) = _models(False)
    tree = jax.tree.map(np.asarray, jparams)
    state = params.state_dict()
    flat = state_dict_from_jax(tree)
    assert set(flat) == set(state)
    assert len(flat) == len(jax.tree.leaves(tree))
    for name, value in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), value.numpy())
    # Dense layers are transposed into nn.Linear's (out, in) layout.
    w = tree["decoder_x"]["fx0"]["w"]
    np.testing.assert_array_equal(
        params.decoder_x.fx0.weight.detach().numpy(), w.T)
    # A tree that lacks an entry does not load.
    del tree["decoder_y"]
    with pytest.raises(RuntimeError, match="Missing key"):
        params_from_jax(model, tree, device="cpu")


@pytest.mark.parametrize("head", ["full_cov", "factorized"])
def test_encoder_heads_match_jax(head):
    n_latent, n_input = 6, 32
    key = jax.random.PRNGKey(3)
    if head == "full_cov":
        jp = jax_enc.full_cov_nn_init(key, n_latent, n_input, [128])
        jfn, cls = jax_enc.full_cov_nn_apply, FullCovNN
    else:
        jp = jax_enc.factorized_nn_init(key, n_latent, n_input, [64])
        jfn, cls = jax_enc.factorized_nn_apply, FactorizedNN
    layers = [128] if head == "full_cov" else [64]
    module = cls(n_latent, n_input, layers, torch.Generator().manual_seed(0),
                 torch.device("cpu"))
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jp)))
    # Wide inputs drive the heads into their clamps.
    x = (np.random.default_rng(0).standard_normal((5, 7, n_input)) * 30
         ).astype(np.float32)
    loc_j, tril_j = jfn(jp, jnp.asarray(x), n_latent)
    with torch.no_grad():
        loc, tril = module(torch.from_numpy(x))
    _close(loc, loc_j)
    _close(tril, tril_j)


def test_init_params_is_seeded_and_torch_default_scaled():
    _, (cfg, model, _) = _models(False)
    a = init_params(cfg, model, device="cpu")
    b = init_params(cfg, model, device="cpu")
    for (name, ta), tb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(ta, tb), name
    w = a.decoder_x.fx0.weight.detach()
    bound = 1.0 / np.sqrt(w.shape[1])
    assert float(w.abs().max()) <= bound
    assert model.decoder_x_hidden == a.decoder_x.fx0.weight.shape[0] == 128


@pytest.mark.parametrize("change", [
    dict(compute_dtype="bfloat16"),
    dict(remat_decode=True),
])
def test_unported_variants_raise(change):
    """bf16 and remat_decode were the last variants to raise; both are
    ported now (tests/test_torch_port_remat.py holds them against JAX), so
    they build, and only what no version supports still raises: another
    compute dtype in the model, and the kernel with bf16 in the config."""
    _, (cfg, model, _) = _models(False)
    (field, value), = change.items()
    assert getattr(dataclasses.replace(model, **change), field) == value
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(model, compute_dtype="float16")
    with pytest.raises(ValueError, match="use_pallas=True"):
        cfg.replace(use_pallas=True, compute_dtype="bfloat16")


@pytest.mark.parametrize("use_pallas, resolved", [
    (True, True), (False, False), ("auto", False)])
def test_use_pallas_resolution(use_pallas, resolved):
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=N_TRAIN, n_batch=B, use_pallas=use_pallas)
    model = setup_model(cfg, case, _data(N_TRAIN, 0), device="cpu")
    assert model.use_pallas is resolved
    assert model.mc_chunk is None
