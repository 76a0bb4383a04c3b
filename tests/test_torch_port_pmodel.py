"""The P model, the CNN encoder and the other two cases against the JAX
package, on the CPU: ``DPIVAE.sample`` and the predictor for
damped_oscillator/"vae" (P), bridge/"DPIVAE-A" (P) and bridge/"DPIVAE-B"
(S, with bridge's physical covariate joining z_x), for both ``use_pallas``
values; the CNN encoder's heads; the P model's optimizer groups; and the
weight converter for P and CNN params. The loss, its gradients and train
steps of the same models are in tests/test_torch_port_pmodel_train.py.

Small size (batch 16, n = 8) at the presets' full widths. Both packages
get the same numpy data and the same weights (JAX-initialized, carried
over by ``params_from_jax``). Noise is injected: the tests replay the JAX
package's own key splits (vae.py:470 -> vae.py:292, then for P the three
encoders' keys of vae.py:229, then mvn.py:65) and hand the port those
exact normals, for P as the x, c and y encoders' slices of one
``noise["z"]``.

Tolerances: whole-model outputs rtol/atol 1e-4, as for simple_beam (f32
on both sides, sums in other orders, errors of encoder, squash and
decoders compounding); bridge's 1e-4 data noise does not enter them, and
its outputs are of order 1. The CNN heads alone 1e-5.
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
from dpivae_tpu.train.optim import group_hparams as jax_group_hparams
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu.utils.priors import factor_indices
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax, state_dict_from_jax
from dpivae_tpu_torch.models.encoders import CNNEncoder
from dpivae_tpu_torch.serving import SAMPLE_SLOTS, build_predict_fn
from dpivae_tpu_torch.train import make_optimizer, setup_model
from dpivae_tpu_torch.train.optim import group_hparams
from dpivae_tpu_torch.utils.transforms import Chain, MaskedChain

N_TRAIN, B, N = 64, 16, 8
RTOL = ATOL = 1e-4
CONFIGS = [("damped_oscillator", "vae"), ("bridge", "DPIVAE-A"),
           ("bridge", "DPIVAE-B")]
_config_ids = [f"{c}-{p}" for c, p in CONFIGS]


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


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
    """JAX and port models of one case and preset, fitted on the same data,
    with the same (JAX-initialized) weights."""
    data = _data(case_name, N_TRAIN, 0)
    over = dict(n_train=N_TRAIN, n_batch=B, use_seed=True, **over)
    jcase = jax_get_case(case_name)
    jcfg = JaxTrainConfig().with_preset(jcase.presets[preset]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))

    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(**over)
    model = setup_model(cfg, case, data, device="cpu")
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return (jcfg, jmodel, jparams), (cfg, model, params)


def _encoder_normals(k_enc, model, n, batch):
    """The encoder normals JAX's ``encode`` draws from ``k_enc``: one joint
    draw for S; for P one per encoder (vae.py:229), joined x, c, y."""
    draw = lambda k, d: np.array(jax.random.normal(k, (n, batch, d)))
    if model.model_type == "S":
        eps = draw(k_enc, model.nz_x + model.nz_c + model.nz_y)
    else:
        k_x, k_c, k_y = jax.random.split(k_enc, 3)
        eps = np.concatenate([draw(k_x, model.nz_x), draw(k_c, model.nz_c),
                              draw(k_y, model.nz_y)], -1)
    return torch.from_numpy(eps)


def _replayed_noise(key, model, n, batch, cond):
    """The standard normals JAX's DPIVAE.sample draws from ``key``."""
    k_fwd, k_x, k_c, k_y = jax.random.split(key, 4)
    k_enc, k_prior = jax.random.split(k_fwd)
    draw = lambda k, d: torch.from_numpy(
        np.array(jax.random.normal(k, (n, batch, d))))
    noise = {"z": _encoder_normals(k_enc, model, n, batch),
             "x": draw(k_x, model.nd_x), "c": draw(k_c, model.nd_c),
             "y": draw(k_y, model.nd_y)}
    if cond:
        noise["z_prior"] = draw(k_prior, model.nz_c)
    return noise


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case_name, preset", CONFIGS, ids=_config_ids)
def test_sample_matches_jax(case_name, preset, use_pallas, cond):
    (jcfg, jmodel, jparams), (cfg, model, params) = _models(
        case_name, preset, use_pallas=use_pallas)
    assert model.model_type == jmodel.model_type
    assert model.use_pallas is use_pallas
    x, c, _ = _data(case_name, B, 1)
    key = jax.random.PRNGKey(7)
    want = jmodel.sample(jparams, key, jnp.asarray(x), jnp.asarray(c),
                         cond=cond, n=N, grl_alpha=jcfg.lambda_g0)
    with torch.no_grad():
        got = model.sample(params, torch.from_numpy(x), torch.from_numpy(c),
                           cond=cond, n=N, grl_alpha=cfg.lambda_g0,
                           noise=_replayed_noise(key, model, N, B, cond))
    assert len(got) == len(want) == 9
    for name, g, w in zip(("x_sample", "xh_p", "xh_d", "c_sample", "y", "zx",
                           "zc", "zy", "log_q"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, msg=name)


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case_name, preset", CONFIGS, ids=_config_ids)
def test_predict_fn_matches_jax(case_name, preset, use_pallas, cond):
    (jcfg, jmodel, jparams), (cfg, model, params) = _models(
        case_name, preset, use_pallas=use_pallas)
    x, c, _ = _data(case_name, B, 2)
    outputs = tuple(SAMPLE_SLOTS)
    jpredict = jax_build_predict_fn(jmodel, jparams, jcfg, cond=cond, n=N,
                                    outputs=outputs)
    key = jax.random.PRNGKey(11)
    want = jpredict(np.asarray(jax.random.key_data(key), np.uint32), x, c)
    predict = build_predict_fn(model, params, cfg, cond=cond, n=N,
                               outputs=outputs)
    got = predict(torch.from_numpy(x), torch.from_numpy(c),
                  noise=_replayed_noise(key, model, N, B, cond))
    for name, g, w in zip(outputs, got, want):
        _close(g, w, msg=name)


def test_cnn_encoder_model_sample_matches_jax():
    """The S model with the Conv1d encoder on damped_oscillator, end to
    end."""
    (jcfg, jmodel, jparams), (cfg, model, params) = _models(
        "damped_oscillator", "dpivae", encoder_x="CNN", use_pallas=True)
    assert isinstance(params.encoder, CNNEncoder)
    x, c, _ = _data("damped_oscillator", B, 3)
    key = jax.random.PRNGKey(8)
    want = jmodel.sample(jparams, key, jnp.asarray(x), jnp.asarray(c), n=N,
                         grl_alpha=jcfg.lambda_g0)
    with torch.no_grad():
        got = model.sample(params, torch.from_numpy(x), torch.from_numpy(c),
                           n=N, grl_alpha=cfg.lambda_g0,
                           noise=_replayed_noise(key, model, N, B, False))
    for g, w in zip(got, want):
        _close(g, w)


def test_p_model_squashes_only_z_x():
    _, (cfg, model, params) = _models("bridge", "DPIVAE-A")
    assert isinstance(model.output_transform_zx, Chain)
    assert sorted(n for n, _ in params.named_children()) == [
        "decoder_c", "decoder_x", "decoder_y", "encoder", "encoder_c",
        "encoder_y", "prior_net_c", "prior_net_y"]
    _, (_, s_model, _) = _models("bridge", "DPIVAE-B")
    assert isinstance(s_model.output_transform_zx, MaskedChain)
    x, c, _ = (torch.from_numpy(a) for a in _data("bridge", B, 4))
    with torch.no_grad():
        zx, zc, zy, log_q = model.encode(
            params, model.transform_inputs(x=x)[0], n=N,
            generator=torch.Generator().manual_seed(0))
    case = get_case("bridge")
    lb = torch.tensor([p.lb for p in case.prior_x])
    ub = torch.tensor([p.ub for p in case.prior_x])
    assert bool(((zx > lb) & (zx < ub)).all())
    # z_c and z_y are unsquashed normals: some fall outside any unit box
    assert float(torch.cat([zc, zy], -1).abs().max()) > 1.0
    assert log_q.shape == (N, B)


@pytest.mark.parametrize("model_type", ["P", "S"])
def test_group_hparams_match_jax(model_type):
    over = dict(model_type=model_type, lr_e=2e-3, lr_ex=3e-3, lr_ec=4e-3,
                lr_ey=5e-3, lr_p=6e-3, wd_e=0.1, wd_p=0.2, lr_sigma=7e-3)
    assert (group_hparams(TrainConfig().replace(**over))
            == jax_group_hparams(JaxTrainConfig().replace(**over)))


def test_p_model_optimizer_groups_follow_the_config():
    _, (cfg, _, params) = _models("bridge", "DPIVAE-A", lr_ex=2e-3,
                                  lr_ec=3e-3, lr_ey=4e-3, wd_e=0.01)
    opt = make_optimizer(cfg, params)
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    assert len(groups) == len(list(params.parameters()))
    for name, lr in (("encoder", 2e-3), ("encoder_c", 3e-3),
                     ("encoder_y", 4e-3)):
        group = groups[id(getattr(params, name).f_mean.weight)]
        assert (group["lr"], group["weight_decay"]) == (lr, 0.01), name


@pytest.mark.parametrize("ch_in", [1, 2])
def test_cnn_encoder_heads_match_jax(ch_in):
    """The Conv1d head against cnn_encoder_init / full_cov_nn_apply: the
    NWC flatten order, SAME padding and the clamps (wide inputs reach
    them)."""
    n_latent, n_input = 5, 64
    jp = jax_enc.cnn_encoder_init(jax.random.PRNGKey(4), n_latent, n_input,
                                  ch_in=ch_in)
    module = CNNEncoder(n_latent, n_input, torch.Generator().manual_seed(0),
                        torch.device("cpu"), ch_in=ch_in)
    module.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, jp)))
    rng = np.random.default_rng(ch_in)
    for scale in (1.0, 30.0):
        x = (rng.standard_normal((3, 7, n_input)) * scale).astype(np.float32)
        loc_j, tril_j = jax_enc.full_cov_nn_apply(jp, jnp.asarray(x),
                                                  n_latent)
        with torch.no_grad():
            loc, tril = module(torch.from_numpy(x))
        assert loc.shape == (3, 7, n_latent)
        assert tril.shape == (3, 7, n_latent, n_latent)
        _close(loc, loc_j, 1e-5, 1e-5)
        _close(tril, tril_j, 1e-5, 1e-5)


def test_cnn_encoder_rejects_indivisible_channels():
    with pytest.raises(ValueError, match="ch_in"):
        CNNEncoder(3, 64, torch.Generator(), torch.device("cpu"), ch_in=3)


@pytest.mark.parametrize("variant", [
    dict(case_name="bridge", preset="DPIVAE-A"),
    dict(case_name="damped_oscillator", preset="vae", encoder_x="CNN",
         encoder_y="CNN", ch_in=2),
], ids=["P", "P-CNN"])
def test_params_from_jax_round_trip(variant):
    variant = dict(variant)
    (_, jmodel, jparams), (_, model, params) = _models(
        variant.pop("case_name"), variant.pop("preset"), **variant)
    tree = jax.tree.map(np.asarray, jparams)
    state = params.state_dict()
    flat = state_dict_from_jax(tree)
    assert set(flat) == set(state)
    assert len(flat) == len(jax.tree.leaves(tree))
    for name, value in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), value.numpy())
    if "encoder_x" in variant:
        # A conv weight (kernel, ch_in, ch_out) becomes (ch_out, ch_in,
        # kernel), nn.Conv1d's layout.
        w = tree["encoder"]["trunk"]["conv"][0]["w"]
        assert w.shape == (3, 2, 16)
        np.testing.assert_array_equal(
            params.encoder.trunk.conv[0].weight.detach().numpy(),
            np.transpose(w, (2, 1, 0)))
        assert isinstance(params.encoder_y, CNNEncoder)
        assert not isinstance(params.encoder_c, CNNEncoder)
    # A P tree without one of its encoders does not load.
    del tree["encoder_c"]
    with pytest.raises(RuntimeError, match="Missing key"):
        params_from_jax(model, tree, device="cpu")


def test_unknown_encoder_choice_raises():
    _, (_, model, _) = _models("bridge", "DPIVAE-A")
    with pytest.raises(ValueError, match="encoder_c"):
        dataclasses.replace(model, encoder_c_arch="RNN")
