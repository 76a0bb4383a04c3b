"""Where ``DPIVAE.loss`` computes its latent algebra with
``ops.latent.latent_gauss``, on the CPU: the S model's loss, single-run,
goes through the op, whose plain version there equals the composition of
``encode`` and ``prior_net`` (which sampling runs) bit for bit, latents,
KL_x and every gradient; the loss under the sweeps' ``vmap(grad(...))``
and the P model's loss do not call the op; the op refuses a latent width
above 16 and a tensor that is not float32. Small sizes (batch 8, 4 MC
samples). The kernels themselves are compared with the plain version on
the card (tests/test_torch_latent_cuda.py).
"""

import pytest
import torch

from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.models.vae import bind_params
from dpivae_tpu_torch.ops import latent
from dpivae_tpu_torch.ops.mvn import mvn_log_prob
from dpivae_tpu_torch.train import init_params, setup_model
from dpivae_tpu_torch.train.train import stack_params
from dpivae_tpu_torch.utils.data import sample_response

B, N = 8, 4


def _model(case_name, preset, seed=0):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        n_train=32, n_batch=B, use_seed=True, use_pallas=False)
    g = torch.Generator().manual_seed(seed)
    data = sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                           device="cpu")
    model = setup_model(cfg, case, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    x, c, y = (a[:B] for a in data[:3])
    eps = torch.randn((N, B, model.nz_x + model.nz_c + model.nz_y),
                      generator=g)
    return model, params, (x, c, y), eps


@pytest.fixture
def calls(monkeypatch):
    """Counts the loss's calls of ``latent_gauss``."""
    counted = []
    op = latent.latent_gauss

    def spy(*args, **kwargs):
        counted.append(1)
        return op(*args, **kwargs)

    monkeypatch.setattr(latent, "latent_gauss", spy)
    return counted


def _kl_and_grads(model, params, data, eps):
    """KL_x of the loss, and the grads of its sum."""
    params.zero_grad(set_to_none=True)
    kl = model.loss(params, *data, n=N, grl_alpha=0.5, noise={"z": eps})[1]
    torch.sum(kl).backward()
    return kl.detach(), _grads(params)


def _grads(params):
    return {k: p.grad.clone() for k, p in params.named_parameters()
            if p.grad is not None}


def _composition(model, params, data, eps):
    """(zx, zc, zy), KL_x and the grads of its sum through ``encode`` and
    ``prior_net``: the latent algebra as sampling composes it."""
    x, c, y = data
    params.zero_grad(set_to_none=True)
    x_t, _, _ = model.transform_inputs(x=x)
    zx, zc, zy, dens_z = model.encode(params, x_t, n=N, eps=eps)
    loc_c, tril_c, loc_y, tril_y = model.prior_net(params, c, y=y)
    log_prior_z = (torch.sum(model.prior_x.log_prob(zx), dim=-1)
                   + mvn_log_prob(zc, loc_c, tril_c)
                   + mvn_log_prob(zy, loc_y, tril_y))
    kl = torch.mean(dens_z - log_prior_z, dim=0)
    torch.sum(kl).backward()
    return (zx, zc, zy), kl.detach(), _grads(params)


@pytest.mark.parametrize("case_name, preset", [
    ("simple_beam", "dpivae"), ("damped_oscillator", "dpivae")])
def test_s_loss_goes_through_the_op_bit_for_bit(calls, case_name, preset):
    model, params, data, eps = _model(case_name, preset)
    got_kl, got_grads = _kl_and_grads(model, params, data, eps)
    assert len(calls) == 1
    want_z, want_kl, want_grads = _composition(model, params, data, eps)
    assert torch.equal(got_kl, want_kl)
    assert got_grads.keys() == want_grads.keys()
    for k in got_grads:
        assert torch.equal(got_grads[k], want_grads[k]), k
    x_t, c_t, y_t = model.transform_inputs(*data)
    with torch.no_grad():
        got_z = latent.latent_gauss(
            params.encoder.heads(x_t), eps, params.prior_net_c.heads(c_t),
            params.prior_net_y.heads(y_t), model.output_transform_zx,
            model.prior_x)[:3]
    for a, b in zip(got_z, want_z):
        assert torch.equal(a, b.detach())


def test_member_loss_under_vmap_grad_keeps_the_other_path(calls):
    model, params, data, eps = _model("damped_oscillator", "dpivae")
    stacked = stack_params([params, params])
    call = bind_params(model)

    def member_loss(p, x, c, y, eps):
        out = call(model, "loss", p, x, c, y, n=N, noise={"z": eps})
        return torch.sum(out[0])

    two = lambda t: torch.stack([t, t])
    grads = torch.func.vmap(torch.func.grad(member_loss))(
        stacked, *(two(t) for t in data), two(eps))
    assert not calls
    assert all(torch.isfinite(g).all() for g in grads.values())


def test_p_model_keeps_the_other_path(calls):
    model, params, data, eps = _model("damped_oscillator", "vae")
    assert model.model_type == "P"
    _kl_and_grads(model, params, data, eps)
    assert not calls


def test_op_refuses_wide_latents_and_other_dtypes():
    model, params, (x, c, y), eps = _model("simple_beam", "dpivae")
    x_t, c_t, y_t = model.transform_inputs(x=x, c=c, y=y)
    enc = params.encoder.heads(x_t)
    prior_c, prior_y = (params.prior_net_c.heads(c_t),
                        params.prior_net_y.heads(y_t))
    args = (model.output_transform_zx, model.prior_x)
    latent.latent_gauss(enc, eps, prior_c, prior_y, *args)
    wide = tuple(torch.zeros(B, 17 * k) for k in (1, 1, 17))
    with pytest.raises(ValueError, match="at most 16"):
        latent.latent_gauss(wide, torch.zeros(N, B, 17), prior_c, prior_y,
                            *args)
    with pytest.raises(TypeError, match="float32"):
        latent.latent_gauss(enc, eps.double(), prior_c, prior_y, *args)
    with pytest.raises(TypeError, match="float32"):
        latent.latent_gauss(tuple(t.half() for t in enc), eps, prior_c,
                            prior_y, *args)
