"""The decode's two options against the JAX package, on the CPU:
``remat_decode`` (the decode recomputed in the backward through
``torch.utils.checkpoint``) and ``compute_dtype="bfloat16"`` (the decode's
MLPs and physics in bf16), on simple_beam/"dpivae" and the P-model and
bridge configurations of tests/test_torch_port_pmodel_train.py, whose
data, JAX-initialized weights and replayed encoder noise these tests use.

Tolerances:

- remat against the port's plain decode: the loss 8-tuple and every
  gradient rtol/atol 1e-6 (the recompute repeats the same f32 arithmetic);
  against JAX's ``remat_decode``: the loss rtol/atol 1e-4 and gradients
  rtol 5e-4 / atol 1e-6, as the plain decode is held.
- bf16 against JAX's bf16 decode: the loss 8-tuple and ``sample`` rtol
  2e-2, with an atol of 2e-2 of the largest magnitude of the compared
  tensor. bf16 keeps 8 bits of mantissa (a relative step of 2^-8 =
  3.9e-3), and the two packages round in their own orders and accumulate
  matrix products in their own ways, so a reconstruction term that sums
  32-64 rounded squares differs by a few of those steps; 2e-2 is five of
  them. Gradients, each tensor as a whole (norm of the difference over
  the norm of the reference): within 5e-2 of the f32 gradient, and
  within 5e-2 of JAX's bf16 gradient or, where JAX's bf16 gradient itself
  strays further from the f32 one, within twice that stray. Elementwise
  they cannot be held: a weight gradient sums dozens of rounded products
  and cancels. Measured: the port's bf16 gradients lie within 4.5e-2 of
  f32 and JAX's within 3.7e-2, except damped_oscillator/"vae"'s decoder_y
  layer-0 weight, where JAX's bf16 gradient lies 13 % from f32 and the
  port's 0.6 %. The cause is JAX's: its ``x @ w + b`` rounds twice in
  bf16, and the six pre-activations that land on exactly 0 drop their
  gradient at the ReLU (``test_bf16_decoder_y_gap_is_jaxs_double_rounding``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu_torch.convert import state_dict_from_jax
from dpivae_tpu_torch.ops import fused_mlp as ops
from test_torch_port_pmodel_train import (
    B,
    CONFIGS,
    GRAD_ATOL,
    GRAD_RTOL,
    LOSS_TOL,
    N,
    WEIGHTS,
    _close,
    _data,
    _models,
    _replayed_eps,
    _t,
)

ALL_CONFIGS = [("simple_beam", "dpivae"), *CONFIGS]
_ids = [f"{c}-{p}" for c, p in ALL_CONFIGS]
EXACT = 1e-6
BF16_RTOL = BF16_SCALE = 2e-2
BF16_GRAD = 5e-2
# One GRL strength for every configuration, so that the adversarial
# branch's reversed gradient reaches the encoder in each.
GRL_ALPHA = 1 / 256
NAMES = ("loss", "KLx", "KLc", "KLy", "Rx", "Rc", "Ry", "reg")


def _loss_and_grads(model, params, data, key, case, mc_chunk=None):
    """The port's loss 8-tuple and every gradient of the normalised loss,
    on replayed noise."""
    model = dataclasses.replace(model, mc_chunk=mc_chunk)
    x, c, y = data
    params.zero_grad(set_to_none=True)
    out = model.loss(params, _t(x), _t(c), _t(y), n=N,
                     grl_alpha=GRL_ALPHA, **WEIGHTS,
                     noise={"z": _replayed_eps(key, model, N, B)})
    denom = B * (case.nd_x + case.nd_y + case.nd_c)
    (torch.sum(out[0]) / denom).backward()
    grads = {k: p.grad.clone() for k, p in params.named_parameters()}
    return [t.detach() for t in out], grads


def _jax_loss_and_grads(jmodel, jparams, data, key, case):
    x, c, y = (jnp.asarray(a) for a in data)
    denom = B * (case.nd_x + case.nd_y + case.nd_c)

    def scalar(p):
        out = jmodel.loss(p, key, x, c, y, n=N, grl_alpha=GRL_ALPHA,
                          **WEIGHTS)
        return jnp.sum(out[0]) / denom, out

    (_, out), grads = jax.value_and_grad(scalar, has_aux=True)(jparams)
    return ([np.asarray(t) for t in out],
            state_dict_from_jax(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("mc_chunk", [None, 2])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case_name, preset", ALL_CONFIGS, ids=_ids)
def test_remat_matches_plain_decode(case_name, preset, use_pallas, mc_chunk):
    _, _, (cfg, case, model, params) = _models(case_name, preset,
                                               use_pallas=use_pallas)
    data, key = _data(case_name, B, 1), jax.random.PRNGKey(5)
    plain = _loss_and_grads(model, params, data, key, case, mc_chunk)
    remat = _loss_and_grads(dataclasses.replace(model, remat_decode=True),
                            params, data, key, case, mc_chunk)
    for name, g, w in zip(NAMES, remat[0], plain[0]):
        _close(g, w, EXACT, EXACT, name)
    assert set(remat[1]) == set(plain[1])
    for name, w in plain[1].items():
        _close(remat[1][name], w, EXACT, EXACT, name)


@pytest.mark.parametrize("case_name, preset", ALL_CONFIGS, ids=_ids)
def test_remat_matches_jax(case_name, preset):
    _, (_, jmodel, jparams), (_, case, model, params) = _models(
        case_name, preset, use_pallas=True, remat_decode=True)
    assert model.remat_decode and jmodel.remat_decode
    data, key = _data(case_name, B, 2), jax.random.PRNGKey(6)
    got, got_grads = _loss_and_grads(model, params, data, key, case)
    want, want_grads = _jax_loss_and_grads(jmodel, jparams, data, key, case)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, LOSS_TOL, LOSS_TOL, name)
    assert set(got_grads) == set(want_grads)
    for name, w in want_grads.items():
        _close(got_grads[name], w, GRAD_RTOL, GRAD_ATOL, name)


def test_remat_recomputes_the_forward_in_the_backward(monkeypatch):
    """Under remat one train step runs the fused MLP's forward twice (the
    second time inside the backward's recompute) and its hidden recompute
    once, and FusedMLPFunction and the GRL take part in both passes: the
    gradients equal the plain decode's (test above). On the CPU the
    wrapper runs the plain versions, so they are counted here."""
    calls = {"forward": 0, "hidden": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(ops, "fused_mlp_reference",
                        counted("forward", ops.fused_mlp_reference))
    monkeypatch.setattr(ops, "fused_mlp_hidden_reference",
                        counted("hidden", ops.fused_mlp_hidden_reference))
    _, _, (_, case, model, params) = _models("simple_beam", "dpivae",
                                             use_pallas=True)
    data, key = _data("simple_beam", B, 3), jax.random.PRNGKey(7)
    for remat, want in ((False, (1, 1)), (True, (2, 1))):
        calls.update(forward=0, hidden=0)
        _loss_and_grads(dataclasses.replace(model, remat_decode=remat),
                        params, data, key, case)
        assert (calls["forward"], calls["hidden"]) == want, remat


def _bf16_close(got, want, msg):
    want = np.asarray(want, np.float64)
    atol = BF16_SCALE * max(float(np.abs(want).max()), 1e-12)
    _close(got.double(), want, BF16_RTOL, atol, msg)


def _distance(a, b):
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("case_name, preset", ALL_CONFIGS, ids=_ids)
def test_bf16_matches_jax(case_name, preset):
    """The loss 8-tuple and every gradient with the decode in bf16; the
    stored params, their gradients and the outputs stay f32."""
    _, (_, jmodel, jparams), (cfg, case, model, params) = _models(
        case_name, preset, use_pallas="auto", compute_dtype="bfloat16")
    assert model.compute_dtype == jmodel.compute_dtype == "bfloat16"
    assert model.use_pallas is False
    data, key = _data(case_name, B, 4), jax.random.PRNGKey(8)
    got, got_grads = _loss_and_grads(model, params, data, key, case)
    want, want_grads = _jax_loss_and_grads(jmodel, jparams, data, key, case)
    f32, f32_grads = _loss_and_grads(
        dataclasses.replace(model, compute_dtype=None), params, data, key,
        case)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32
        _bf16_close(g, w, name)
    assert set(got_grads) == set(want_grads)
    for name, w in want_grads.items():
        g = got_grads[name]
        assert g.dtype == torch.float32, name
        assert _distance(g, f32_grads[name]) <= BF16_GRAD, name
        stray = _distance(w, f32_grads[name])
        assert _distance(g, w) <= max(BF16_GRAD, 2 * stray), name
    # bf16 moves the loss off the f32 one: the option reaches the decode.
    assert not torch.equal(got[0], f32[0])


@pytest.mark.parametrize("case_name, preset", ALL_CONFIGS, ids=_ids)
def test_bf16_sample_matches_jax(case_name, preset):
    """``sample`` with the decode in bf16, on replayed noise."""
    _, (_, jmodel, jparams), (cfg, _, model, params) = _models(
        case_name, preset, compute_dtype="bfloat16")
    x, c, _ = _data(case_name, B, 5)
    key = jax.random.PRNGKey(9)
    want = jmodel.sample(jparams, key, jnp.asarray(x), jnp.asarray(c), n=N,
                         grl_alpha=cfg.lambda_g0)
    k_fwd, k_x, k_c, k_y = jax.random.split(key, 4)
    draw = lambda k, d: _t(jax.random.normal(k, (N, B, d)))
    noise = {"z": _replayed_eps(k_fwd, model, N, B),
             "x": draw(k_x, model.nd_x), "c": draw(k_c, model.nd_c),
             "y": draw(k_y, model.nd_y)}
    with torch.no_grad():
        got = model.sample(params, _t(x), _t(c), n=N, grl_alpha=cfg.lambda_g0,
                           noise=noise)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _bf16_close(g, w, f"slot {i}")


def test_bf16_decoder_y_gap_is_jaxs_double_rounding():
    """The cause of damped_oscillator/"vae"'s decoder_y layer-0 gap. JAX's
    ``x @ w + b`` in bf16 rounds twice (the product to bf16, then the sum
    to bf16); the port's ``nn.Linear`` adds the bias in the product's f32
    accumulator and rounds once. Where the product nearly cancels the
    bias, JAX's pre-activation lands on exactly 0 or on the other side of
    it, the ReLU drops those elements' gradient, and those few elements
    carry most of the layer-0 gradient's stray from f32. The port, made to
    round twice as JAX does, gives JAX's bf16 pre-activation bit for bit
    and JAX's stray; rounding once, it stays close to f32."""
    _, (_, jmodel, jparams), _ = _models("damped_oscillator", "vae",
                                         use_pallas="auto")
    (x, c, y), key = _data("damped_oscillator", B, 4), jax.random.PRNGKey(8)
    zy = jmodel.forward(jparams, key, jnp.asarray(x), jnp.asarray(c), n=N,
                        grl_alpha=GRL_ALPHA)[8]
    (l0, l1) = jparams["decoder_y"]["layers"]
    f32 = [np.asarray(a) for a in (zy, l0["w"], l0["b"], l1["w"], l1["b"])]

    def ygrad(yh, log_sigma):
        # The cotangent the loss's y term sends into decoder_y, in f32.
        return -WEIGHTS["alpha_y"] * jnp.sum(
            -0.5 * ((jnp.asarray(y) - yh) / jnp.exp(log_sigma)) ** 2
            - log_sigma)

    out32 = jnp.asarray(f32[0]) @ f32[1] + f32[2]
    out32 = jax.nn.relu(out32) @ f32[3] + f32[4]
    cot = np.asarray(jnp.concatenate(jax.grad(ygrad, (0, 1))(
        out32[..., :1], out32[..., 1:]), -1))

    def jax_dw0(dt):
        def head(w0):
            z, b0, w1, b1 = (jnp.asarray(a, dt) for a in (f32[0], *f32[2:]))
            h = jax.nn.relu(z @ w0.astype(dt) + b0)
            return (h @ w1 + b1).astype(jnp.float32)
        return np.asarray(jax.vjp(head, jnp.asarray(f32[1]))[1](cot)[0])

    def port_dw0(dt, twice):
        z, w0, b0, w1, b1 = (torch.from_numpy(a.copy()) for a in f32)
        w0.requires_grad_(True)
        z, wd, b0, w1, b1 = (a.to(dt) for a in (z, w0, b0, w1, b1))
        pre = (z @ wd + b0 if twice else
               torch.nn.functional.linear(z, wd.T, b0))
        out = torch.nn.functional.linear(torch.relu(pre), w1.T, b1)
        out.float().backward(torch.from_numpy(cot.copy()))
        return w0.grad.numpy(), pre.detach().float().numpy()

    want32 = jax_dw0(jnp.float32)
    want16 = jax_dw0(jnp.bfloat16)
    once, pre_once = port_dw0(torch.bfloat16, twice=False)
    twice, pre_twice = port_dw0(torch.bfloat16, twice=True)
    jax_pre = np.asarray((jnp.asarray(f32[0], jnp.bfloat16)
                          @ jnp.asarray(f32[1], jnp.bfloat16)
                          + jnp.asarray(f32[2], jnp.bfloat16)
                          ).astype(jnp.float32))
    np.testing.assert_array_equal(pre_twice, jax_pre)
    assert (jax_pre == 0).sum() > (pre_once == 0).sum()
    assert _distance(want16, want32) > 0.1
    assert _distance(twice, want16) < 1e-3
    assert _distance(once, want32) < 2e-2
