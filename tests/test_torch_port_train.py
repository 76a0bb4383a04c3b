"""The port's training slice against the JAX package, on the CPU: the ELBO
loss and its gradients, the MC-chunked loss, the annealing schedules, early
stopping, the grouped Adam with its global-norm clip, train steps, and
``train_model``'s loop semantics.

Small sizes: batch 16, 4 MC samples, n_train 64, at simple_beam/dpivae's
full widths. Both packages get the same numpy data and the same weights
(JAX-initialized, carried over by ``params_from_jax``). Noise is injected:
JAX's ``loss -> forward -> _encode_latents`` splits its key (vae.py:292)
and ``mvn.py:65`` draws ``normal(k_enc, (n, batch, 6))``; the tests replay
those normals and hand them to the port. No JAX ``train_model`` runs here
(it compiles for tens of seconds): the JAX side of each train step is
``jax.grad`` of the loss and the JAX optimizer's ``update``.

Tolerances: the loss 8-tuple rtol/atol 1e-4, as the model tests (f32 on
both sides, sums in other orders, x up to about 25 mm); gradients rtol
5e-4 / atol 1e-6, as tests/test_torch_parity.py:244; parameters after
three Adam steps rtol/atol 1e-5 (each step moves a parameter by about its
learning rate, 1e-3, so 1e-5 is 1 % of one step).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import AnnealingConfig as JaxAnnealingConfig
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.train.optim import make_optimizer as jax_make_optimizer
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu.utils import annealing as jax_annealing
from dpivae_tpu.utils import early_stopping as jax_es
from dpivae_tpu.utils.priors import factor_indices
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import AnnealingConfig, TrainConfig
from dpivae_tpu_torch.convert import params_from_jax, state_dict_from_jax
from dpivae_tpu_torch.train import (
    TRAIN_COLUMNS,
    VAL_COLUMNS,
    make_optimizer,
    setup_model,
    train_model,
)
from dpivae_tpu_torch.train.optim import clip_grad_global_norm_
from dpivae_tpu_torch.train.train import Trainer, _sample_batch
from dpivae_tpu_torch.utils import annealing
from dpivae_tpu_torch.utils import early_stopping as es

N_TRAIN, B, N = 64, 16, 4
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
PARAM_TOL = 1e-5
# Params after 50 Adam steps at full widths: every element within half of
# one Adam step at the learning rate 1e-3 (measured max 1.89e-4: elements
# whose gradients sit near Adam's eps turn last-bit differences into
# update differences), and 99 % of them within 1e-4 (measured 3.3e-5).
FIFTY_STEP_PARAM_TOL = 5e-4
FIFTY_STEP_P99_TOL = 1e-4
# Loss weights away from 1, so that each reaches the result.
WEIGHTS = dict(beta_x=0.7, beta_c=1.0, beta_y=1.0, alpha_x=1.1, alpha_c=0.9,
               alpha_y=1.3)


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


def _models(**over):
    """JAX and port models of simple_beam/dpivae fitted on the same data,
    with the same (JAX-initialized) weights."""
    over = dict(n_train=N_TRAIN, n_batch=B, n_mc_train=N, n_mc_val=N,
                use_seed=True, **over)
    data = _data(N_TRAIN, 0)
    jcase = jax_get_case("simple_beam")
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))

    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(**over)
    model = setup_model(cfg, case, data, device="cpu")
    params = params_from_jax(model, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return data, (jcfg, jmodel, jparams), (cfg, case, model, params)


def _replayed_eps(key, n, batch, nz=6):
    """The encoder normals JAX's DPIVAE.loss draws from ``key``."""
    k_enc, _ = jax.random.split(key)
    return np.asarray(jax.random.normal(k_enc, (n, batch, nz)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _losses(jmodel, jparams, model, params, x, c, y, key, lam):
    want = jmodel.loss(jparams, key, jnp.asarray(x), jnp.asarray(c),
                       jnp.asarray(y), n=N, grl_alpha=lam, **WEIGHTS)
    got = model.loss(params, _t(x), _t(c), _t(y), n=N, grl_alpha=lam,
                     noise={"z": _t(_replayed_eps(key, N, len(x)))}, **WEIGHTS)
    return got, want


VARIANTS = [
    dict(use_pallas=p, mc_chunk=m, lambda_x=l)
    for p in (False, True) for m in (None, 2) for l in (None, 0.1)
]
_ids = lambda v: f"pallas{int(v['use_pallas'])}-chunk{v['mc_chunk']}-lx{v['lambda_x']}"


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_loss_matches_jax(variant):
    _, (jcfg, jmodel, jparams), (cfg, _, model, params) = _models(**variant)
    assert model.use_pallas is variant["use_pallas"]
    assert model.mc_chunk == jmodel.mc_chunk == variant["mc_chunk"]
    x, c, y = _data(B, 1)
    with torch.no_grad():
        got, want = _losses(jmodel, jparams, model, params, x, c, y,
                            jax.random.PRNGKey(5), cfg.lambda_g0)
    assert len(got) == len(want) == 8
    for name, g, w in zip(("loss", "KLx", "KLc", "KLy", "Rx", "Rc", "Ry",
                           "reg"), got, want):
        assert g.shape == w.shape == (B,)
        _close(g, w, LOSS_TOL, LOSS_TOL, name)
    if variant["lambda_x"] is None:
        assert not got[7].any()
    else:
        assert got[7].abs().min() > 0


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_gradients_match_jax(variant):
    """Every parameter's gradient of the normalised loss, through the GRL
    and (with use_pallas) FusedMLPFunction's backward."""
    _, (jcfg, jmodel, jparams), (cfg, case, model, params) = _models(**variant)
    x, c, y = _data(B, 2)
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
                     noise={"z": _t(_replayed_eps(key, N, B))}, **WEIGHTS)
    (torch.sum(out[0]) / denom).backward()
    got = dict(params.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name].grad is not None, name
        _close(got[name].grad, w, GRAD_RTOL, GRAD_ATOL, name)


def test_chunked_loss_equals_unchunked():
    _, _, (cfg, case, model, params) = _models(lambda_x=0.1)
    chunked = dataclasses.replace(model, mc_chunk=2)
    x, c, y = (_t(a) for a in _data(B, 3))
    eps = {"z": torch.randn(N, B, 6, generator=torch.Generator().manual_seed(0))}
    grads = []
    for m in (model, chunked):
        params.zero_grad()
        out = m.loss(params, x, c, y, n=N, grl_alpha=cfg.lambda_g0, noise=eps)
        torch.sum(out[0]).backward()
        grads.append([p.grad.clone() for p in params.parameters()])
        if m is model:
            whole = [t.detach() for t in out]
    for a, b in zip(whole, out):
        torch.testing.assert_close(b.detach(), a, rtol=1e-5, atol=1e-5)
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        dataclasses.replace(model, mc_chunk=3).loss(
            params, x, c, y, n=N, noise=eps)


@pytest.mark.parametrize("spec", [
    dict(type=None),
    dict(type="cyclical", n_cycles=3, R=0.4),
    dict(type="sigmoid", mu=0.3, cov=0.2),
])
def test_schedules_match_jax(spec):
    n_iter = 1000
    ours = annealing.make_schedule(AnnealingConfig(**spec), n_iter)
    theirs = jax_annealing.make_schedule(JaxAnnealingConfig(**spec), n_iter)
    assert (getattr(ours, "constant_value", None)
            == getattr(theirs, "constant_value", None))
    for step in (0, 1, 100, 133, 200, 300, 333, 500, 999):
        _close(float(ours(step)), theirs(step), 1e-6, 1e-7, f"step {step}")
    with pytest.raises(ValueError, match="Invalid type"):
        annealing.make_schedule(AnnealingConfig(type="linear"), n_iter)


def test_early_stop_update_matches_jax():
    """A sequence that reaches every branch: improvement, the dead zone,
    worse-than-best counting up to the stop, and the latch."""
    patience, min_delta = 2, 0.1
    vals = [5.0, 4.0, 3.95, 4.5, 3.0, 3.05, 3.1, 2.0, 9.0]
    ours, theirs = es.early_stop_init(), jax_es.early_stop_init()
    seen = []
    for v in vals:
        ours = es.early_stop_update(ours, torch.tensor(v), patience,
                                    min_delta)
        theirs = jax_es.early_stop_update(theirs, v, patience, min_delta)
        assert float(ours.best) == float(theirs.best)
        assert int(ours.counter) == int(theirs.counter)
        assert bool(ours.stopped) == bool(theirs.stopped)
        seen.append((float(ours.best), int(ours.counter),
                     bool(ours.stopped)))
    # 3.95 is the dead zone; 3.05 then 3.1 are worse and stop at patience 2;
    # 2.0 would improve but the stop has latched.
    assert seen[2] == (4.0, 0, False)
    assert seen[5][1:] == (1, False) and seen[6][1:] == (2, True)
    assert seen[7] == seen[8] == seen[6]


def test_optimizer_groups_follow_the_config():
    _, _, (cfg, _, _, params) = _models(lr_e=2e-3, wd_p=0.01, lr_sigma=5e-3)
    opt = make_optimizer(cfg, params)
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    assert len(groups) == len(list(params.parameters()))
    enc = groups[id(params.encoder.f_mean.weight)]
    assert (enc["lr"], enc["weight_decay"]) == (2e-3, 0.0)
    prior = groups[id(params.prior_net_y.f_mean.bias)]
    assert (prior["lr"], prior["weight_decay"]) == (1e-3, 0.01)
    assert groups[id(params.log_sigma_x)]["lr"] == 5e-3
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8


@pytest.mark.parametrize("max_norm", [0.5, 2.0, 100.0])
def test_global_norm_clip_matches_optax(max_norm):
    """optax scales by max_norm / norm only above max_norm;
    torch.nn.utils.clip_grad_norm_ would also scale by max_norm /
    (norm + 1e-6) below it."""
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) * 0.3
             for s in ((4, 3), (5,), ())]
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    ps = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(ps, grads):
        p.grad = _t(g)
    norm = clip_grad_global_norm_(ps, max_norm)
    _close(norm, np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)),
           1e-6, 0)
    for p, w in zip(ps, want):
        _close(p.grad, w, 1e-6, 1e-7)
    if max_norm > float(norm):
        for p, g in zip(ps, grads):
            assert np.array_equal(p.grad.numpy(), g)


@pytest.mark.parametrize("over", [
    dict(),
    dict(clip_gradients=True, max_grad_norm=0.05, wd_e=0.01, wd_dx=0.02,
         wd_sigma=0.1, lr_dx=3e-3),
    dict(n_iter=6, lambda_annealing="sigmoid", lambda_mu=0.3,
         lambda_cov=0.2, beta_x_annealing="cyclical", beta_x_n_cycles=2,
         beta_x_R=0.4),
], ids=["plain", "clip-wd", "annealed"])
def test_train_steps_match_jax(over):
    """Three train steps through the seam (given batch rows and encoder
    noise) against JAX's optimizer update on jax.grad of the same
    normalised loss, from the same state. The loss weights are each
    step's schedule row, as the JAX loop forms it; in the annealed case
    the GRL strength and beta_x change at every step."""
    data, (jcfg, jmodel, jparams), (cfg, case, _, params) = _models(
        use_pallas=True, **over)
    run = Trainer(cfg, case, params, data, _data(N_TRAIN, 9), cfg.lambda_g0)
    tx = jax_make_optimizer(jcfg, jparams)
    opt_state = tx.init(jparams)
    denom = B * (case.nd_x + case.nd_y + case.nd_c)
    rng = np.random.default_rng(4)
    scales = dict(lambda_=jcfg.lambda_g0, beta_x=jcfg.beta_x0,
                  beta_c=jcfg.beta_c0, beta_y=jcfg.beta_y0)
    scheds = {name: jax_annealing.make_schedule(
        jcfg.annealing(name.rstrip("_")), jcfg.n_iter) for name in scales}
    for step in range(3):
        idx = rng.choice(N_TRAIN, B, replace=False)
        key = jax.random.PRNGKey(100 + step)
        x, c, y = (jnp.asarray(a[idx]) for a in data)
        w = {name: scales[name] * scheds[name](step) for name in scales}

        def scalar(p):
            out = jmodel.loss(p, key, x, c, y, n=N, grl_alpha=w["lambda_"],
                              beta_x=w["beta_x"], beta_c=w["beta_c"],
                              beta_y=w["beta_y"])
            return jnp.sum(out[0]) / denom

        value, grads = jax.value_and_grad(scalar)(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        row = run.step(step, batch_idx=torch.from_numpy(idx),
                       noise={"z": _t(_replayed_eps(key, N, B))})
        assert row.shape == (len(TRAIN_COLUMNS),)
        _close(row[0], value, LOSS_TOL, LOSS_TOL)
        _close(row[8:12], [w[name] for name in scales], 1e-6, 1e-7)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for name, p in params.state_dict().items():
        _close(p, want[name], PARAM_TOL, PARAM_TOL, name)
    _close(row[-1], np.exp(np.asarray(jparams["log_sigma_x"])), 1e-6, 0)


def test_fifty_steps_match_jax_at_full_widths():
    """50 train steps through the seam at simple_beam's full training
    widths (batch 64, 16 MC samples, 1,024 training points) against JAX's
    optimizer update on jax.grad of the same normalised loss, jitted once:
    the same batch rows and replayed encoder noise each step, each step's
    loss row held at LOSS_TOL (measured drift at most 1.8e-5), the params
    after the 50th at FIFTY_STEP_PARAM_TOL and FIFTY_STEP_P99_TOL."""
    n_train, batch, n_mc, n_steps = 1024, 64, 16, 50
    over = dict(n_train=n_train, n_batch=batch, n_mc_train=n_mc,
                use_seed=True, use_pallas=True)
    data = _data(n_train, 10)
    jcase = jax_get_case("simple_beam")
    jcfg = JaxTrainConfig().with_preset(jcase.presets["dpivae"]).replace(**over)
    jmodel = jax_setup_model(jcfg, jcase, data)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(**over)
    params = params_from_jax(setup_model(cfg, case, data, device="cpu"),
                             jax.tree.map(np.asarray, jparams), device="cpu")
    run = Trainer(cfg, case, params, data, _data(N_TRAIN, 9), cfg.lambda_g0)
    tx = jax_make_optimizer(jcfg, jparams)
    denom = batch * (case.nd_x + case.nd_y + case.nd_c)
    x_all, c_all, y_all = (jnp.asarray(a) for a in data)

    scales = (jcfg.lambda_g0, jcfg.beta_x0, jcfg.beta_c0, jcfg.beta_y0)
    scheds = [jax_annealing.make_schedule(jcfg.annealing(name), jcfg.n_iter)
              for name in ("lambda", "beta_x", "beta_c", "beta_y")]

    def jax_step(p, opt_state, idx, seed, w):
        key = jax.random.PRNGKey(seed)

        def scalar(q):
            out = jmodel.loss(q, key, x_all[idx], c_all[idx], y_all[idx],
                              n=n_mc, grl_alpha=w[0], beta_x=w[1],
                              beta_c=w[2], beta_y=w[3])
            return jnp.sum(out[0]) / denom

        value, grads = jax.value_and_grad(scalar)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        # the encoder normals the loss drew, as _replayed_eps draws them
        eps = jax.random.normal(jax.random.split(key)[0], (n_mc, batch, 6))
        return (jax.tree.map(lambda a, u: a + u, p, updates), opt_state,
                value, eps)

    opt_state = tx.init(jparams)
    weights = [np.float32([s * f(step) for s, f in zip(scales, scheds)])
               for step in range(n_steps)]
    # One compile, without XLA's backend optimizations: at this size the
    # compile is most of the test's time.
    jax_step = jax.jit(jax_step).lower(
        jparams, opt_state, np.arange(batch), 0, weights[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    rng = np.random.default_rng(5)
    drift = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # small tensors: one thread is the fastest
    try:
        for step, w in enumerate(weights):
            idx = rng.choice(n_train, batch, replace=False)
            jparams, opt_state, value, eps = jax_step(
                jparams, opt_state, idx, 1000 + step, w)
            row = run.step(step, batch_idx=torch.from_numpy(idx),
                           noise={"z": _t(eps)})
            drift.append(abs(float(row[0]) - float(value)))
            _close(row[0], value, LOSS_TOL, LOSS_TOL, f"step {step}")
            _close(row[8:12], w, 1e-6, 1e-7, f"step {step}")
    finally:
        torch.set_num_threads(threads)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    diffs = np.concatenate([np.abs(p.numpy() - np.asarray(want[name])).ravel()
                            for name, p in params.state_dict().items()])
    worst, p99 = float(diffs.max()), float(np.quantile(diffs, 0.99))
    print(f"\n{n_steps} steps at batch {batch} x {n_mc} MC: loss row "
          f"|difference| max {max(drift):.2e} (step "
          f"{int(np.argmax(drift))}; tolerance {LOSS_TOL}), params max "
          f"{worst:.2e} (tolerance {FIFTY_STEP_PARAM_TOL}), 99th percentile "
          f"{p99:.2e} (tolerance {FIFTY_STEP_P99_TOL})")
    assert worst <= FIFTY_STEP_PARAM_TOL
    assert p99 <= FIFTY_STEP_P99_TOL


def _train_setup(**over):
    over = {**dict(n_train=N_TRAIN, n_val=32, n_batch=B, n_mc_train=N,
                   n_mc_val=4, use_seed=True, use_pallas=True), **over}
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(**over)
    data_train, data_val = _data(N_TRAIN, 0), _data(32, 1)
    model = setup_model(cfg, case, data_train, device="cpu")
    return cfg, model, case, data_train, data_val


def test_train_model_decreases_elbo():
    cfg, model, case, dtr, dva = _train_setup(n_iter=200, val_freq=20)
    params, logs = train_model(cfg, model, case, dtr, dva, device="cpu")
    assert logs.train.shape == (200, len(TRAIN_COLUMNS))
    assert logs.val.shape == (10, len(VAL_COLUMNS))
    assert logs.stop_iter == 200 and bool(logs.val_active.all())
    assert torch.isfinite(logs.train).all() and torch.isfinite(logs.val).all()
    _, elbo = logs.scalars("ELBO")
    assert np.mean(elbo[-20:]) < np.mean(elbo[:20]) - 1.0
    _, elbo_val = logs.scalars("ELBO_val")
    assert elbo_val[-1] < elbo_val[0]
    _, lam = logs.scalars("lambda_x")
    np.testing.assert_allclose(lam, cfg.lambda_g0, rtol=1e-6)


def test_train_model_partial_block_stops_at_n_iter():
    """n_iter=55, val_freq=10: 55 rows, 6 validations, and the params are
    those after step 55 (the per-step sigma_x column logs exp(log_sigma_x)
    right after each update). The caller's params are left as they were."""
    cfg, model, case, dtr, dva = _train_setup(n_iter=55, val_freq=10,
                                              patience=10**9)
    init = model.init(torch.Generator().manual_seed(3), device="cpu")
    before = {k: v.clone() for k, v in init.state_dict().items()}
    params, logs = train_model(cfg, model, case, dtr, dva, params=init,
                               device="cpu")
    assert logs.train.shape == (55, len(TRAIN_COLUMNS))
    assert logs.stop_iter == 55
    assert logs.val.shape == (6, len(VAL_COLUMNS))
    assert bool(logs.val_active.all())
    np.testing.assert_array_equal(logs.val_iters.numpy(), np.arange(6) * 10)
    np.testing.assert_allclose(float(params.log_sigma_x.detach().exp()),
                               float(logs.train[54, -1]), rtol=1e-6)
    for k, v in init.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_train_model_early_stop_returns_break_point_params():
    """patience=0 with a one-sample validation (noisy) and 10x learning
    rates: the first validation worse than the best latches the stop (at
    iteration 110 with these seeds; the CPU run is deterministic), the
    params are those right after that block's first step, and no row past
    it was run."""
    big = {name: 0.01 for name in ("lr_e", "lr_p", "lr_dx", "lr_dc", "lr_dy")}
    cfg, model, case, dtr, dva = _train_setup(
        n_iter=200, val_freq=10, patience=0, n_mc_val=1, min_delta=0.0,
        **big)
    params, logs = train_model(cfg, model, case, dtr, dva, device="cpu")
    stop = logs.stop_iter
    assert stop < cfg.n_iter, "diverging training must early-stop"
    assert stop % cfg.val_freq == 1
    active = logs.train_active.numpy()
    assert active[:stop].all() and not active[stop:].any()
    assert torch.isnan(logs.train[stop:]).all()
    assert torch.isfinite(logs.train[:stop]).all()
    n_live = int(logs.val_active.sum())
    assert n_live == stop // cfg.val_freq + 1
    assert torch.isnan(logs.val[n_live:]).all()
    np.testing.assert_allclose(float(params.log_sigma_x.detach().exp()),
                               float(logs.train[stop - 1, -1]), rtol=1e-6)


def test_train_model_is_seeded():
    cfg, model, case, dtr, dva = _train_setup(n_iter=20, val_freq=10)
    runs = [train_model(cfg, model, case, dtr, dva, device="cpu")
            for _ in range(2)]
    assert torch.equal(runs[0][1].train, runs[1][1].train)
    other = train_model(cfg, model, case, dtr, dva, device="cpu",
                        generator=torch.Generator().manual_seed(99))
    assert not torch.equal(runs[0][1].train, other[1].train)


def test_sample_batch_uniform_without_replacement():
    n_train, n_batch, draws = 128, 32, 400
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([_sample_batch(g, n_train, n_batch, torch.device("cpu"))
                       for _ in range(draws)]).numpy()
    for row in idx:
        assert len(set(row.tolist())) == n_batch
    counts = np.bincount(idx.ravel(), minlength=n_train)
    expected = draws * n_batch / n_train
    sigma = np.sqrt(draws * (n_batch / n_train) * (1 - n_batch / n_train))
    assert np.all(np.abs(counts - expected) < 5 * sigma)
