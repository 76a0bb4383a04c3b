"""The decode's two options in member-batched training, on the CPU:
``remat_decode`` (the decode recomputed in the backward through
``ops.remat.recompute`` under ``torch.func.vmap(grad(...))``) and
``compute_dtype="bfloat16"``.

- Member-batched gradients with remat equal those without it, for the S
  and the P model, with ``use_pallas`` False and True (the plain versions
  on the CPU) and with ``mc_chunk``: the loss components and every
  gradient rtol/atol 1e-6 (the recompute repeats the same f32 arithmetic;
  the single run's bound, tests/test_torch_port_remat.py).
- Under remat a member-batched step runs the batched forward twice (the
  forward, then the recompute) and the batched hidden recompute once, per
  MC chunk.
- A remat sweep (the S model, simple_beam) against JAX's
  ``remat_decode`` members, as tests/test_torch_sweep.py holds the sweeps (its helpers, data, replayed
  noise and bounds: the loss rows rtol/atol 1e-4 at each of three steps,
  first-step gradients rtol 5e-4 / atol 1e-6, params after three Adam
  steps rtol/atol 1e-5, on bridge the elements near Adam's eps held to
  Adam's step). JAX's side of a member's step is one jitted
  ``value_and_grad`` of its loss and its optimizer's update, the loss's
  model fitted on the member's data inside the trace as JAX's sweep does.
- A bf16 sweep (the P model, bridge "DPIVAE-A") against JAX's bf16
  members at the first step, with the
  bounds of ``test_bf16_matches_jax``: each member's gradients, each
  tensor as a whole, within 5e-2 of the port's f32 ones and within 5e-2
  of JAX's bf16 ones or twice JAX's own distance from f32; the loss
  within rtol 2e-2 and an atol of 2e-2 of its magnitude.
  (The other model under each option is held to JAX in the single run,
  tests/test_torch_port_remat.py, and the members' plain decode in
  tests/test_torch_sweep.py; one model each keeps JAX's compiles few.)
- The sweeps' three trainers run both options end to end, remat equal to
  the plain decode's run, and the checkpoint digest keys on both fields.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpivae_tpu.train.optim import make_optimizer as jax_make_optimizer
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import state_dict_from_jax
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.sweep import train_hyper_sweep, train_sweep, \
    train_sweep_data
from dpivae_tpu_torch.sweep.sweep import _sweep_manifest, member_datasets
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.train.train import MemberTrainer, stack_params
from test_torch_sweep import (
    ADAM_SENSITIVE,
    B,
    GRAD_ATOL,
    GRAD_RTOL,
    LAMBDAS,
    LOSS_TOL,
    M,
    N,
    N_TRAIN,
    PARAM_TOL,
    _close,
    _configs,
    _members,
    _replayed_eps,
)

EXACT = 1e-6
BF16_RTOL = BF16_SCALE = 2e-2
BF16_GRAD = 5e-2
STEPS = 3
MODELS = [("simple_beam", "dpivae"), ("bridge", "DPIVAE-A")]
_ids = [f"{c}-{p}" for c, p in MODELS]


def _configs_with(case_name, preset, **over):
    """tests/test_torch_sweep.py's configs (the fused MLP on) with
    ``over`` applied to both packages'."""
    jcase, jcfg, case, cfg = _configs(case_name, preset)
    return jcase, jcfg.replace(**over), case, cfg.replace(**over)


def _distance(a, b):
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _random_members(case_name, preset, **over):
    """Two members of random init and data (the port alone), a batch and
    encoder normals for one step."""
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        n_train=N_TRAIN, n_val=32, n_batch=B, n_mc_train=N, n_mc_val=N,
        use_seed=True, **over)
    template = make_template_model(cfg, case, device="cpu")
    g = torch.Generator().manual_seed(0)
    params = stack_params([template.init(g, device="cpu") for _ in range(2)])
    data = [member_datasets(cfg, case, None, generator=g) for _ in range(2)]
    stack = lambda k: tuple(torch.stack([d[k][i] for d in data])
                            for i in range(3))
    nz = template.nz_x + template.nz_c + template.nz_y
    seam = dict(batch_idx=torch.stack([torch.randperm(N_TRAIN, generator=g)[:B]
                                       for _ in range(2)]),
                noise={"z": torch.randn(2, N, B, nz, generator=g)})
    return cfg, case, params, stack(0), stack(1), seam


@pytest.mark.parametrize("mc_chunk", [None, 2])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case_name, preset", MODELS, ids=_ids)
def test_member_remat_matches_plain_decode(case_name, preset, use_pallas,
                                           mc_chunk):
    cfg, case, params, dtr, dva, seam = _random_members(
        case_name, preset, use_pallas=use_pallas, mc_chunk=mc_chunk)
    lam = torch.tensor([0.5, -0.25])
    got = {remat: MemberTrainer(cfg.replace(remat_decode=remat), case,
                                params, dtr, dva, lam).grads(0, **seam)
           for remat in (False, True)}
    (plain, plain_grads), (remat, remat_grads) = got[False], got[True]
    _close(remat, plain, EXACT, EXACT, "components")
    assert set(remat_grads) == set(plain_grads)
    for name, w in plain_grads.items():
        _close(remat_grads[name], w, EXACT, EXACT, name)


def test_member_remat_recomputes_the_forward(monkeypatch):
    """Counted on the CPU at the plain versions the kernels' vmap rules
    call with member-stacked (rank-3) weights: remat runs the batched
    forward twice a step (the forward, then the recompute in the
    backward) and the batched hidden recompute once, per MC chunk; the
    card's launches are these calls (tests/test_torch_sweep_cuda.py)."""
    calls = {"forward": 0, "hidden": 0}

    def counted(name, fn):
        def wrapper(x, w0, *rest):
            calls[name] += w0.dim() == 3
            return fn(x, w0, *rest)
        return wrapper

    monkeypatch.setattr(ops, "fused_mlp_reference",
                        counted("forward", ops.fused_mlp_reference))
    monkeypatch.setattr(ops, "fused_mlp_hidden_reference",
                        counted("hidden", ops.fused_mlp_hidden_reference))
    for mc_chunk, remat, want in ((None, False, (1, 1)), (None, True, (2, 1)),
                                  (2, True, (4, 2))):
        cfg, case, params, dtr, dva, seam = _random_members(
            "simple_beam", "dpivae", use_pallas=True, mc_chunk=mc_chunk,
            remat_decode=remat)
        run = MemberTrainer(cfg, case, params, dtr, dva,
                            torch.tensor([0.5, -0.25]))
        calls.update(forward=0, hidden=0)
        run.grads(0, **seam)
        assert (calls["forward"], calls["hidden"]) == want, (mc_chunk, remat)


def _jax_member_step(jcfg, jcase, tx):
    """One jitted step of a JAX sweep member: its model fitted on its
    training data in the trace, the loss's value and gradients at the
    batch ``idx`` with the encoder key ``key``, and the optimizer's
    update."""
    denom = B * (jcase.nd_x + jcase.nd_y + jcase.nd_c)

    @jax.jit
    def step(jparams, opt_state, dtr, idx, key, lam):
        jmodel = jax_setup_model(jcfg, jcase, dtr)
        x, c, y = (a[idx] for a in dtr)

        def scalar(p):
            out = jmodel.loss(
                p, key, x, c, y, n=N, beta_x=jcfg.beta_x0,
                beta_c=jcfg.beta_c0, beta_y=jcfg.beta_y0,
                alpha_x=jcfg.alpha_x, alpha_c=jcfg.alpha_c,
                alpha_y=jcfg.alpha_y, grl_alpha=lam)
            return jnp.sum(out[0]) / denom

        value, grads = jax.value_and_grad(scalar)(jparams)
        updates, opt_state = tx.update(grads, opt_state, jparams)
        return value, grads, optax.apply_updates(jparams, updates), opt_state

    return step


def _seams(rng, model, step):
    idx = np.stack([rng.choice(N_TRAIN, B, replace=False) for _ in range(M)])
    keys = [jax.random.PRNGKey(100 + 10 * m + step) for m in range(M)]
    eps = np.stack([_replayed_eps(k, model, N, B) for k in keys])
    return idx, keys, dict(batch_idx=torch.from_numpy(idx),
                           noise={"z": torch.from_numpy(eps)})


@pytest.mark.parametrize("case_name, preset", MODELS[:1], ids=_ids[:1])
def test_remat_sweep_matches_jax(case_name, preset):
    """Three steps of every member with ``remat_decode``, the fused MLP on
    (its plain versions here), against JAX's ``remat_decode`` members."""
    jcase, jcfg, case, cfg = _configs_with(case_name, preset,
                                           remat_decode=True)
    jax_members, params, data_train, data_val = _members(jcase, jcfg, case,
                                                         cfg)
    run = MemberTrainer(cfg, case, params, data_train, data_val,
                        torch.from_numpy(LAMBDAS))
    assert run.template.remat_decode and run.template.use_pallas is True
    tx = jax_make_optimizer(jcfg, jax_members[0][2])
    jstep = _jax_member_step(jcfg, jcase, tx)
    states = [[tx.init(jp), jp] for _, _, jp in jax_members]
    rng = np.random.default_rng(4)
    first_grads = []
    for step in range(STEPS):
        idx, keys, seam = _seams(rng, run.template, step)
        if step == 0:
            _, grads = run.grads(step, **seam)
        rows = run.step(step, **seam)
        for m, ((dtr, _, _), state) in enumerate(zip(jax_members, states)):
            value, jgrads, state[1], state[0] = jstep(
                state[1], state[0], tuple(jnp.asarray(a) for a in dtr),
                jnp.asarray(idx[m]), keys[m], jnp.float32(LAMBDAS[m]))
            _close(rows[m, 0], value, LOSS_TOL, LOSS_TOL, f"member {m}")
            if step == 0:
                want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
                first_grads.append(want)
                assert set(grads) == set(want)
                for name, w in want.items():
                    _close(grads[name][m], w, GRAD_RTOL, GRAD_ATOL,
                           f"member {m} {name}")
    opt = run.optimizer
    offsets = np.cumsum([0] + [run.params[k][0].numel() for k in opt.names])
    start = dict(zip(opt.names, offsets[:-1]))
    for m, (_, jparams) in enumerate(states):
        want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
        for name, w in want.items():
            got, w = run.params[name][m].numpy(), np.asarray(w)
            g0 = np.abs(np.asarray(first_grads[m][name]))
            near_eps = ((g0 > 0.0) & (g0 <= ADAM_SENSITIVE) if case_name ==
                        "bridge" else np.zeros(w.shape, bool))
            assert near_eps.sum() <= max(2, near_eps.size // 100), name
            _close(got[~near_eps], w[~near_eps], PARAM_TOL, PARAM_TOL,
                   f"member {m} {name}")
            lr = float(opt.lr[m, start[name]])
            gap = np.abs(got[near_eps] - w[near_eps])
            assert (gap <= 2 * STEPS * lr).all(), (name, gap.max(), lr)


@pytest.mark.parametrize("case_name, preset", MODELS[1:], ids=_ids[1:])
def test_bf16_sweep_matches_jax(case_name, preset):
    """Every member's first step with the decode in bf16 ("auto": the
    plain path), against JAX's bf16 members, and against the port's f32
    step; the stored params and their gradients stay f32."""
    jcase, jcfg, case, cfg = _configs_with(
        case_name, preset, use_pallas="auto", compute_dtype="bfloat16")
    jax_members, params, data_train, data_val = _members(jcase, jcfg, case,
                                                         cfg)
    lam = torch.from_numpy(LAMBDAS)
    run = MemberTrainer(cfg, case, params, data_train, data_val, lam)
    f32 = MemberTrainer(cfg.replace(compute_dtype=None), case, params,
                        data_train, data_val, lam)
    assert run.template.compute_dtype == "bfloat16"
    assert run.template.use_pallas is False
    idx, keys, seam = _seams(np.random.default_rng(4), run.template, 0)
    comps, grads = run.grads(0, **seam)
    f32_comps, f32_grads = f32.grads(0, **seam)
    assert not torch.equal(comps, f32_comps)
    tx = jax_make_optimizer(jcfg, jax_members[0][2])
    jstep = _jax_member_step(jcfg, jcase, tx)
    for m, (dtr, _, jparams) in enumerate(jax_members):
        value, jgrads, _, _ = jstep(
            jparams, tx.init(jparams), tuple(jnp.asarray(a) for a in dtr),
            jnp.asarray(idx[m]), keys[m], jnp.float32(LAMBDAS[m]))
        value = float(value)
        _close(comps[m, 0].double(), value, BF16_RTOL,
               BF16_SCALE * abs(value), f"member {m}")
        want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
        assert set(grads) == set(want)
        for name, w in want.items():
            g, g32 = grads[name][m], f32_grads[name][m]
            assert g.dtype == torch.float32, name
            assert _distance(g, g32) <= BF16_GRAD, (m, name)
            stray = _distance(w, g32)
            assert _distance(g, w) <= max(BF16_GRAD, 2 * stray), (m, name)


def _run_trainer(trainer, cfg, case):
    if trainer == "train_sweep":
        return train_sweep(cfg, case, [0.5, -0.5], seed=3, device="cpu")
    if trainer == "train_hyper_sweep":
        return train_hyper_sweep(cfg, case, {"lr_e": [1e-3, 3e-3]}, seed=3,
                                 device="cpu")
    g = torch.Generator().manual_seed(3)
    data = [member_datasets(cfg, case, None, generator=g) for _ in range(2)]
    stack = lambda k: tuple(torch.stack([d[k][i] for d in data])
                            for i in range(3))
    return train_sweep_data(cfg, case, [0.5, -0.5], stack(0), stack(1),
                            seed=3, device="cpu")


@pytest.mark.parametrize("trainer", ["train_sweep", "train_hyper_sweep",
                                     "train_sweep_data"])
def test_sweep_trainers_take_the_decode_options(trainer):
    """Each trainer with remat (the fused MLP on, MC-chunked) equals its
    run with the plain decode; in bf16 its logs are finite and moved off
    the f32 run's."""
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=N_TRAIN, n_val=32, n_batch=B, n_mc_train=N, n_mc_val=N,
        n_iter=4, val_freq=2, use_seed=True, use_pallas=True, mc_chunk=2)
    plain = _run_trainer(trainer, cfg, case)
    remat = _run_trainer(trainer, cfg.replace(remat_decode=True), case)
    torch.testing.assert_close(remat.logs.train, plain.logs.train,
                               rtol=EXACT, atol=EXACT)
    for name, w in plain.params.items():
        torch.testing.assert_close(remat.params[name], w, rtol=EXACT,
                                   atol=EXACT, msg=name)
    bf16 = _run_trainer(trainer, cfg.replace(use_pallas="auto",
                                             compute_dtype="bfloat16"), case)
    f32 = _run_trainer(trainer, cfg.replace(use_pallas="auto"), case)
    assert torch.isfinite(bf16.logs.train).all()
    assert torch.isfinite(bf16.logs.val).all()
    assert not torch.equal(bf16.logs.train, f32.logs.train)


def test_sweep_digest_keys_on_the_decode_options():
    """A checkpointed sweep resumes only chunks of the same decode: the
    manifest digest differs with ``remat_decode`` and ``compute_dtype``,
    as JAX's covers its resolved config."""
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"])
    arrays = (np.zeros((2, 2), np.int64), np.zeros(2, np.float32))
    digest = lambda c: _sweep_manifest(c, case, arrays, 2, 2)["digest"]
    digests = {digest(cfg), digest(cfg.replace(remat_decode=True)),
               digest(cfg.replace(compute_dtype="bfloat16")),
               digest(cfg.replace(remat_decode=True,
                                  compute_dtype="bfloat16"))}
    assert len(digests) == 4
