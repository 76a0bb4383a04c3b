"""The port's member-batched training against the JAX package, on the CPU:
each member of a sweep step against JAX's per-member ``jax.grad`` and
optimizer update (a λ sweep and a hyperparameter sweep on simple_beam,
and λ sweeps of the transfer study's bridge presets, the P model
"DPIVAE-A" and the S model "DPIVAE-B"), the per-member
gradient clip against ``optax.clip_by_global_norm``, and ``vmap(grad)``
through ``FusedMLPFunction`` and the GRL against a per-member loop.

Small sizes: 3 members, batch 16, 4 MC samples, n_train 64, at the
presets' full widths; simple_beam/dpivae is the case of the single-run
parity tests
(tests/test_torch_port_train.py holds its steps to the same tolerances;
damped_oscillator's members are held against the port's single runs in
tests/test_torch_sweep_io.py and on the card).
Each member's data are JAX's ``member_datasets`` of its key, its init
``template.init(k_init)``, carried over by ``params_from_jax``; the
encoder noise is JAX's, replayed (as in tests/test_torch_port_train.py;
for the P model the three encoders' draws, as in
tests/test_torch_port_pmodel_train.py).
No JAX sweep runs here (it compiles for tens of seconds): the JAX side of
a member's step is ``jax.grad`` of its loss and its optimizer's update.

Tolerances as in tests/test_torch_port_train.py: losses rtol/atol 1e-4,
gradients rtol 5e-4 / atol 1e-6, params after three Adam steps rtol/atol
1e-5, every element on simple_beam. On bridge an element whose first
gradient is nonzero but at most 1e-7 (a few cancelled sums, about Adam's
eps of 1e-8) is held to Adam's own step instead: there the normalised
first update g / (|g| + eps) turns last-bit differences of g into
differences of the order of the learning rate (bridge / "DPIVAE-B": one
weight of 1,280, g 6.8e-9 here and 8.2e-9 in JAX, 4.8e-5 apart after the
update). Each side moves such an element by at most its group's learning
rate a step, so the two lie within 2 x steps x lr; these elements are
counted, at most 1 % of a tensor or 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dpivae_tpu.cases import get_case as jax_get_case
from dpivae_tpu.config import TrainConfig as JaxTrainConfig
from dpivae_tpu.sweep.sweep import member_datasets as jax_member_datasets
from dpivae_tpu.train.optim import make_optimizer as jax_make_optimizer
from dpivae_tpu.train.setup import make_template_model as jax_template_model
from dpivae_tpu.train.setup import setup_model as jax_setup_model
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.convert import params_from_jax, state_dict_from_jax
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.ops.gradrev import grad_reverse
from dpivae_tpu_torch.train import TRAIN_COLUMNS
from dpivae_tpu_torch.train.optim import MemberAdam
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.train.train import MemberTrainer, stack_params

CASE = "simple_beam"
M, N_TRAIN, N_VAL, B, N = 3, 64, 32, 16, 4
LAMBDAS = np.array([-0.5, 1 / 128, 1.0], np.float32)
LOSS_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 5e-4, 1e-6
PARAM_TOL = 1e-5
# On bridge, nonzero first-step gradients at or below this are too close
# to Adam's eps (1e-8) for the params after the update to be held to
# PARAM_TOL; they are held to Adam's step bound.
ADAM_SENSITIVE = 1e-7
STEPS = 3
HYPER = {
    "lr_e": [1e-3, 3e-3, 5e-4],
    "wd_dx": [0.0, 0.01, 0.05],
    "beta_x0": [1.0, 0.5, 2.0],
    "alpha_y": [1.0, 1.5, 0.7],
    "max_grad_norm": [0.05, 1.0, 100.0],
}


def _configs(case_name=CASE, preset="dpivae", **over):
    over = dict(n_train=N_TRAIN, n_val=N_VAL, n_batch=B, n_mc_train=N,
                n_mc_val=N, use_seed=True, use_pallas=True, **over)
    jcase = jax_get_case(case_name)
    jcfg = JaxTrainConfig().with_preset(jcase.presets[preset]).replace(
        **over)
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(**over)
    return jcase, jcfg, case, cfg


def _members(jcase, jcfg, case, cfg):
    """Per member (JAX): its datasets, init and fitted model, from its key;
    and the port's stacked params and datasets of the same numbers."""
    template = make_template_model(cfg, case, device="cpu")
    jax_members, params, data = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(7), M):
        dtr, dva = jax_member_datasets(jcfg, jcase, key)
        dtr, dva = (tuple(np.asarray(a) for a in d[:3]) for d in (dtr, dva))
        _, _, k_init, _ = jax.random.split(key, 4)
        jparams = jax_template_model(jcfg, jcase).init(k_init)
        jax_members.append((dtr, jax_setup_model(jcfg, jcase, dtr), jparams))
        params.append(params_from_jax(template, jax.tree.map(np.asarray,
                                                               jparams),
                                      device="cpu"))
        data.append((dtr, dva))
    stack = lambda k: tuple(torch.from_numpy(np.stack([d[k][i] for d in data]))
                            for i in range(3))
    return jax_members, stack_params(params), stack(0), stack(1)


def _replayed_eps(key, model, n, batch):
    """The encoder normals JAX's DPIVAE.loss draws from ``key``: one joint
    draw for S; for P one per encoder, joined x, c, y."""
    k_enc, _ = jax.random.split(key)
    draw = lambda k, d: np.asarray(jax.random.normal(k, (n, batch, d)))
    if model.model_type == "S":
        return draw(k_enc, model.nz_x + model.nz_c + model.nz_y)
    k_x, k_c, k_y = jax.random.split(k_enc, 3)
    return np.concatenate([draw(k_x, model.nz_x), draw(k_c, model.nz_c),
                           draw(k_y, model.nz_y)], -1)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(
        np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
        np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("case_name, preset, hyper", [
    pytest.param(CASE, "dpivae", False, id="lambda"),
    pytest.param(CASE, "dpivae", True, id="hyper"),
    pytest.param("bridge", "DPIVAE-A", False, id="bridge-DPIVAE-A"),
    pytest.param("bridge", "DPIVAE-B", False, id="bridge-DPIVAE-B"),
])
def test_member_steps_match_jax(case_name, preset, hyper):
    """Three steps of every member: loss and gradients at the first step,
    the log rows' loss at each, and the params after the third, against
    JAX's per-member grad and optimizer (with ``overlay`` for a hyper
    sweep: lr, weight decay, β, α and the clip norm per member). bridge's
    P model covers the three encoder draws and the per-block optimizer
    groups (lr_ex, lr_ec, lr_ey), both presets bridge's physical
    covariate joined to z_x and the frozen-MLP physics under vmap."""
    over = dict(clip_gradients=True) if hyper else {}
    jcase, jcfg, case, cfg = _configs(case_name, preset, **over)
    jax_members, params, data_train, data_val = _members(jcase, jcfg, case,
                                                         cfg)
    hyper_cols = ({k: torch.tensor(v, dtype=torch.float32)
                   for k, v in HYPER.items()} if hyper else None)
    run = MemberTrainer(cfg, case, params, data_train, data_val,
                        torch.from_numpy(LAMBDAS), hyper_cols)
    denom = B * (case.nd_x + case.nd_y + case.nd_c)
    overlays = [{k: float(np.float32(v[m])) for k, v in HYPER.items()}
                if hyper else {} for m in range(M)]
    states = []
    for m, (_, _, jparams) in enumerate(jax_members):
        tx = jax_make_optimizer(jcfg, jparams, overlays[m] or None)
        states.append([tx, tx.init(jparams), jparams])

    rng = np.random.default_rng(4)
    first_grads = []
    for step in range(STEPS):
        idx = np.stack([rng.choice(N_TRAIN, B, replace=False)
                        for _ in range(M)])
        keys = [jax.random.PRNGKey(100 + 10 * m + step) for m in range(M)]
        eps = np.stack([_replayed_eps(k, run.template, N, B) for k in keys])
        seam = dict(batch_idx=torch.from_numpy(idx),
                    noise={"z": torch.from_numpy(eps)})
        if step == 0:
            comps, grads = run.grads(step, **seam)
        rows = run.step(step, **seam)
        assert rows.shape == (M, len(TRAIN_COLUMNS))
        for m, ((dtr, jmodel, _), state) in enumerate(zip(jax_members,
                                                          states)):
            ov = lambda f: overlays[m].get(f, getattr(jcfg, f))
            x, c, y = (jnp.asarray(a[idx[m]]) for a in dtr)

            def scalar(p):
                out = jmodel.loss(
                    p, keys[m], x, c, y, n=N, beta_x=ov("beta_x0"),
                    beta_c=ov("beta_c0"), beta_y=ov("beta_y0"),
                    alpha_x=ov("alpha_x"), alpha_c=ov("alpha_c"),
                    alpha_y=ov("alpha_y"), grl_alpha=float(LAMBDAS[m]))
                return jnp.sum(out[0]) / denom

            tx, opt_state, jparams = state
            value, jgrads = jax.value_and_grad(scalar)(jparams)
            _close(rows[m, 0], value, LOSS_TOL, LOSS_TOL, f"member {m}")
            if step == 0:
                _close(comps[m, 0], value, LOSS_TOL, LOSS_TOL)
                want = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
                first_grads.append(want)
                assert set(grads) == set(want)
                for name, w in want.items():
                    _close(grads[name][m], w, GRAD_RTOL, GRAD_ATOL,
                           f"member {m} {name}")
            updates, opt_state = tx.update(jgrads, opt_state, jparams)
            state[1:] = [opt_state,
                         jax.tree.map(lambda p, u: p + u, jparams, updates)]
    # Each param's learning rate, from the optimizer's flat (M, P) layout
    opt = run.optimizer
    offsets = np.cumsum([0] + [run.params[k][0].numel() for k in opt.names])
    start = dict(zip(opt.names, offsets[:-1]))
    for m, (_, _, jparams) in enumerate(states):
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
        _close(rows[m, -1], np.exp(np.asarray(jparams["log_sigma_x"])),
               1e-6, 0)


@pytest.mark.parametrize("max_norm", [0.5, 2.0, 100.0])
def test_member_clip_matches_optax_per_member(max_norm):
    """Each member's gradients scale by its own global norm; a member
    whose norm is under its limit keeps its gradients exactly."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (5,), "log_sigma_x": ()}
    scales = (0.05, 0.3, 3.0)
    grads = {k: np.stack([rng.standard_normal(s).astype(np.float32) * sc
                          for sc in scales]) for k, s in shapes.items()}
    cfg = TrainConfig(clip_gradients=True, max_grad_norm=max_norm)
    opt = MemberAdam.__new__(MemberAdam)
    opt.names, opt.n_members = list(shapes), len(scales)
    opt.max_norm = torch.full((len(scales),), cfg.max_grad_norm)
    got = opt.clip(opt.flat_grads({k: torch.from_numpy(v)
                                   for k, v in grads.items()}))
    for m in range(len(scales)):
        member = [jnp.asarray(grads[k][m]) for k in shapes]
        want, _ = optax.clip_by_global_norm(max_norm).update(
            member, optax.EmptyState())
        want = np.concatenate([np.asarray(w).reshape(-1) for w in want])
        _close(got[m], want, 1e-6, 1e-7, f"member {m}")
        norm = np.sqrt(sum((np.asarray(g, np.float64) ** 2).sum()
                           for g in member))
        if norm < max_norm:
            assert np.array_equal(got[m].numpy(), np.concatenate(
                [np.asarray(g).reshape(-1) for g in member]))


def test_member_adam_equals_torch_adam_for_equal_members():
    """With every member's hyperparameters the config's, each member's
    update is the grouped torch.optim.Adam's (weight decay included)."""
    _, _, case, cfg = _configs(wd_e=0.01, lr_dx=3e-3)
    template = make_template_model(cfg, case, device="cpu")
    g = torch.Generator().manual_seed(0)
    members = [template.init(g, device="cpu") for _ in range(2)]
    opt = MemberAdam(cfg, stack_params(members))
    from dpivae_tpu_torch.train import make_optimizer

    singles = [make_optimizer(cfg, p) for p in members]
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g)
                 for k, v in opt.params.items()}
        opt.step(grads)
        for m, (p, o) in enumerate(zip(members, singles)):
            for name, t in p.named_parameters():
                t.grad = grads[name][m].clone()
            o.step()
    for m, p in enumerate(members):
        for name, t in p.named_parameters():
            torch.testing.assert_close(opt.params[name][m], t.detach(),
                                       rtol=1e-6, atol=1e-7)


def test_vmap_grad_runs_each_vmap_rule_once(monkeypatch):
    """vmap(grad) through the GRL (a per-member λ) and FusedMLPFunction on
    the CPU: gradients equal a per-member loop of plain autograd, and the
    forward's and the hidden recompute's vmap rules each run once for all
    members (one batched call, a launch on the card)."""
    calls = {"forward": 0, "hidden": 0}
    for name, cls in (("forward", ops.FusedMLPFunction),
                      ("hidden", ops.FusedMLPHidden)):
        rule = cls.vmap

        def counted(*args, rule=rule, name=name):
            calls[name] += 1
            return rule(*args)

        monkeypatch.setattr(cls, "vmap", staticmethod(counted))
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    # damped_oscillator's data branch, 8 -> 128 -> 64
    x, w0, b0, w1, b1 = r(M, 64, 8), r(M, 128, 8) * 0.3, r(M, 128) * 0.1, \
        r(M, 64, 128) * 0.3, r(M, 64) * 0.1
    lam = torch.from_numpy(LAMBDAS)

    def loss(x, w0, b0, w1, b1, lam):
        return torch.sum(ops.fused_mlp(grad_reverse(x, lam), w0, b0, w1,
                                       b1) ** 2)

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        x, w0, b0, w1, b1, lam)
    assert calls == {"forward": 1, "hidden": 1}
    for m in range(M):
        leaves = [a[m].clone().requires_grad_() for a in (x, w0, b0, w1, b1)]
        y = ops.fused_mlp_reference(grad_reverse(leaves[0], float(lam[m])),
                                    *leaves[1:])
        want = torch.autograd.grad(torch.sum(y ** 2), leaves)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[m], b, rtol=1e-5, atol=1e-5)
    # The batched plain version is the per-member one, stacked
    torch.testing.assert_close(
        ops.fused_mlp_reference(x, w0, b0, w1, b1),
        torch.stack([ops.fused_mlp_reference(x[m], w0[m], b0[m], w1[m],
                                             b1[m]) for m in range(M)]),
        rtol=1e-6, atol=1e-6)
