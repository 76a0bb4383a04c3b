"""The training block on the CPU: the early stop as a device-tensor
transition against the JAX package's, and the block loop of
``train_model`` / ``build_member_train_fn`` (one validation block a body,
the stop decided and applied on the device, the host reading the
all-stopped flag one block behind) against the per-step loop it replaced,
kept here as the reference: ``Trainer.step`` / ``validate`` (and
``MemberTrainer``'s) step by step, the JAX package's early stop on the
host after each validation, a break at the stop, and for members the
entry and break-point states put back per member from the host. Params
and logs must be equal bit for bit, in runs that stop at the first block
a stop can latch at (the second validation: the first one always
improves on an infinite best), at a later block, not at all, and in a
partial last block (``n_iter`` 55 with ``val_freq`` 10), with and without
a stop in it.

Then the block body under the host-read guard of
tests/test_torch_train_graph.py, as a CUDA graph captures it, with and
without a one-rank gloo mesh: its blocks equal the eager loop's. Small
sizes (batch 16, 4 MC samples) and one intra-op thread.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpivae_tpu.utils import early_stopping as jax_es
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.train import setup_model, train_model
from dpivae_tpu_torch.train.train import (
    MemberTrainer,
    Trainer,
    build_member_train_fn,
    member_generators,
    stack_params,
)
from dpivae_tpu_torch.utils import early_stopping as es
from dpivae_tpu_torch.utils.data import sample_response

from test_torch_train_graph import _no_host_reads

CASE = get_case("simple_beam")
VAL_FREQ = 10
# patience 1 with no dead zone, a one-sample validation and 30x learning
# rates: noisy validations, so that stops latch early.
FAST = dict(patience=1, min_delta=0.0, n_mc_val=1,
            **{f"lr_{k}": 0.03 for k in ("e", "p", "dx", "dc", "dy")})


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(**over):
    base = dict(n_train=64, n_val=32, n_batch=16, n_mc_train=4, n_mc_val=4,
                n_iter=40, val_freq=VAL_FREQ, use_seed=True,
                use_pallas=True, clip_gradients=True, max_grad_norm=5.0,
                lambda_annealing="sigmoid", lambda_mu=0.3, lambda_cov=0.2)
    return TrainConfig().with_preset(CASE.presets["dpivae"]).replace(
        **{**base, **over})


def _data(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tuple(sample_response(CASE, g, n, sample_dist=CASE.gt_dist(),
                                 device="cpu")
                 for n in (cfg.n_train, cfg.n_val))


def _equal(a, b):
    return torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                       torch.nan_to_num(b.float(), nan=7.0))


# ----------------------------------------------------------------------
# The early stop on device tensors
# ----------------------------------------------------------------------

# (steps, members) validation losses: each member takes a branch at each
# step; the fifth sees a NaN (neither better nor worse: the dead zone), an
# infinity and ties with its best; the last is never worse than its best,
# so it never stops.
ES_LOSSES = np.array([
    [5.0, 1.0, 3.0, 2.0, np.nan, 5.0],
    [4.0, 1.05, 3.0, 2.5, 2.0, 4.0],
    [3.95, 1.2, 2.95, 2.5, 2.0, 4.0],
    [4.5, 0.5, 3.5, 1.0, np.inf, 3.95],
    [3.0, 0.55, 2.0, 1.01, 1.95, 3.0],
    [3.05, 0.6, 2.5, 0.5, 1.95, 3.0],
    [3.1, 0.4, 2.6, 0.45, 1.0, 2.0],
    [2.0, 0.3, 0.1, 9.0, 1.5, 1.0],
    [9.0, 0.2, 9.0, 0.1, 1.5, 0.5],
], dtype=np.float32)


@pytest.mark.parametrize("patience, min_delta", [(2, 0.1), (0, 0.0),
                                                 (1, 0.05)])
def test_tensor_early_stop_matches_jax(patience, min_delta):
    """(M,) states through every branch (improvement, the dead zone,
    worse-than-best counting up to the stop, patience 0 stopping on the
    first worse validation only, the latch) equal the JAX package's
    transition step by step."""
    m = ES_LOSSES.shape[1]
    ours = es.early_stop_init((m,))
    theirs = jax.tree.map(lambda a: jnp.broadcast_to(a, (m,)),
                          jax_es.early_stop_init())
    stopped_at = []
    for row in ES_LOSSES:
        ours = es.early_stop_update(ours, torch.from_numpy(row), patience,
                                    min_delta)
        theirs = jax_es.early_stop_update(theirs, jnp.asarray(row), patience,
                                          min_delta)
        assert ours.best.dtype == torch.float32
        assert ours.counter.dtype == torch.int32
        np.testing.assert_array_equal(ours.best.numpy(),
                                      np.asarray(theirs.best))
        np.testing.assert_array_equal(ours.counter.numpy(),
                                      np.asarray(theirs.counter))
        np.testing.assert_array_equal(ours.stopped.numpy(),
                                      np.asarray(theirs.stopped))
        stopped_at.append(ours.stopped.numpy().copy())
    stopped_at = np.array(stopped_at)
    # some members stop, one never does, and a stop stays latched
    assert stopped_at[-1].any() and not stopped_at[-1].all()
    assert (np.diff(stopped_at.astype(int), axis=0) >= 0).all()


# ----------------------------------------------------------------------
# The block loop against the per-step loop
# ----------------------------------------------------------------------

def _host_stop(state, loss, cfg):
    return jax_es.early_stop_update(state, float(loss), cfg.patience,
                                    cfg.min_delta)


def _per_step_run(cfg, params, data_train, data_val, generator):
    """The per-step loop: step, validate, the host's early stop, a break
    at the stop, the other steps of the block."""
    params = copy.deepcopy(params)
    run = Trainer(cfg, CASE, params, data_train, data_val, cfg.lambda_g0)
    n_iter, vf = cfg.n_iter, cfg.val_freq
    n_blocks = -(-n_iter // vf)
    train = torch.full((n_iter, 13), float("nan"))
    val = torch.full((n_blocks, 8), float("nan"))
    state = jax_es.early_stop_init()
    stop_iter, live_blocks = n_iter, n_blocks
    for block in range(n_blocks):
        start = block * vf
        train[start] = run.step(start, generator=generator)
        val[block] = run.validate(start, generator=generator)
        state = _host_stop(state, val[block, 0], cfg)
        if bool(state.stopped):
            stop_iter, live_blocks = start + 1, block + 1
            break
        for i in range(start + 1, min(start + vf, n_iter)):
            train[i] = run.step(i, generator=generator)
    return params, train, val, stop_iter, live_blocks


def _stop_block(val_losses, cfg):
    """The block at which the host's early stop first latches over
    ``val_losses``, or None."""
    state = jax_es.early_stop_init()
    for block, loss in enumerate(val_losses):
        state = _host_stop(state, loss, cfg)
        if bool(state.stopped):
            return block
    return None


def _stopping_in_last_block(cfg):
    """``cfg`` with a seed and an ``n_iter`` whose last block is partial
    and holds the run's stop: the per-step loop's validations over six
    blocks without a stop, then ``n_iter`` 5 steps into the block at which
    the host's stop first latches over them. The schedules are constant,
    so the run up to there does not depend on ``n_iter``. Which block a
    stop lands in rests on the last bits of the CPU's reductions, so it is
    read from the run, not fixed."""
    vf = cfg.val_freq
    for seed in range(cfg.seed, cfg.seed + 4):
        free = cfg.replace(seed=seed, patience=10 ** 9, n_iter=6 * vf)
        data_train, data_val = _data(free, seed)
        model = setup_model(free, CASE, data_train, device="cpu")
        params = model.init(torch.Generator().manual_seed(seed + 1),
                            device="cpu")
        val = _per_step_run(free, params, data_train, data_val,
                            torch.Generator().manual_seed(2))[2][:, 0]
        block = _stop_block(val, cfg)
        if block is not None:
            return cfg.replace(seed=seed, n_iter=block * vf + 5)
    raise AssertionError("no run stops within six blocks")


@pytest.mark.parametrize("over, stop", [
    (dict(n_iter=40, **FAST, seed=2), "block-1"),
    (dict(n_iter=80, **FAST, seed=0), "later"),
    (dict(n_iter=40), None),
    (dict(n_iter=55), None),
    (dict(n_iter=55, **FAST, seed=4, lambda_annealing=None), "last"),
], ids=["stop-block-1", "stop-later", "no-stop", "partial-block",
        "partial-block-stop"])
def test_block_loop_equals_per_step_loop(over, stop):
    """``stop`` is where the per-step loop's own stop lands: at block 1;
    after block 1 and before the last block; in the last block, a partial
    one (the seed and ``n_iter`` found for it, ``_stopping_in_last_block``);
    nowhere (None)."""
    cfg = _cfg(**over)
    if stop == "last":
        cfg = _stopping_in_last_block(cfg)
    data_train, data_val = _data(cfg, cfg.seed)
    model = setup_model(cfg, CASE, data_train, device="cpu")
    params = model.init(torch.Generator().manual_seed(cfg.seed + 1),
                        device="cpu")
    got_params, logs = train_model(
        cfg, model, CASE, data_train, data_val, params=params, device="cpu",
        generator=torch.Generator().manual_seed(2))
    want_params, train, val, stop_iter, live_blocks = _per_step_run(
        cfg, params, data_train, data_val, torch.Generator().manual_seed(2))
    n_blocks = -(-cfg.n_iter // cfg.val_freq)
    assert logs.stop_iter == stop_iter
    assert int(logs.val_active.sum()) == live_blocks
    stopped = stop_iter < cfg.n_iter
    if stop is None:
        assert not stopped and live_blocks == n_blocks
    elif stop == "block-1":
        assert stopped and live_blocks == 2
    elif stop == "later":
        assert stopped and 2 < live_blocks < n_blocks
    else:
        assert cfg.n_iter % cfg.val_freq
        assert stopped and live_blocks == n_blocks
    assert _equal(logs.train, train) and _equal(logs.val, val)
    assert torch.equal(logs.train_active, torch.arange(cfg.n_iter)
                       < stop_iter)
    assert torch.equal(logs.val_iters, torch.arange(n_blocks) * VAL_FREQ)
    for a, b in zip(got_params.state_dict().values(),
                    want_params.state_dict().values()):
        assert torch.equal(a, b)


def _members_setup(cfg, ids):
    data = [_data(cfg, seed) for seed in ids]
    stack = lambda k: tuple(torch.stack([d[k][c] for d in data])
                            for c in range(3))
    template = setup_model(cfg, CASE, data[0][0], device="cpu")
    params = stack_params([template.init(torch.Generator().manual_seed(i),
                                         device="cpu") for i in ids])
    return params, stack(0), stack(1)


def _per_step_members(cfg, params, data_train, data_val, lambdas, gens):
    """The per-step member loop: the host reads the (M,) losses after
    each validation, runs each member's early stop, and puts the entry
    and break-point states back for the members that need them."""
    run = MemberTrainer(cfg, CASE, params, data_train, data_val, lambdas)
    m, n_iter, vf = run.n_members, cfg.n_iter, cfg.val_freq
    n_blocks = -(-n_iter // vf)
    train = torch.full((m, n_iter, 13), float("nan"))
    val = torch.full((m, n_blocks, 8), float("nan"))
    states = [jax_es.early_stop_init() for _ in range(m)]
    stop_iter, live = np.full(m, n_iter), np.full(m, n_blocks)
    for block in range(n_blocks):
        entry_stopped = np.array([bool(s.stopped) for s in states])
        if entry_stopped.all():
            break
        entry = run.optimizer.state()
        start = block * vf
        train[:, start] = run.step(start, generators=gens)
        val[:, block] = run.validate(start, generators=gens)
        states = [_host_stop(s, v, cfg) for s, v in zip(states,
                                                         val[:, block, 0])]
        here = np.array([bool(s.stopped) for s in states]) & ~entry_stopped
        mid = run.optimizer.state()
        for i in range(start + 1, min(start + vf, n_iter)):
            train[:, i] = run.step(i, generators=gens)
        run.optimizer.restore(torch.from_numpy(here), mid)
        run.optimizer.restore(torch.from_numpy(entry_stopped), entry)
        stop_iter[here], live[here] = start + 1, block + 1
    train_active = torch.arange(n_iter) < torch.from_numpy(stop_iter)[:, None]
    val_active = torch.arange(n_blocks) < torch.from_numpy(live)[:, None]
    train[~train_active] = float("nan")
    val[~val_active] = float("nan")
    return run.params, train, val, train_active, val_active


@pytest.mark.parametrize("over, all_stop", [
    (dict(n_iter=55, **FAST, seed=3), False),
    (dict(n_iter=80, **FAST, seed=7), True),
], ids=["partial-block", "all-stop"])
def test_member_block_loop_equals_per_step_loop(over, all_stop):
    """Four members that stop at their own blocks (one in the partial last
    block, whose later steps are masked) or run on; in the second case
    every member stops by block 4 of 8, and the loop ends one block after
    the last stop."""
    cfg = _cfg(**over)
    ids = [cfg.seed + i for i in range(4)]
    params, data_train, data_val = _members_setup(cfg, ids)
    lambdas = torch.tensor([0.0, 0.01, -0.02, 0.1])
    got_params, logs = build_member_train_fn(cfg, CASE)(
        params, member_generators(5, ids, "cpu"), data_train, data_val,
        lambdas)
    want_params, train, val, train_active, val_active = _per_step_members(
        cfg, params, data_train, data_val, lambdas,
        member_generators(5, ids, "cpu"))
    assert torch.equal(logs.train_active, train_active)
    assert torch.equal(logs.val_active, val_active)
    assert _equal(logs.train, train) and _equal(logs.val, val)
    for k in got_params:
        assert torch.equal(got_params[k], want_params[k]), k
    stops = logs.train_active.sum(dim=1)
    assert len(set(stops.tolist())) > 2
    assert bool((stops < cfg.n_iter).all()) == all_stop


# ----------------------------------------------------------------------
# The block body reads no host value
# ----------------------------------------------------------------------

@pytest.fixture(params=[False, True], ids=["no-mesh", "one-rank-mesh"])
def mesh(request):
    if not request.param:
        yield None
        return
    from dpivae_tpu_torch.parallel import make_mesh

    mesh = make_mesh(1, ("dp",), device="cpu")
    yield mesh
    mesh.close()


@pytest.mark.parametrize("members", [False, True], ids=["run", "members"])
def test_block_body_reads_no_host_value(monkeypatch, mesh, members):
    """Blocks 1 and 2 of an annealed run (a stop latching in block 1) run
    under the guard, after an eager block 0, as a graph replays them; the
    logs and params equal a twin trainer's blocks run without it."""
    cfg = _cfg(n_iter=25, **FAST, seed=2)
    if members:
        ids = [0, 1]
        params, data_train, data_val = _members_setup(cfg, ids)
        lambdas = torch.tensor([0.0, 0.05])
        runs = [MemberTrainer(cfg, CASE, params, data_train, data_val,
                              lambdas, mesh=mesh) for _ in range(2)]
        gens = [member_generators(5, ids, "cpu") for _ in range(2)]
        bodies = [lambda r=r, g=g: r.block_body(g)
                  for r, g in zip(runs, gens)]
    else:
        data_train, data_val = _data(cfg, cfg.seed)
        model = setup_model(cfg, CASE, data_train, device="cpu")
        params = model.init(torch.Generator().manual_seed(cfg.seed + 1),
                            device="cpu")
        runs = [Trainer(cfg, CASE, copy.deepcopy(params), data_train,
                        data_val, cfg.lambda_g0, mesh=mesh)
                for _ in range(2)]
        gens = [torch.Generator().manual_seed(2) for _ in range(2)]
        bodies = [lambda r=r, g=g: r.block_body(g)
                  for r, g in zip(runs, gens)]
    for block in range(runs[0].n_blocks):
        for k, (run, body) in enumerate(zip(runs, bodies)):
            run.block_t.fill_(block)
            if k == 0 and block > 0:
                with _no_host_reads(monkeypatch):
                    body()
            else:
                body()
    for a, b in zip(runs[0].logs(), runs[1].logs()):
        assert _equal(a, b)
    if not members:
        assert int(runs[0].stop_block) == 1
    state = lambda r: (r.optimizer.state() if members
                       else r.params.state_dict().values())
    for a, b in zip(state(runs[0]), state(runs[1])):
        assert torch.equal(a, b)
