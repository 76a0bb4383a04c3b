"""The graphed training loop's CPU-side contract: how ``cuda_graph``
resolves, that the bodies a CUDA graph captures read no host value, and
the optimizers' device step counts.

A CUDA graph bakes every value the host hands a captured body, so the
train step and validation bodies of ``Trainer`` and ``MemberTrainer`` must
read the step index, the schedule row and Adam's step count from device
tensors. Here they run on the CPU under a guard that makes every host read
of a tensor (``item``, ``tolist``, ``float``/``int``/``bool``, ``cpu``,
``numpy``) and every tensor made from host data raise, with annealed
schedules (sigmoid λ, cyclical β_x) so that a baked row would show, and
their rows must equal the Python-index path's: the schedule row read on
the host and handed to the loss as Python floats. Both models: S
(simple_beam / "dpivae") and P with a physical covariate (bridge /
"DPIVAE-A"). The validation block built of those bodies runs under the
same guard in tests/test_torch_train_block.py. The graphed loop's order
(an eager first block, then the block body captured once and replayed
for every later block, the one after a stop included) is checked
against the eager loop with stand-in graphs that run their bodies
eagerly: the same rows, params and generator state. Small sizes: batch
16, 4 MC samples. The graph-against-eager comparison itself needs the
card (tests/test_torch_train_graph_cuda.py).
"""

import contextlib
import copy
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.train import setup_model, train_model
from dpivae_tpu_torch.train.graph import resolve_cuda_graph
from dpivae_tpu_torch.train.optim import MemberAdam, clip_grad_global_norm_
from dpivae_tpu_torch.train.train import (
    MemberTrainer,
    Trainer,
    _sample_batch,
    build_member_train_fn,
    member_generators,
    stack_params,
)
from dpivae_tpu_torch.utils.data import sample_response

CASE = get_case("simple_beam")
# The two models: S (simple_beam) and P with a physical covariate joined
# to z_x (bridge / "DPIVAE-A", idx_c_phys).
MODELS = [("simple_beam", "dpivae"), ("bridge", "DPIVAE-A")]
N_ITER, VAL_FREQ = 40, 10
ANNEALED = dict(lambda_annealing="sigmoid", lambda_mu=0.3, lambda_cov=0.2,
                beta_x_annealing="cyclical", beta_x_n_cycles=2, beta_x_R=0.4)
ADAM_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: at these sizes it is the fastest, and it keeps
    the suite's parallel workers from oversubscribing the host's cores
    (the many small ops of a training loop each spin up a thread team)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(case=CASE, preset="dpivae", **over):
    over = {**dict(n_train=64, n_val=32, n_batch=16, n_mc_train=4,
                   n_mc_val=4, n_iter=N_ITER, val_freq=VAL_FREQ,
                   use_seed=True, use_pallas=True, clip_gradients=True,
                   max_grad_norm=5.0), **ANNEALED, **over}
    return TrainConfig().with_preset(case.presets[preset]).replace(**over)


def _data(cfg, seed=0, case=CASE):
    g = torch.Generator().manual_seed(seed)
    data_train = sample_response(case, g, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cpu")
    data_val = sample_response(case, g, cfg.n_val,
                               sample_dist=case.gt_dist(), device="cpu")
    return data_train, data_val


# ----------------------------------------------------------------------
# cuda_graph resolution
# ----------------------------------------------------------------------

_MESH = types.SimpleNamespace(device=torch.device("cpu"))


@pytest.mark.parametrize("cuda_graph, device, mesh, want", [
    ("auto", "cpu", None, False),
    ("auto", "cuda", None, True),
    ("auto", "cuda", _MESH, True),
    ("auto", "cpu", _MESH, False),
    (False, "cuda", None, False),
    (False, "cpu", _MESH, False),
    (True, "cuda", None, True),
    (True, "cuda", _MESH, True),
    ("auto", None, _MESH, False),
])
def test_cuda_graph_resolves(cuda_graph, device, mesh, want):
    """A mesh graphs as a run without one does; with no device given (a
    trainer's check when it is built) the mesh's device is read."""
    device = None if device is None else torch.device(device)
    assert resolve_cuda_graph(cuda_graph, device, mesh) is want


@pytest.mark.parametrize("cuda_graph, device, mesh, match", [
    (True, "cpu", None, "needs a CUDA device"),
    (True, None, _MESH, "needs a CUDA device"),
    ("yes", "cuda", None, "must be True, False or 'auto'"),
])
def test_cuda_graph_refuses(cuda_graph, device, mesh, match):
    device = None if device is None else torch.device(device)
    with pytest.raises(ValueError, match=match):
        resolve_cuda_graph(cuda_graph, device, mesh)


def test_cuda_graph_true_raises_on_the_cpu_and_with_a_mesh():
    """True raises in every trainer that takes it on CPU params."""
    cfg = _cfg(n_iter=2)
    data_train, data_val = _data(cfg)
    model = setup_model(cfg, CASE, data_train, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        train_model(cfg, model, CASE, data_train, data_val, device="cpu",
                    cuda_graph=True)
    gens = member_generators(0, [0, 1], "cpu")
    params = stack_params([model.init(g, device="cpu") for g in gens])
    stack = lambda d: tuple(torch.stack([a, a]) for a in d[:3])
    fn = build_member_train_fn(cfg, CASE, cuda_graph=True)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        fn(params, gens, stack(data_train), stack(data_val),
           torch.tensor([0.0, 0.1]))


# ----------------------------------------------------------------------
# The bodies read no host value
# ----------------------------------------------------------------------

def _raiser(name):
    def raise_(*args, **kwargs):
        raise AssertionError(f"a captured body called {name}")
    return raise_


class _NoHostTraffic(TorchDispatchMode):
    """Raises on ``aten.lift_fresh`` (a tensor made from host data, by
    ``torch.tensor`` or by indexing with a Python list: on the card a copy
    from the host, which a CUDA graph cannot capture) and on
    ``aten._local_scalar_dense`` (a value read to the host, from Python or
    from C++)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.lift_fresh.default,
                    torch.ops.aten.lift_fresh_copy.default,
                    torch.ops.aten._local_scalar_dense.default):
            raise AssertionError(f"a captured body called {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every read of a tensor's value into Python, and every tensor made
    from host data (a copy to the device under capture), raises."""
    for name in ("item", "tolist", "__float__", "__int__", "__bool__", "cpu",
                 "numpy"):
        monkeypatch.setattr(torch.Tensor, name, _raiser(f"Tensor.{name}"))
    as_tensor = torch.as_tensor

    def guarded_as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise AssertionError("a captured body made a tensor from host "
                                 "data")
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", guarded_as_tensor)
    monkeypatch.setattr(torch, "tensor", _raiser("torch.tensor"))
    monkeypatch.setattr(torch, "from_numpy", _raiser("torch.from_numpy"))
    try:
        with _NoHostTraffic():
            yield
    finally:
        monkeypatch.undo()


def _host_index_step(run, i, generator):
    """The Python-index path: ``Trainer.step`` with the schedule row read
    on the host and handed to the loss as Python floats."""
    cfg = run.config
    lam, bx, bc, by = run.schedule[i].tolist()
    batch_idx = _sample_batch(generator, cfg.n_train, cfg.n_batch, run.device)
    batch = tuple(a[batch_idx] for a in run.data_train)
    run.optimizer.zero_grad(set_to_none=True)
    out = run.model.loss(run.params, *batch, n=cfg.n_mc_train, beta_x=bx,
                         beta_c=bc, beta_y=by, alpha_x=cfg.alpha_x,
                         alpha_c=cfg.alpha_c, alpha_y=cfg.alpha_y,
                         grl_alpha=lam, generator=generator)
    comps = torch.sum(torch.stack(out), dim=1) / run._div_train
    comps[0].backward()
    clip_grad_global_norm_(run.params.parameters(), cfg.max_grad_norm)
    run.optimizer.step()
    sigma_x = torch.exp(run.params.log_sigma_x.detach()).reshape(1)
    return torch.cat([comps.detach(), run.schedule[i], sigma_x])


def _host_index_validate(run, i, generator):
    cfg = run.config
    lam, bx, bc, by = run.schedule[i].tolist()
    with torch.no_grad():
        out = run.model.loss(run.params, *run.data_val, n=cfg.n_mc_val,
                             beta_x=bx, beta_c=bc, beta_y=by,
                             alpha_x=cfg.alpha_x, alpha_c=cfg.alpha_c,
                             alpha_y=cfg.alpha_y, grl_alpha=lam,
                             generator=generator)
    return torch.sum(torch.stack(out), dim=1) / run._div_val


@pytest.mark.parametrize("case_name, preset", MODELS)
def test_trainer_bodies_read_no_host_value(monkeypatch, case_name, preset):
    """``step_body`` and ``validate_body`` under the guard, at every step
    of an annealed run, equal the Python-index path from the same state
    and generator; the schedule rows they log change along the run."""
    case = get_case(case_name)
    cfg = _cfg(case, preset)
    data_train, data_val = _data(cfg, case=case)
    model = setup_model(cfg, case, data_train, device="cpu")
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    runs = [Trainer(cfg, case, copy.deepcopy(params), data_train, data_val,
                    cfg.lambda_g0) for _ in range(2)]
    gens = [torch.Generator().manual_seed(2) for _ in range(2)]
    # Adam's state is made at the first step, as the eager first block
    # makes it before any capture.
    runs[0].step(0, generator=gens[0])
    _host_index_step(runs[1], 0, gens[1])
    rows, want = [], []
    for i in range(1, N_ITER):
        runs[0].step_t.fill_(i)
        with _no_host_reads(monkeypatch):
            rows.append(runs[0].step_body(gens[0]))
            if i % VAL_FREQ == 0:
                rows.append(runs[0].validate_body(gens[0]))
        want.append(_host_index_step(runs[1], i, gens[1]))
        if i % VAL_FREQ == 0:
            want.append(_host_index_validate(runs[1], i, gens[1]))
    for got, ref in zip(rows, want):
        assert torch.equal(got, ref)
    for a, b in zip(runs[0].params.parameters(), runs[1].params.parameters()):
        assert torch.equal(a, b)
    sched = torch.stack([r for r in rows if r.shape[0] == 13])[:, 8:10]
    assert len(torch.unique(sched[:, 0])) > 10
    assert len(torch.unique(sched[:, 1])) > 5


@pytest.mark.parametrize("case_name, preset", MODELS)
def test_member_bodies_read_no_host_value(monkeypatch, case_name, preset):
    """``MemberTrainer.step_body`` and ``validate_body`` under the guard
    equal the Python-index path (the schedule column picked on the host)
    for 3 members, each with its own generator."""
    case = get_case(case_name)
    cfg = _cfg(case, preset)
    ids = [0, 1, 2]
    gens = member_generators(5, ids, "cpu")
    ref_gens = member_generators(5, ids, "cpu")
    data = [_data(cfg, seed, case) for seed in ids]
    stack = lambda k: tuple(torch.stack([d[k][c] for d in data])
                            for c in range(3))
    template = setup_model(cfg, case, data[0][0], device="cpu")
    params = stack_params([template.init(torch.Generator().manual_seed(i),
                                         device="cpu") for i in ids])
    lambdas = torch.tensor([0.0, 0.01, -0.02])
    runs = [MemberTrainer(cfg, case, params, stack(0), stack(1), lambdas)
            for _ in range(2)]
    runs[0].step(0, generators=gens)
    runs[1].step(0, generators=ref_gens)
    for i in range(1, 2 * VAL_FREQ + 1):
        runs[0].step_t.fill_(i)
        with _no_host_reads(monkeypatch):
            got = runs[0].step_body(gens)
            got_val = (runs[0].validate_body(gens) if i % VAL_FREQ == 0
                       else None)
        sched = runs[1].schedule[:, i]
        comps, grads = runs[1]._grads(sched, ref_gens, None, None)
        runs[1].optimizer.step(grads)
        sigma_x = torch.exp(runs[1].params["log_sigma_x"]).reshape(-1, 1)
        assert torch.equal(got, torch.cat([comps, sched, sigma_x], dim=1))
        if got_val is not None:
            assert torch.equal(got_val, runs[1].validate(i,
                                                         generators=ref_gens))
    for k in runs[0].params:
        assert torch.equal(runs[0].params[k], runs[1].params[k]), k


# ----------------------------------------------------------------------
# MemberAdam's device step count
# ----------------------------------------------------------------------

def test_member_adam_matches_torch_adam_per_member():
    """Five steps of ``MemberAdam`` (per-member learning rates and weight
    decays, the step count and bias corrections on the device) against
    one ``torch.optim.Adam`` per member with that member's values."""
    rng = np.random.default_rng(0)
    shapes = {"encoder.w": (4, 3), "decoder_x.b": (5,), "log_sigma_x": ()}
    m = 3
    hyper = {"lr_e": [1e-3, 3e-3, 1e-2], "wd_e": [0.0, 0.01, 0.1],
             "lr_dx": [2e-3, 1e-3, 5e-4], "lr_sigma": [1e-3, 1e-2, 1e-1]}
    cfg = TrainConfig(clip_gradients=False, wd_dx=0.02)
    start = {k: torch.from_numpy(rng.standard_normal((m, *s))
                                 .astype(np.float32))
             for k, s in shapes.items()}
    opt = MemberAdam(cfg, start, {k: torch.tensor(v)
                                  for k, v in hyper.items()})
    assert opt.t.device == start["encoder.w"].device and opt.t.dim() == 0
    refs = []
    for i in range(m):
        ps = {k: v[i].clone().requires_grad_(True) for k, v in start.items()}
        groups = [dict(params=[ps["encoder.w"]], lr=hyper["lr_e"][i],
                       weight_decay=hyper["wd_e"][i]),
                  dict(params=[ps["decoder_x.b"]], lr=hyper["lr_dx"][i],
                       weight_decay=cfg.wd_dx),
                  dict(params=[ps["log_sigma_x"]], lr=hyper["lr_sigma"][i],
                       weight_decay=cfg.wd_sigma)]
        refs.append((ps, torch.optim.Adam(groups, betas=(0.9, 0.999),
                                          eps=1e-8)))
    for _ in range(5):
        grads = {k: torch.from_numpy(rng.standard_normal((m, *s))
                                     .astype(np.float32))
                 for k, s in shapes.items()}
        opt.step(grads)
        for i, (ps, ref) in enumerate(refs):
            for k, p in ps.items():
                p.grad = grads[k][i].clone()
            ref.step()
    assert float(opt.t) == 5.0
    for i, (ps, _) in enumerate(refs):
        for k, p in ps.items():
            np.testing.assert_allclose(opt.params[k][i].numpy(),
                                       p.detach().numpy(), rtol=ADAM_TOL,
                                       atol=ADAM_TOL, err_msg=f"{i} {k}")


# ----------------------------------------------------------------------
# The graphed loop's order, with replays run eagerly
# ----------------------------------------------------------------------

class _EagerGraph:
    """Stands in for ``train.graph.Graphed`` on the CPU: "replays" call
    the body, so the graphed loop's order (an eager first block, then the
    block body at the index in ``block_t``) runs without a card."""

    made = []

    def __init__(self, body, generators, stream):
        self.body, self.replays = body, 0
        _EagerGraph.made.append(self)

    def replay(self):
        self.replays += 1
        return self.body()


@pytest.fixture
def eager_graphs(monkeypatch):
    from dpivae_tpu_torch.train import train as train_mod

    _EagerGraph.made = []
    monkeypatch.setattr(train_mod, "Graphed", _EagerGraph)
    monkeypatch.setattr(train_mod, "SideStream",
                        lambda device: contextlib.nullcontext())
    return train_mod


def _blocks_run(logs, cfg):
    """The blocks the loop launched: every block, or the stop block and
    the one after it (the host reads the stop one block behind)."""
    n_blocks = -(-cfg.n_iter // cfg.val_freq)
    live = logs.val_active.reshape(-1, n_blocks).sum(dim=1)
    if bool((live == n_blocks).any()):
        return n_blocks
    return min(int(live.max()) + 1, n_blocks)


@pytest.mark.parametrize("over", [
    dict(n_iter=55),
    dict(n_iter=8),
    dict(n_iter=200, patience=1, min_delta=0.0, n_mc_val=1,
         **{f"lr_{k}": 0.01 for k in ("e", "p", "dx", "dc", "dy")}),
], ids=["partial-block", "one-block", "early-stop"])
def test_graphed_loop_order_equals_eager(eager_graphs, monkeypatch, over):
    """The single run's graphed loop (replays run eagerly here) gives the
    eager loop's rows, params and stop: the block body captured once
    after block 0, replayed for every later block, the block after the
    stop included."""
    cfg = _cfg(**over)
    data_train, data_val = _data(cfg)
    model = setup_model(cfg, CASE, data_train, device="cpu")
    params = model.init(torch.Generator().manual_seed(1), device="cpu")

    def run(graphed):
        monkeypatch.setattr(eager_graphs, "resolve_cuda_graph",
                            lambda *a: graphed)
        g = torch.Generator().manual_seed(2)
        out = train_model(cfg, model, CASE, data_train, data_val,
                          params=params, device="cpu", generator=g)
        return out, g.get_state()

    ((p_graph, logs), g_graph), ((p_eager, want), g_eager) = (run(True),
                                                             run(False))
    for a, b in zip(logs, want):
        assert torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                           torch.nan_to_num(b.float(), nan=7.0))
    for a, b in zip(p_graph.parameters(), p_eager.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(g_graph, g_eager)
    ran = _blocks_run(logs, cfg)
    if ran == 1:
        assert _EagerGraph.made == []
    else:
        (graph,) = _EagerGraph.made
        assert graph.replays == ran - 1
    if "patience" in over:
        assert cfg.val_freq < logs.stop_iter < cfg.n_iter
        assert ran == int(logs.val_active.sum()) + 1


def test_graphed_member_loop_equals_eager(eager_graphs, monkeypatch):
    """The member-batched graphed loop (replays run eagerly here), with
    members that stop at their own blocks, gives the eager loop's rows,
    params and stops, with one capture per run."""
    from dpivae_tpu_torch.sweep import train_sweep

    cfg = _cfg(n_iter=60, patience=1, min_delta=0.0, n_mc_val=1,
               **{f"lr_{k}": 0.01 for k in ("e", "p", "dx", "dc", "dy")})

    def run(graphed):
        monkeypatch.setattr(eager_graphs, "resolve_cuda_graph",
                            lambda *a: graphed)
        return train_sweep(cfg, CASE, [0.0, 0.01, -0.01, 0.1], seed=4,
                           chunk_size=None, device="cpu")

    got, want = run(True), run(False)
    for a, b in zip(got.logs, want.logs):
        assert torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                           torch.nan_to_num(b.float(), nan=7.0))
    for k in got.params:
        assert torch.equal(got.params[k], want.params[k]), k
    (graph,) = _EagerGraph.made
    assert graph.replays == _blocks_run(got.logs, cfg) - 1
    assert (got.logs.train_active.sum(dim=1) < cfg.n_iter).any()
