"""The sweeps' sampling graphs on the CPU (``sweep/sweep.py``'s
``sweep_sample``, ``sweep_predict_y`` and ``sweep_disentanglement_latents``
through ``utils/graph_cache.py``'s member-chunk entries).

On the card each chunk of members replays one CUDA graph whose params,
data and noise are static inputs and whose draws come from one registered
generator per member slot. Here ``Graphed`` is replaced by the stand-in of
tests/test_torch_graph_cache.py, which runs the body under the host-read
guard where the card would capture it and again at every "replay", so
that the cache's logic runs without a card: the graphed path against
``cuda_graph=False`` bit for bit, one capture for every chunk of every
call of a signature (a second sweep result of the same shapes replays and
gives its own answer: params are copied in, not baked), the members'
generators left where the eager path leaves them, the padded member's
output dropped, and the member entries' bound by bytes. simple_beam /
"dpivae" (S) and bridge / "DPIVAE-A" (P), ``cond`` False and True; 5
members in chunks of 2 (the last chunk padded), n 3. Graph against eager
on the card: tests/test_torch_sweep_graph_cuda.py.
"""

import contextlib

import numpy as np
import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.parallel import make_mesh
from dpivae_tpu_torch.sweep import (
    sweep_disentanglement_latents,
    sweep_predict_y,
    sweep_sample,
)
from dpivae_tpu_torch.sweep import sweep as sweep_mod
from dpivae_tpu_torch.sweep.sweep import SweepResult, _keys
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.train.train import member_generators, stack_params
from dpivae_tpu_torch.utils import graph_cache
from dpivae_tpu_torch.utils.data import sample_response
from test_torch_graph_cache import _GuardedGraph

MODELS = [("simple_beam", "dpivae"), ("bridge", "DPIVAE-A")]
FUNCTIONS = ("sample", "predict_y", "latents")
M, CHUNK, B, N = 5, 2, 6, 3
N_CHUNKS = 3   # 5 members in chunks of 2: the last holds one pad
N_TR, N_TE = 7, 5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cache(monkeypatch):
    """Stand-in graphs, a fresh member cache of an 80 GB card, "auto"
    graphed on the CPU, and the plain fused MLP counting a launch per call
    as the kernel's wrapper does on the card."""
    _GuardedGraph.made = []
    monkeypatch.setattr(graph_cache, "Graphed", _GuardedGraph)
    monkeypatch.setattr(graph_cache, "_context",
                        lambda device: (contextlib.nullcontext(), None))
    monkeypatch.setattr(graph_cache, "_MEMBER_CACHE",
                        graph_cache.ByteLRU(graph_cache._MEMBER_SHARE))
    monkeypatch.setattr(graph_cache, "_pool_bytes", lambda graph: 0)
    monkeypatch.setattr(graph_cache, "_memory", lambda device: 80 * 2**30)
    monkeypatch.setattr(sweep_mod, "resolve_cuda_graph",
                        lambda cuda_graph, device, mesh=None:
                        cuda_graph is not False)
    reference = ops.fused_mlp_reference

    def counted(*args):
        ops.fused_mlp.launches += 1
        return reference(*args)

    monkeypatch.setattr(ops, "fused_mlp_reference", counted)
    return graph_cache


class _Recorder:
    """Keeps the generators the sweep functions make (each member's, and
    in the latents each member key's, all through ``member_generators``),
    to read their next draws."""

    def __init__(self, monkeypatch):
        self.made = []
        made = sweep_mod.member_generators

        def recorded(*args, **kwargs):
            gens = made(*args, **kwargs)
            self.made.append(gens)
            return gens

        monkeypatch.setattr(sweep_mod, "member_generators", recorded)

    def next_draws(self):
        draws = [torch.randn(4, generator=g) for gens in self.made
                 for g in gens]
        self.made = []
        return draws


def _cfg(case_name, preset):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        n_train=16, n_batch=8, n_mc_test=N, use_pallas=True, use_seed=True)
    return cfg, case


def _result(cfg, case, seed):
    """A sweep result of M members with random weights from ``seed``."""
    ids = range(M)
    template = make_template_model(cfg, case, device="cpu")
    params = stack_params([template.init(g, device="cpu")
                           for g in member_generators(seed, ids, "cpu")])
    return SweepResult(params, None, np.zeros(M, np.float32),
                       _keys(seed, ids), "cpu")


def _calls(cfg, case, cond):
    """The three functions on M members' data, chunk 2."""
    g = torch.Generator().manual_seed(7)
    rows = [sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                            device="cpu") for _ in range(M)]
    dtr = tuple(torch.stack([r[k] for r in rows]) for k in range(3))
    x, c = dtr[0][:, :B], dtr[1][:, :B]
    return {
        "sample": lambda res, **kw: sweep_sample(
            cfg, case, res, dtr, x, c, cond=cond, n=N, seed=3,
            chunk_size=CHUNK, **kw),
        "predict_y": lambda res, **kw: (sweep_predict_y(
            cfg, case, res, dtr, x, c, cond=cond, n=N, seed=4,
            chunk_size=CHUNK, **kw),),
        "latents": lambda res, **kw: tuple(sweep_disentanglement_latents(
            cfg, case, res, N_TR, N_TE, cond=cond, use_mean=True, seed=5,
            chunk_size=CHUNK, **kw).values()),
    }


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)


# ----------------------------------------------------------------------
# Graph against eager
# ----------------------------------------------------------------------

@pytest.mark.parametrize("function", FUNCTIONS)
@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("case_name, preset", MODELS)
def test_graph_equals_eager(cache, monkeypatch, case_name, preset, cond,
                            function):
    """Two sweep results of the same shapes, each graphed (every body under
    the host-read guard) and eager: equal bit for bit, M members out (the
    pad dropped), the members' generators drawing the same next numbers
    after both paths, one capture for the six chunks of both calls (the
    second result's params copied in, not baked), and the forward's
    launches one a chunk both ways where decoder_x runs."""
    cfg, case = _cfg(case_name, preset)
    call = _calls(cfg, case, cond)[function]
    recorder = _Recorder(monkeypatch)
    answers = []
    for seed in (1, 2):
        res = _result(cfg, case, seed)
        launches = []
        for cuda_graph in ("auto", False):
            before = ops.fused_mlp.launches
            answers.append(call(res, cuda_graph=cuda_graph))
            launches.append(ops.fused_mlp.launches - before)
        graphed, eager = answers[-2:]
        _equal(graphed, eager)
        assert all(o.shape[0] == M for o in graphed)
        draws = recorder.next_draws()
        half = len(draws) // 2
        assert half == M * (2 if function == "latents" else 1)
        for a, b in zip(draws[:half], draws[half:]):
            assert torch.equal(a, b)
        assert launches == [N_CHUNKS if function == "sample" else 0] * 2
    assert not torch.equal(answers[0][0], answers[2][0])
    assert len(_GuardedGraph.made) == 1 and cache.entries() == 1
    assert _GuardedGraph.made[0].replays == 2 * N_CHUNKS - 1
    (entry,) = cache._MEMBER_CACHE.entries()
    assert len(entry.generators) == CHUNK * (2 if function == "latents"
                                             else 1)
    assert all(t.shape[0] == CHUNK for t in entry.inputs.values())


@pytest.mark.parametrize("case_name, preset", MODELS)
def test_explicit_noise(cache, case_name, preset):
    """``noise=`` read from static buffers: graphed equal to eager, and
    other noise of the same shapes replays with no capture and changes
    the answer."""
    cfg, case = _cfg(case_name, preset)
    res = _result(cfg, case, 1)
    calls = _calls(cfg, case, True)
    template = make_template_model(cfg, case, device="cpu")
    nz = template.nz_x + template.nz_c + template.nz_y
    for seed in (10, 11):
        g = torch.Generator().manual_seed(seed)
        noise = {"z": torch.randn(M, N, B, nz, generator=g),
                 "z_prior": torch.randn(M, N, B, template.nz_c, generator=g),
                 "y": torch.randn(M, N, B, template.nd_y, generator=g)}
        got = calls["predict_y"](res, noise=noise)
        _equal(got, calls["predict_y"](res, noise=noise, cuda_graph=False))
        pair = tuple({"z": torch.randn(M, N, n, nz, generator=g),
                      "z_prior": torch.randn(M, N, n, template.nz_c,
                                             generator=g)}
                     for n in (N_TR, N_TE))
        latents = calls["latents"](res, noise=pair)
        _equal(latents, calls["latents"](res, noise=pair, cuda_graph=False))
        if seed == 10:
            first = (got, latents)
    assert not torch.equal(first[0][0], got[0])
    assert not torch.equal(first[1][0], latents[0])
    assert len(_GuardedGraph.made) == 2
    assert sorted(g.replays for g in _GuardedGraph.made) == [5, 5]


def test_padded_member_is_dropped(cache):
    """The last member, alone with its pad in the last chunk, gets what it
    gets unpadded in one chunk of all five (the same draws; the batched
    products differ in order only)."""
    cfg, case = _cfg("simple_beam", "dpivae")
    res = _result(cfg, case, 1)
    g = torch.Generator().manual_seed(7)
    rows = [sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                            device="cpu") for _ in range(M)]
    dtr = tuple(torch.stack([r[k] for r in rows]) for k in range(3))
    x, c = dtr[0][:, :B], dtr[1][:, :B]
    padded = sweep_sample(cfg, case, res, dtr, x, c, n=N, seed=3,
                          chunk_size=CHUNK)
    whole = sweep_sample(cfg, case, res, dtr, x, c, n=N, seed=3,
                         chunk_size=M, cuda_graph=False)
    for a, b in zip(padded, whole):
        assert a.shape == b.shape and a.shape[0] == M
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    padded = sweep_disentanglement_latents(cfg, case, res, N_TR, N_TE,
                                           chunk_size=CHUNK)
    whole = sweep_disentanglement_latents(cfg, case, res, N_TR, N_TE,
                                          chunk_size=M, cuda_graph=False)
    for name, a in padded.items():
        assert a.shape[0] == M
        torch.testing.assert_close(a, whole[name], rtol=1e-5, atol=1e-6)


def test_one_rank_mesh_graphed(cache):
    """With a one-rank "sweep" mesh each rank's chunks are graphed and the
    gather runs outside them: equal to the eager call without a mesh."""
    cfg, case = _cfg("bridge", "DPIVAE-A")
    res = _result(cfg, case, 1)
    mesh = make_mesh(1, ("sweep",), device="cpu")
    try:
        got = sweep_disentanglement_latents(cfg, case, res, N_TR, N_TE,
                                            chunk_size=CHUNK, mesh=mesh)
    finally:
        mesh.close()
    want = sweep_disentanglement_latents(cfg, case, res, N_TR, N_TE,
                                         chunk_size=CHUNK, cuda_graph=False)
    _equal(tuple(got.values()), tuple(want.values()))
    assert _GuardedGraph.made[0].replays == N_CHUNKS - 1


# ----------------------------------------------------------------------
# The member cache's bound
# ----------------------------------------------------------------------

def test_eviction_by_bytes(cache, monkeypatch):
    """Member entries are held while their bytes (each graph's own pool, a
    patched 1 GB here, and its static inputs) stay within the share of the
    card: two fit in 2.5 GB, a third evicts the least recently used, which
    a later call captures again. ``held_bytes()`` and ``entries()`` count
    them."""
    monkeypatch.setattr(cache, "_pool_bytes", lambda graph: 10**9)
    monkeypatch.setattr(cache, "_memory",
                        lambda device: 2.5e9 / cache._MEMBER_SHARE)
    cfg, case = _cfg("simple_beam", "dpivae")
    res = _result(cfg, case, 1)
    g = torch.Generator().manual_seed(7)
    rows = [sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                            device="cpu") for _ in range(M)]
    dtr = tuple(torch.stack([r[k] for r in rows]) for k in range(3))
    x, c = dtr[0][:, :B], dtr[1][:, :B]
    call = lambda n: sweep_predict_y(cfg, case, res, dtr, x, c, n=n,
                                     chunk_size=CHUNK)
    for n in (1, 2, 1, 3):
        call(n)
    # n 2 was the least recently used when n 3 came
    assert len(_GuardedGraph.made) == 3 and cache.entries() == 2
    held = sum(cache._static_bytes(e) + 10**9
               for e in cache._MEMBER_CACHE.entries())
    assert cache.held_bytes() == held
    call(2)
    assert len(_GuardedGraph.made) == 4 and cache.entries() == 2
    call(3)
    assert len(_GuardedGraph.made) == 4


def test_newest_entry_stays_over_the_bound(cache, monkeypatch):
    """An entry over the bound alone is kept (and replays), the older
    ones evicted."""
    monkeypatch.setattr(cache, "_pool_bytes", lambda graph: 10**9)
    monkeypatch.setattr(cache, "_memory", lambda device: 10**6)
    cfg, case = _cfg("simple_beam", "dpivae")
    res = _result(cfg, case, 1)
    call = _calls(cfg, case, False)["latents"]
    call(res)
    call(res)
    assert cache.entries() == 1
    assert _GuardedGraph.made[0].replays == 2 * N_CHUNKS - 1


def test_cuda_graph_true_raises_on_the_cpu():
    """True raises in each of the three functions on a CPU sweep; "auto"
    runs eagerly there and leaves no graph."""
    cfg, case = _cfg("simple_beam", "dpivae")
    res = _result(cfg, case, 1)
    for function, call in _calls(cfg, case, False).items():
        with pytest.raises(ValueError, match="needs a CUDA device"):
            call(res, cuda_graph=True)
        _equal(call(res), call(res, cuda_graph=False))
    assert graph_cache.entries() == 0
