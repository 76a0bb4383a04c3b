"""The inference graph cache's CPU-side contract (``utils/graph_cache.py``):
``cuda_graph`` on the inference entry points, bodies that read no host
value, the cache's keys, bound and identity checks, copies out, the
caller's generator, launch counts, and the cached path against the JAX
package's ``build_predict_fn`` and ``cached_sample_mean``.

A CUDA graph bakes every value the host hands a captured body, so the
bodies the cache captures (``DPIVAE.sample``, ``sample_prior``, the MC
mean, a loaded artifact's program with its draws) run here under the
training graph's guard (``tests/test_torch_train_graph.py``), which makes
every host read of a tensor and every tensor made from host data raise.
``Graphed`` is replaced by a stand-in that runs the body under that guard
where the card would capture it and again at every "replay", copying
into the same output tensors as a replay does, so that the cache's logic
(keys, copies out, generator states) runs without a card. The three cases (simple_beam and
damped_oscillator: S models; bridge / "DPIVAE-A": the P model with a
physical covariate), ``cond`` False and True; small sizes (batch 8, 4 MC
samples). Graph against eager on the card:
tests/test_torch_graph_cache_cuda.py.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dpivae_tpu.utils.jit_cache import (
    cached_sample_mean as jax_cached_sample_mean,
)
from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch import serving
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.eval import evaluate_model
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.serving import SAMPLE_SLOTS, ServedPredictor
from dpivae_tpu_torch.train import init_params, setup_model
from dpivae_tpu_torch.utils import graph_cache
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.viz import visualization as viz
from test_torch_port_model import _data as _jax_data
from test_torch_port_model import _models as _jax_models
from test_torch_port_model import _replayed_noise
from test_torch_train_graph import _no_host_reads

MODELS = [("simple_beam", "dpivae"), ("damped_oscillator", "dpivae"),
          ("bridge", "DPIVAE-A")]
B, N = 8, 4
JAX_TOL = 1e-4   # as tests/test_torch_port_model.py holds the predictor


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _OwnConstants(TorchDispatchMode):
    """Lets through ``lift_fresh_copy`` of a loaded artifact's own
    constants (an index tensor of its output transform): ``load_predictor``
    moved them to the program's device, where the copy is a device copy
    that a graph captures. Every other call goes on to the guard."""

    def __init__(self, constants):
        super().__init__()
        self.ptrs = {t.data_ptr() for t in constants}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if (func is torch.ops.aten.lift_fresh_copy.default
                and args[0].data_ptr() in self.ptrs):
            return args[0].clone()
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _guard():
    with _no_host_reads(pytest.MonkeyPatch()), _OwnConstants(
            _GuardedGraph.constants):
        yield


class _GuardedGraph:
    """Stands in for ``train.graph.Graphed`` on the CPU. The "capture"
    runs the body once under the host-read guard, keeps its outputs and
    takes back the launches it counted, as ``Graphed`` does; a "replay"
    runs it again under the guard and copies into those same outputs, so
    that every replay returns the same tensors, as on the card."""

    made = []
    constants = ()

    def __init__(self, body, generators, stream, pool=None):
        self.body, self.replays = body, 0
        self.generators = list(generators)
        before = ops.fused_mlp.launches
        with _guard():
            self.out = body()
        ops.fused_mlp.launches = before
        _GuardedGraph.made.append(self)

    def replay(self):
        self.replays += 1
        with _guard():
            for o, new in zip(self.out, self.body()):
                o.copy_(new)
        return self.out


def _graphed(cuda_graph, device, mesh=None):
    """``resolve_cuda_graph`` with "auto" graphed on the CPU too."""
    return cuda_graph is not False


@pytest.fixture
def cache(monkeypatch):
    """The cache on the CPU: stand-in graphs, fresh LRUs, "auto" graphed
    in serving and the figures, and the plain fused MLP counting a launch
    per call as the kernel's wrapper does on the card."""
    _GuardedGraph.made = []
    monkeypatch.setattr(graph_cache, "Graphed", _GuardedGraph)
    monkeypatch.setattr(graph_cache, "_context",
                        lambda device: (contextlib.nullcontext(), None))
    for name in ("_MEAN_CACHE", "_SAMPLE_CACHE", "_PRIOR_CACHE",
                 "_PROGRAM_CACHE"):
        monkeypatch.setattr(graph_cache, name, graph_cache.GraphLRU())
    for module in (serving, viz):
        monkeypatch.setattr(module, "resolve_cuda_graph", _graphed)
    reference = ops.fused_mlp_reference

    def counted(*args):
        ops.fused_mlp.launches += 1
        return reference(*args)

    monkeypatch.setattr(ops, "fused_mlp_reference", counted)
    return graph_cache


def _setup(case_name="simple_beam", preset="dpivae", seed=0, **over):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        **{**dict(n_train=32, n_batch=16, n_mc_test=N, use_pallas=True,
                use_seed=True),
           **over})
    g = torch.Generator().manual_seed(seed)
    data = sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                           device="cpu")
    model = setup_model(cfg, case, data, device="cpu")
    params = init_params(cfg, model, device="cpu")
    x, c, y, _ = sample_response(case, g, B, sample_dist=case.gt_dist(),
                                 device="cpu")
    return cfg, case, model, params, (x, c, y)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


# ----------------------------------------------------------------------
# cuda_graph on the CPU
# ----------------------------------------------------------------------

def test_cuda_graph_true_raises_on_the_cpu():
    """True raises at every inference entry point on the CPU, and the
    cache itself refuses a CPU call; "auto" runs eagerly there."""
    cfg, case, model, params, (x, c, y) = _setup()
    match = "needs a CUDA device"
    with pytest.raises(ValueError, match=match):
        serving.Predictor(model, params, cfg, device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match=match):
        serving.sample_mean(model, params, x, c, generator=_gen(0),
                            cuda_graph=True)
    with pytest.raises(ValueError, match=match):
        ServedPredictor(program=None, meta={}, device=torch.device("cpu"),
                        cuda_graph=True)
    with pytest.raises(ValueError, match=match):
        evaluate_model(cfg, case, model, params, (x, c, y),
                       cuda_graph=True)
    with pytest.raises(ValueError, match=match):
        viz.marginal_prior_data(model, params, cfg, case, 0, 2, B,
                                device="cpu", cuda_graph=True)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graph_cache.cached_sample_mean(model, params, x, c, cond=False, n=N,
                                       grl_alpha=0.0, generator=_gen(0))
    got = serving.Predictor(model, params, cfg, device="cpu")(x, c, seed=3)
    want = serving.Predictor(model, params, cfg, device="cpu",
                             cuda_graph=False)(x, c, seed=3)
    np.testing.assert_array_equal(got["y"], want["y"])
    assert graph_cache.entries() == 0


# ----------------------------------------------------------------------
# The bodies read no host value, and the cached calls equal eager ones
# ----------------------------------------------------------------------

@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("case_name, preset", MODELS)
def test_bodies_read_no_host_value(cache, case_name, preset, cond):
    """``sample`` (all nine slots), ``sample_prior`` and ``sample_mean``
    (all eight outputs) through the cache, each called twice (the warm-up
    answer, then a guarded replay), equal the eager calls from the same
    generator state, and leave the generator where they leave it."""
    cfg, case, model, params, (x, c, y) = _setup(case_name, preset)
    for seed in (1, 2):
        g, ref = _gen(seed), _gen(seed)
        got = cache.cached_sample(model, params, x, c, cond=cond, n=N,
                                  grl_alpha=cfg.lambda_g0, generator=g)
        with torch.no_grad():
            want = model.sample(params, x, c, cond=cond, n=N,
                                grl_alpha=cfg.lambda_g0, generator=ref)
        _equal(got, want)
        got = cache.cached_sample_prior(model, params, c, y, N, generator=g)
        with torch.no_grad():
            want = model.sample_prior(params, c, y, N, generator=ref,
                                      device="cpu")
        _equal(got, want)
        outputs = tuple(SAMPLE_SLOTS)
        got = serving.sample_mean(model, params, x, c, outputs=outputs,
                                  cond=cond, n=N, grl_alpha=cfg.lambda_g0,
                                  generator=g)
        want = serving.sample_mean(model, params, x, c, outputs=outputs,
                                   cond=cond, n=N, grl_alpha=cfg.lambda_g0,
                                   generator=ref, cuda_graph=False)
        _equal(got, want)
        assert torch.equal(torch.randn(4, generator=g),
                           torch.randn(4, generator=ref))
    assert [graph.replays for graph in _GuardedGraph.made] == [1, 1, 1]


@pytest.mark.parametrize("case_name, preset, cond", [
    ("simple_beam", "dpivae", False), ("damped_oscillator", "dpivae", True),
    ("bridge", "DPIVAE-A", True)])
def test_served_program_body_reads_no_host_value(cache, monkeypatch,
                                                 tmp_path, case_name, preset,
                                                 cond):
    """A loaded artifact's graph body (its draws, then ``module()`` of the
    ``torch.export`` program with its symbolic batch) under the guard, at
    two batch sizes in turns, from seeds and from explicit noise, equals
    the eager artifact."""
    cfg, case, model, params, (x, c, y) = _setup(case_name, preset)
    outputs = tuple(SAMPLE_SLOTS)
    path = serving.save_predictor(str(tmp_path / "p.pt2"), model, params,
                                  cfg, case, cond=cond, outputs=outputs)
    graphed = serving.load_predictor(path, device="cpu")
    eager = dataclasses.replace(graphed, cuda_graph=False)
    module = graphed._module
    monkeypatch.setattr(_GuardedGraph, "constants", [
        t for t in (*module.buffers(), *vars(module).values())
        if isinstance(t, torch.Tensor)])
    for size in (B, 3, B, 3):
        for seed in (size, size + 1):
            got = graphed(x[:size], c[:size], seed=seed)
            want = eager(x[:size], c[:size], seed=seed)
            for name in outputs:
                np.testing.assert_array_equal(got[name], want[name])
    noise = serving.draw_normals(graphed.meta["draws"], _gen(5), (N, B),
                                 torch.device("cpu"))
    for _ in range(2):
        got = graphed(x, c, noise=noise)
        want = eager(x, c, noise=noise)
        for name in outputs:
            np.testing.assert_array_equal(got[name], want[name])
    assert len(cache._PROGRAM_CACHE) == 3
    assert sorted(g.replays for g in _GuardedGraph.made) == [1, 3, 3]


# ----------------------------------------------------------------------
# The cache's logic
# ----------------------------------------------------------------------

def test_keys_and_launches(cache):
    """One graph per signature (x's shape, cond, n, the slots, generator
    or noise); a repeated signature replays. The forward launches once per
    call, the first call of a signature included."""
    cfg, case, model, params, (x, c, y) = _setup()
    call = lambda x, c, **kw: serving.sample_mean(
        model, params, x, c, **{**dict(outputs=("x_sample", "y"), n=N,
                                       generator=_gen(0)), **kw})
    before = ops.fused_mlp.launches
    calls = [dict(), dict(), dict(cond=True), dict(n=2),
             dict(outputs=("x_sample",)), dict(outputs=("y",)),
             dict(noise=_noise_like(model, N, B), generator=None), dict()]
    for kw in calls:
        call(x, c, **kw)
    call(x[:3], c[:3])
    call(x[:3], c[:3])
    assert len(cache._MEAN_CACHE) == 7
    assert [g.replays for g in _GuardedGraph.made] == [2, 0, 0, 0, 0, 0, 1]
    # every call but the one of "y" alone runs decoder_x
    assert ops.fused_mlp.launches - before == len(calls) + 2 - 1


def _noise_like(model, n, b):
    g = _gen(9)
    return {name: torch.randn((n, b, w), generator=g)
            for name, w in (("z", model.nz_x + model.nz_c + model.nz_y),
                            ("x", model.nd_x), ("c", model.nd_c),
                            ("y", model.nd_y))}


def test_lru_bound(cache, monkeypatch):
    """The LRU keeps ``maxsize`` graphs; the oldest goes first, and a
    signature that went is captured again."""
    monkeypatch.setattr(cache, "_SAMPLE_CACHE", cache.GraphLRU(maxsize=2))
    cfg, case, model, params, (x, c, y) = _setup()
    call = lambda size: cache.cached_sample(
        model, params, x[:size], c[:size], cond=False, n=1,
        grl_alpha=0.0, slots=(5,), generator=_gen(size))
    for size in (1, 2, 3, 3, 2):
        call(size)
    assert len(cache._SAMPLE_CACHE) == 2 and len(_GuardedGraph.made) == 3
    call(1)
    assert len(_GuardedGraph.made) == 4
    assert cache.GraphLRU()._max == cache._MAX_ENTRIES == 64


def test_recycled_ids_rebuild(cache, monkeypatch):
    """A model or params object at the ``id`` of one the cache holds (here
    every ``id`` is made equal) gets a graph of its own; the held graph is
    never replayed for it. Params whose tensors moved (another address)
    are another signature too."""
    monkeypatch.setattr(cache, "id", lambda obj: 0, raising=False)
    cfg, case, model, params, (x, c, y) = _setup()
    call = lambda model, params: cache.cached_sample_mean(
        model, params, x, c, cond=False, n=N, grl_alpha=0.0,
        outputs=(4,), generator=_gen(0))
    first = call(model, params)
    other = dataclasses.replace(model)     # an equal model, another object
    params2 = params.__class__.__new__(params.__class__)
    params2.__dict__ = dict(params.__dict__)  # the same tensors, another object
    _, _, model_b, params_b, _ = _setup(seed=1)
    for m, p in ((other, params), (model, params2), (model_b, params_b)):
        made = len(_GuardedGraph.made)
        got = call(m, p)
        assert len(_GuardedGraph.made) == made + 1
        with torch.inference_mode():
            want = serving.sample_mean(m, p, x, c, n=N, grl_alpha=0.0,
                                       generator=_gen(0), cuda_graph=False)
        _equal(got, want)
    assert not torch.equal(got[0], first[0])
    moved = params_b.to(torch.float64).to(torch.float32)
    made = len(_GuardedGraph.made)
    call(model_b, moved)
    assert len(_GuardedGraph.made) == made + 1


def test_outputs_are_copies_and_the_generator_advances(cache):
    """Replayed outputs are copies: a later call does not overwrite an
    earlier answer. The caller's generator then draws what it would after
    the eager calls, in the figures' loop and in ``evaluate_model`` too."""
    cfg, case, model, params, (x, c, y) = _setup()
    answers = [cache.cached_sample(model, params, x, c, cond=False, n=N,
                                   grl_alpha=0.0, slots=(2, 5),
                                   generator=_gen(s)) for s in range(3)]
    for s, got in enumerate(answers):
        with torch.no_grad():
            want = model.sample(params, x, c, n=N, grl_alpha=0.0,
                                slots=(2, 5), generator=_gen(s))
        _equal(got, want)
    assert answers[1][2].data_ptr() != answers[2][2].data_ptr()

    g, ref = _gen(4), _gen(4)
    got = evaluate_model(cfg, case, model, params, (x, c, y), generator=g)
    want = evaluate_model(cfg, case, model, params, (x, c, y), generator=ref,
                          cuda_graph=False)
    np.testing.assert_array_equal(got[1][cfg.name], want[1][cfg.name])
    assert torch.equal(torch.randn(8, generator=g),
                       torch.randn(8, generator=ref))

    figure = lambda fn, **kw: fn(model, params, cfg, case, 1, 3, B, key=3,
                                 device="cpu", **kw)[0]
    got, want = (figure(viz.pred_decomposition, cuda_graph=graphed)
                 for graphed in ("auto", False))
    _equal(list(got.values()), list(want.values()))
    for fn in (viz.marginal_post_data, viz.marginal_prior_data):
        _equal(figure(fn), figure(fn, cuda_graph=False))
    # slots (2, 5) above, then the prediction figure's and the latents'
    assert (len(cache._SAMPLE_CACHE), len(cache._PRIOR_CACHE)) == (3, 1)


# ----------------------------------------------------------------------
# Against the JAX package
# ----------------------------------------------------------------------

def test_cached_path_matches_jax(cache):
    """The cached path (``build_predict_fn`` with all outputs, and
    ``cached_sample_mean`` of y, with ``cond``) under the JAX package's
    replayed normals equals its ``build_predict_fn`` and
    ``cached_sample_mean``."""
    from dpivae_tpu.serving import build_predict_fn as jax_build_predict_fn

    (jcfg, jmodel, jparams), (cfg, model, params) = _jax_models(True)
    x, c, _ = _jax_data(16, 2)
    n, outputs = 8, tuple(SAMPLE_SLOTS)
    key = jax.random.PRNGKey(11)
    want = jax_build_predict_fn(jmodel, jparams, jcfg, n=n, outputs=outputs)(
        np.asarray(jax.random.key_data(key), np.uint32), x, c)
    predict = serving.build_predict_fn(model, params, cfg, n=n,
                                       outputs=outputs)
    noise = _replayed_noise(key, jmodel, n, 16, False)
    for _ in range(2):
        got = predict(torch.from_numpy(x), torch.from_numpy(c), noise=noise)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=JAX_TOL, atol=JAX_TOL)
    key = jax.random.PRNGKey(12)
    (want,) = jax_cached_sample_mean(
        jmodel, jparams, key, jnp.asarray(x), jnp.asarray(c), cond=True,
        n=n, grl_alpha=jcfg.lambda_g0, outputs=(4,))
    noise = _replayed_noise(key, jmodel, n, 16, True)
    (got,) = cache.cached_sample_mean(
        model, params, torch.from_numpy(x), torch.from_numpy(c), cond=True,
        n=n, grl_alpha=cfg.lambda_g0, outputs=(4,), noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=JAX_TOL,
                               atol=JAX_TOL)
    assert len(_GuardedGraph.made) == 2
