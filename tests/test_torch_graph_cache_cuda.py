"""The inference graph cache on the card (``utils/graph_cache.py``) against
the eager calls (``cuda_graph=False``), from the same seeds and weights:
the ``Predictor`` of simple_beam / "dpivae" with the fused-MLP kernel and
plain, all eight outputs, and of bridge / "DPIVAE-A" (the P model) with
``cond``; a loaded artifact at several batch sizes and from explicit
noise; requests of two shapes in turns (the graphs share one memory pool);
``evaluate_model`` and the caller's generator after it; the data of a
prediction figure and of ``marginal_prior_data``; and four threads asking
one predictor at once. Values must be equal (max_abs_err 0): a replay runs
the eager call's kernels on the same inputs, and its generator is set to
the caller's state before and copied back after. The forward kernel counts
one launch per request, the first request of a shape included.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_graph_cache_cuda.py --noconftest -q
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.eval import evaluate_model
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.serving import (
    SAMPLE_SLOTS,
    Predictor,
    load_predictor,
    save_predictor,
)
from dpivae_tpu_torch.train import init_params, setup_model
from dpivae_tpu_torch.utils import draw_normals, graph_cache
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.viz import visualization as viz

pytestmark = pytest.mark.cuda

N_MC = 64
OUTPUTS = tuple(SAMPLE_SLOTS)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(device, case_name="simple_beam", preset="dpivae", **over):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        **{**dict(n_train=256, n_mc_test=N_MC, use_pallas=True,
                  use_seed=True, n_plot=200, n_interp=3), **over})
    g = torch.Generator(device=device).manual_seed(0)
    data = sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                           device=device)
    model = setup_model(cfg, case, data, device=device)
    params = init_params(cfg, model, device=device)
    x, c, y, _ = sample_response(case, g, 128, sample_dist=case.gt_dist(),
                                 device=device)
    return cfg, case, model, params, (x, c, y)


def _same(got, want):
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_predictor_graph_equals_eager(device, use_pallas):
    """Requests of two sizes in turns, graphed and eager from the same
    seeds: equal; one forward launch per request with the kernel."""
    cfg, case, model, params, (x, c, _) = _setup(device)
    model = dataclasses.replace(model, use_pallas=use_pallas)
    graphed = Predictor(model, params, cfg, outputs=OUTPUTS, device=device)
    eager = Predictor(model, params, cfg, outputs=OUTPUTS, device=device,
                      cuda_graph=False)
    sizes = (128, 7, 128, 7, 1)
    ops.fused_mlp.launches = 0
    answers = [graphed(x[:b], c[:b], seed=i) for i, b in enumerate(sizes)]
    assert ops.fused_mlp.launches == (len(sizes) if use_pallas else 0)
    for i, (b, got) in enumerate(zip(sizes, answers)):
        _same(got, eager(x[:b], c[:b], seed=i))


def test_p_model_with_cond(device):
    cfg, case, model, params, (x, c, _) = _setup(device, "bridge",
                                                  "DPIVAE-A")
    kw = dict(cond=True, outputs=OUTPUTS, device=device)
    graphed = Predictor(model, params, cfg, **kw)
    eager = Predictor(model, params, cfg, cuda_graph=False, **kw)
    for seed in (0, 1, 2):
        _same(graphed(x, c, seed=seed), eager(x, c, seed=seed))


def test_artifact_graph_equals_eager(device, tmp_path):
    cfg, case, model, params, (x, c, _) = _setup(device)
    path = save_predictor(str(tmp_path / "p.pt2"), model, params, cfg, case,
                          outputs=OUTPUTS)
    graphed = load_predictor(path, device=device)
    eager = load_predictor(path, device=device, cuda_graph=False)
    for b in (1, 7, 128, 7):
        _same(graphed(x[:b], c[:b], seed=b), eager(x[:b], c[:b], seed=b))
    noise = draw_normals(graphed.meta["draws"],
                         torch.Generator(device=device).manual_seed(3),
                         (N_MC, 16), device)
    for _ in range(2):
        _same(graphed(x[:16], c[:16], noise=noise),
              eager(x[:16], c[:16], noise=noise))


def test_evaluate_and_the_callers_generator(device):
    cfg, case, model, params, data = _setup(device)
    g = torch.Generator(device=device).manual_seed(4)
    ref = torch.Generator(device=device).manual_seed(4)
    for _ in range(2):
        got = evaluate_model(cfg, case, model, params, data, generator=g)
        want = evaluate_model(cfg, case, model, params, data, generator=ref,
                              cuda_graph=False)
        np.testing.assert_array_equal(got[1][cfg.name], want[1][cfg.name])
        assert torch.equal(torch.randn(16, generator=g, device=device),
                           torch.randn(16, generator=ref, device=device))


def test_figure_data_graph_equals_eager(device):
    cfg, case, model, params, _ = _setup(device)
    kw = dict(device=device, key=5)
    got = viz.pred_decomposition(model, params, cfg, case, 0, cfg.n_interp,
                                 cfg.n_plot, **kw)[0]
    want = viz.pred_decomposition(model, params, cfg, case, 0, cfg.n_interp,
                                  cfg.n_plot, cuda_graph=False, **kw)[0]
    for name in want:
        assert torch.equal(got[name], want[name]), name
    got = viz.marginal_prior_data(model, params, cfg, case, 1, cfg.n_interp,
                                  cfg.n_plot, **kw)[0]
    want = viz.marginal_prior_data(model, params, cfg, case, 1, cfg.n_interp,
                                   cfg.n_plot, cuda_graph=False, **kw)[0]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_concurrent_requests_equal_serial(device):
    """Four threads ask one graphed predictor at once (two batch sizes);
    each answer equals the serial eager one of its seed."""
    cfg, case, model, params, (x, c, _) = _setup(device)
    graphed = Predictor(model, params, cfg, outputs=OUTPUTS, device=device)
    eager = Predictor(model, params, cfg, outputs=OUTPUTS, device=device,
                      cuda_graph=False)
    jobs = [(seed, 128 if seed % 2 else 32) for seed in range(16)]
    answers = {}

    def worker(k):
        for seed, b in jobs[k::4]:
            answers[seed] = graphed(x[:b], c[:b], seed=seed)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for seed, b in jobs:
        _same(answers[seed], eager(x[:b], c[:b], seed=seed))
    assert graph_cache.entries() > 0 and graph_cache.held_bytes() > 0
