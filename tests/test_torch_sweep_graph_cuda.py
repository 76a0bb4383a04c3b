"""The sweeps' sampling graphs on the card (``sweep/sweep.py`` through
``utils/graph_cache.py``'s member-chunk entries) against the eager calls
(``cuda_graph=False``), from the same seeds and weights: ``sweep_sample``,
``sweep_predict_y`` and ``sweep_disentanglement_latents`` of simple_beam /
"dpivae" (S) and bridge / "DPIVAE-A" (P, ``use_pallas=True``, the
member-batched forward kernel launched once a chunk both ways), ``cond``
False and True, 5 members in chunks of 2 (the last padded). Values must
be equal (max_abs_err 0): a replay runs the eager chunk's kernels on the
same inputs, with the members' generator states copied in before and back
after. One capture serves every chunk of a signature, a second sweep
result of the same shapes included; the member entries are bounded by
bytes.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_sweep_graph_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import fused_mlp as ops
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

pytestmark = pytest.mark.cuda

MODELS = [("simple_beam", "dpivae"), ("bridge", "DPIVAE-A")]
M, CHUNK, B, N = 5, 2, 64, 8
N_CHUNKS = 3
N_TR, N_TE = 128, 96


@pytest.fixture
def device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(graph_cache, "_MEMBER_CACHE",
                        graph_cache.ByteLRU(graph_cache._MEMBER_SHARE))
    return torch.device("cuda")


def _cfg(case_name, preset):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        n_train=256, n_mc_test=N, use_pallas=True, use_seed=True)
    return cfg, case


def _result(cfg, case, seed, device):
    ids = range(M)
    template = make_template_model(cfg, case, device=device)
    params = stack_params([template.init(g, device=device)
                           for g in member_generators(seed, ids, device)])
    return SweepResult(params, None, np.zeros(M, np.float32),
                       _keys(seed, ids), str(device))


def _calls(cfg, case, cond, device):
    g = torch.Generator(device=device).manual_seed(7)
    rows = [sample_response(case, g, cfg.n_train, sample_dist=case.gt_dist(),
                            device=device) for _ in range(M)]
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


def _record(monkeypatch):
    """The generators ``member_generators`` makes in the sweep module
    (each member's and each member key's), for their next draws."""
    made = []
    make = sweep_mod.member_generators

    def recorded(*args, **kwargs):
        gens = make(*args, **kwargs)
        made.extend(gens)
        return gens

    monkeypatch.setattr(sweep_mod, "member_generators", recorded)
    return made


@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("case_name, preset", MODELS)
def test_sweep_sampling_graph_equals_eager(device, monkeypatch, case_name,
                                           preset, cond):
    """Each function graphed ("auto") and eager, for two sweep results of
    the same shapes: equal bit for bit, the generators' next draws equal,
    one capture a function, the forward's launches one a chunk both ways
    (sample only: the latents and ŷ run no decoder_x)."""
    cfg, case = _cfg(case_name, preset)
    made = _record(monkeypatch)
    for function, call in _calls(cfg, case, cond, device).items():
        answers = []
        for seed in (1, 2):
            res = _result(cfg, case, seed, device)
            for cuda_graph in ("auto", False):
                made.clear()
                before = ops.fused_mlp.launches
                out = call(res, cuda_graph=cuda_graph)
                torch.cuda.synchronize()
                launches = ops.fused_mlp.launches - before
                draws = [torch.randn(8, generator=g, device=device)
                         for g in made]
                answers.append((out, launches, draws))
            (got, n_graph, d_graph), (want, n_eager, d_eager) = answers[-2:]
            for a, b in zip(got, want):
                assert a.shape[0] == M
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            for a, b in zip(d_graph, d_eager):
                assert torch.equal(a, b)
            want_launches = N_CHUNKS if function == "sample" else 0
            assert n_graph == n_eager == want_launches, function
        assert not torch.equal(answers[0][0][0], answers[2][0][0])
    assert len(graph_cache._MEMBER_CACHE) == 3
    assert graph_cache._MEMBER_CACHE.nbytes() > 0


def test_member_entries_are_bounded_by_bytes(device, monkeypatch):
    """With a bound below one entry, each new signature evicts the one
    before (the newest is kept) and a replay still equals eager."""
    monkeypatch.setattr(graph_cache, "_MEMBER_CACHE",
                        graph_cache.ByteLRU(1e-9))
    cfg, case = _cfg("bridge", "DPIVAE-A")
    res = _result(cfg, case, 1, device)
    calls = _calls(cfg, case, False, device)
    calls["predict_y"](res)
    assert len(graph_cache._MEMBER_CACHE) == 1
    assert graph_cache._MEMBER_CACHE.nbytes() > 0
    calls["latents"](res)
    assert len(graph_cache._MEMBER_CACHE) == 1
    graphed = calls["latents"](res)
    eager = calls["latents"](res, cuda_graph=False)
    for a, b in zip(graphed, eager):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
