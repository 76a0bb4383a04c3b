"""The bridge's transfer study on the card: a data sweep of the P model at
its preset "DPIVAE-A" through ``train_sweep_data``, as
``scripts/regression_comparison.py`` runs it, at a small size. The loss
takes the plain latent-Gaussian route (counter ``latent.plain``, model
type P, counted where the host runs the loss: the eager block and the
capture) and never the latent kernels; the copy of the given datasets to
host arrays records its bytes (span ``sweep.member_data``, counter
``sweep.member_data_bytes``); and the replayed block graphs give the
eager loop's logs and params bit for bit.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_bridge_p_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.sweep import train_sweep_data
from dpivae_tpu_torch.train.train import member_generators
from dpivae_tpu_torch.utils import spans
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.utils.priors import make_square_dist

pytestmark = pytest.mark.cuda

CASE = get_case("bridge")
MEMBERS = 8


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _config():
    return TrainConfig().with_preset(CASE.presets["DPIVAE-A"]).replace(
        n_train=256, n_val=64, n_batch=32, n_mc_train=8, n_mc_val=8,
        n_iter=40, val_freq=10, patience=10 ** 9)


def _datasets(cfg, device):
    """Each member's (x, c, y) in its quadrant domain, extrapolation, as
    the study draws them, stacked on the members."""
    dists, _ = make_square_dist(CASE)[::-1]
    sets = ([], [])
    for m, g in enumerate(member_generators(5, range(MEMBERS), device)):
        for split, n in zip(sets, (cfg.n_train, cfg.n_val)):
            split.append(sample_response(CASE, g, n, sample_dist=dists[m % 4],
                                         device=device)[:3])
    return tuple(tuple(torch.stack([d[k] for d in split]) for k in range(3))
                 for split in sets)


def _sweep(device, cuda_graph):
    cfg = _config()
    data_train, data_val = _datasets(cfg, device)
    with spans.recording() as rec:
        res = train_sweep_data(
            cfg, CASE, np.full(MEMBERS, cfg.lambda_g0, np.float32),
            data_train, data_val, seed=11, chunk_size=None, device=device,
            cuda_graph=cuda_graph)
    nbytes = sum(a.numel() * a.element_size()
                 for a in (*data_train, *data_val))
    return res, rec.export(), nbytes


@pytest.fixture(scope="module")
def runs(device):
    return {graph: _sweep(device, graph) for graph in (False, True)}


def test_the_p_loss_runs_plain(runs):
    for graph, (_, out, _) in runs.items():
        counters = out["counters"]
        assert counters.get("latent.plain", 0) > 0, graph
        assert "latent.fused.fwd" not in counters
        assert "latent.fused.bwd" not in counters
        (shares,) = [out["counter_attrs"]["latent.plain"]]
        assert [a for a, _ in shares] == [{"model_type": "P"}]
    # eager: 4 blocks of 10 steps and a validation each; graphed: the
    # eager first block and the capture of the second, then replays
    assert runs[False][1]["counters"]["latent.plain"] == 4 * 11
    assert runs[True][1]["counters"]["latent.plain"] == 2 * 11


def test_the_data_copy_records_its_bytes(runs):
    for _, out, nbytes in runs.values():
        assert out["counters"]["sweep.member_data_bytes"] == nbytes
        (data,) = [s for s in out["spans"] if s[3] == "sweep.member_data"]
        assert data[6] == {"bytes": nbytes, "members": MEMBERS}


def test_graph_equals_eager(runs):
    (eager, _, _), (graphed, out, _) = runs[False], runs[True]
    assert out["counters"]["graph.replays"] == 3
    for a, b in zip(eager.logs, graphed.logs):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    for k in eager.params:
        assert torch.equal(eager.params[k], graphed.params[k]), k
