"""The graphed training loop on the card against the eager loop
(``cuda_graph=False``), from the same seeds and weights: ``train_model``
with annealed schedules (sigmoid λ, cyclical β_x) and the fused-MLP
kernels (simple_beam's S model, whose loss runs the latent-Gaussian
kernels too, and bridge's P model, which keeps plain PyTorch there), an
early stop that latches under the graph, a partial last block, and
``build_member_train_fn`` (through ``train_sweep``) with per-member early
stops and with ``remat_decode``. Rows, params, stop iterations and the
generator's final state must be equal (max_abs_err 0): a replay of the
block graph runs the eager block's kernels on the same inputs, and its
generators advance as the eager draws do. The launch counters count
replays as launches, so both loops count the same. One block graph is
captured a run, replayed once a block after the first, the block after a
stop included, and the host reads one flag a block, one block behind.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_train_graph_cuda.py --noconftest -q
"""

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.ops import latent
from dpivae_tpu_torch.sweep import train_sweep
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.utils.data import sample_response

pytestmark = pytest.mark.cuda

ANNEALED = dict(lambda_annealing="sigmoid", lambda_mu=0.3, lambda_cov=0.2,
                beta_x_annealing="cyclical", beta_x_n_cycles=2, beta_x_R=0.4)


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _single(device, case_name="simple_beam", preset="dpivae", **over):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        **{**dict(n_train=256, n_val=64, n_batch=32, n_mc_train=8,
                  n_mc_val=8, n_iter=60, val_freq=10, use_seed=True,
                  use_pallas=True, patience=10**9), **ANNEALED, **over})
    g = torch.Generator(device=device).manual_seed(0)
    data_train = sample_response(case, g, cfg.n_train,
                                 sample_dist=case.gt_dist(), device=device)
    data_val = sample_response(case, g, cfg.n_val,
                               sample_dist=case.gt_dist(), device=device)
    model = setup_model(cfg, case, data_train, device=device)
    params = init_params(cfg, model, device=device)

    def run(cuda_graph):
        counted = (ops.fused_mlp, ops.fused_mlp_hidden, latent.latent_fwd,
                   latent.latent_bwd)
        for f in counted:
            f.launches = 0
        g = torch.Generator(device=device).manual_seed(1)
        out = train_model(cfg, model, case, data_train, data_val,
                          params=params, generator=g, device=device,
                          cuda_graph=cuda_graph)
        return out, tuple(f.launches for f in counted), g.get_state()

    return cfg, run


def _equal(got, want):
    (p_got, logs_got), launches_got, g_got = got
    (p_want, logs_want), launches_want, g_want = want
    assert launches_got == launches_want
    assert torch.equal(g_got, g_want)
    assert logs_got.stop_iter == logs_want.stop_iter
    for a, b in zip(logs_got, logs_want):
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            torch.nan_to_num(a, nan=7.0), torch.nan_to_num(b, nan=7.0)))
    for (k, a), b in zip(p_got.state_dict().items(),
                         p_want.state_dict().values()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("case_name, preset", [
    ("simple_beam", "dpivae"), ("bridge", "DPIVAE-A")])
def test_train_model_graph_equals_eager(device, case_name, preset):
    """The S model and the P model with a physical covariate. The S
    model's blocks launch the latent-Gaussian kernels, eager and in the
    five replays alike; the P model's none."""
    cfg, run = _single(device, case_name, preset)
    graphed = run("auto")
    _equal(graphed, run(False))
    n = cfg.n_iter
    steps = (n + n // cfg.val_freq, n)
    assert graphed[1] == steps + (steps if case_name == "simple_beam"
                                  else (0, 0))
    lam = graphed[0][1].train[:, 8]
    assert len(torch.unique(lam)) > 10


FAST = {name: 0.01 for name in ("lr_e", "lr_p", "lr_dx", "lr_dc", "lr_dy")}


class _Counted:
    """Counts the block graph's captures and replays and the host's flag
    reads of a run."""

    def __init__(self, monkeypatch):
        from dpivae_tpu_torch.train import train as train_mod

        self.captures, self.replays, self.reads = 0, 0, 0
        counted = self

        class Graphed(train_mod.Graphed):
            def __init__(self, *args, **kwargs):
                counted.captures += 1
                super().__init__(*args, **kwargs)

            def replay(self):
                counted.replays += 1
                return super().replay()

        read = train_mod._LaggedFlag.read

        def counted_read(flag, block):
            counted.reads += 1
            return read(flag, block)

        monkeypatch.setattr(train_mod, "Graphed", Graphed)
        monkeypatch.setattr(train_mod._LaggedFlag, "read", counted_read)


def test_train_model_early_stop_under_the_graph(device, monkeypatch):
    """patience 1 with a one-sample validation (noisy) and 10x learning
    rates: the first validation worse than the best latches the stop,
    after block 0 and so inside the replays; the stop iteration and the
    break-point params equal eager's. One capture; a replay for every
    block after the first up to the block after the stop; one flag read
    a block from block 1 on."""
    cfg, run = _single(device, n_iter=200, patience=1, min_delta=0.0,
                       n_mc_val=1, **FAST)
    counted = _Counted(monkeypatch)
    graphed = run(True)
    logs = graphed[0][1]
    assert cfg.val_freq < logs.stop_iter < cfg.n_iter
    blocks = min(int(logs.val_active.sum()) + 1, logs.val.shape[0])
    assert (counted.captures, counted.replays, counted.reads) == (
        1, blocks - 1, blocks - 1)
    vf = cfg.val_freq
    assert graphed[1] == (blocks * (vf + 1), blocks * vf) * 2
    _equal(graphed, run(False))


def test_train_model_partial_block_under_the_graph(device):
    """n_iter 55 with val_freq 10: the last block's steps past n_iter run
    masked inside the same graph (their launches counted), and leave the
    state of step 54."""
    cfg, run = _single(device, n_iter=55)
    graphed = run("auto")
    assert graphed[0][1].stop_iter == 55
    assert graphed[1] == (6 * 11, 60) * 2
    _equal(graphed, run(False))


@pytest.mark.parametrize("over", [
    dict(use_pallas=True, patience=1, min_delta=0.0, n_mc_val=1, **FAST),
    dict(use_pallas=True, remat_decode=True),
], ids=["kernels-early-stop", "remat"])
def test_member_train_graph_equals_eager(device, over):
    """A 6-member damped_oscillator sweep (one chunk), graphed against
    eager; in the first case members stop early, each at its own block,
    and are frozen between replays."""
    case = get_case("damped_oscillator")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        **{**dict(n_train=256, n_val=64, n_batch=32, n_mc_train=8,
                  n_mc_val=8, n_iter=80, val_freq=10, use_seed=True, seed=3,
                  patience=10**9), **ANNEALED, **over})
    lambdas = [-0.5, -0.1, 0.0, 0.01, 0.1, 0.5]

    def run(cuda_graph):
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        res = train_sweep(cfg, case, lambdas, device=device,
                          chunk_size=None, cuda_graph=cuda_graph)
        return res, (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)

    (got, got_launches), (want, want_launches) = run("auto"), run(False)
    assert got_launches == want_launches
    assert got_launches[0] > 0
    for a, b in zip(got.logs, want.logs):
        assert torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                           torch.nan_to_num(b.float(), nan=7.0))
    for k in got.params:
        assert torch.equal(got.params[k], want.params[k]), k
    if cfg.patience == 1:
        assert (got.logs.train_active.sum(dim=1) < cfg.n_iter).any()
