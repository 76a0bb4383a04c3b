"""The member-batched fused-MLP kernels and the member-batched trainer on
the card: one launch over a member axis against the batched plain version
(``torch.baddbmm``), members that share a weight (a stride-0 member axis),
``torch.func.vmap(grad(...))`` through ``FusedMLPFunction`` against a
per-member loop of plain autograd, one launch per batched call, and a
short ``train_sweep`` with the kernels against the plain path and against
a single ``train_model`` run of one member, and the same sweep with
``remat_decode`` (its launches, and equal to the sweep without it).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_sweep_cuda.py --noconftest -q

Tolerances as in tests/test_torch_port_cuda.py: rtol 1e-5 / atol 1e-5 for
values, rtol 1e-4 / atol 1e-5 for gradients, 1e-4 for log rows after a
few Adam steps.
"""

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.ops.gradrev import grad_reverse
from dpivae_tpu_torch.sweep import member_datasets, train_sweep
from dpivae_tpu_torch.train import setup_model, train_model
from dpivae_tpu_torch.train.setup import make_template_model
from dpivae_tpu_torch.train.train import member_generators

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
TRAIN_TOL = 1e-4


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _stacked(device, members, rows, d_in, d_hidden, d_out, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=device)
    return (f(members, rows, d_in), f(members, d_hidden, d_in) * 0.3,
            f(members, d_hidden) * 0.1, f(members, d_out, d_hidden) * 0.3,
            f(members, d_out) * 0.1)


SHAPES = [
    (66, 1_024, 8, 128, 64),   # the sweep's training step
    (66, 4_096, 8, 128, 64),   # a validation-like row count
    (3, 1_000, 4, 128, 32),    # ragged rows
    (5, 17, 7, 100, 33),       # odd widths
    (1, 1_024, 4, 128, 32),    # one member
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_batched_forward_and_hidden_match_plain(device, shape):
    args = _stacked(device, *shape)
    with torch.inference_mode():
        before = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
        got = ops.fused_mlp(*args)
        h = ops.fused_mlp_hidden(*args[:3])
        after = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
        torch.cuda.synchronize()
        want = ops.fused_mlp_reference(*args)
        want_h = ops.fused_mlp_hidden_reference(*args[:3])
    assert after == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(h, want_h, rtol=RTOL, atol=ATOL)
    for m in (0, shape[0] - 1):
        single = ops.fused_mlp_reference(*(a[m] for a in args))
        torch.testing.assert_close(got[m], single, rtol=RTOL, atol=ATOL)


def test_shared_weights_use_a_zero_stride(device):
    """Members that share the weights (expanded, stride 0) against each
    member's own call."""
    x, w0, b0, w1, b1 = _stacked(device, 4, 300, 8, 128, 64)
    shared = [a[0].expand(4, *a.shape[1:]) for a in (w0, b0, w1, b1)]
    with torch.inference_mode():
        got = ops.fused_mlp(x, *shared)
        want = torch.stack([ops.fused_mlp(x[m], w0[0], b0[0], w1[0], b1[0])
                            for m in range(4)])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_vmap_grad_through_the_kernels_matches_plain(device):
    """vmap(grad) of a GRL + fused MLP loss: one batched forward and one
    batched hidden launch, gradients equal to a per-member loop of plain
    autograd."""
    x, w0, b0, w1, b1 = _stacked(device, 6, 1_024, 8, 128, 64, seed=1)
    lam = torch.linspace(-1.0, 1.0, 6, device=device)

    def loss(x, w0, b0, w1, b1, lam):
        return torch.sum(ops.fused_mlp(grad_reverse(x, lam), w0, b0, w1,
                                       b1) ** 2) / x.shape[0]

    before = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        x, w0, b0, w1, b1, lam)
    torch.cuda.synchronize()
    assert (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches) == (
        before[0] + 1, before[1] + 1)
    for m in range(6):
        leaves = [a[m].clone().requires_grad_() for a in (x, w0, b0, w1, b1)]
        y = ops.fused_mlp_reference(grad_reverse(leaves[0], float(lam[m])),
                                    *leaves[1:])
        want = torch.autograd.grad(torch.sum(y ** 2) / x.shape[1], leaves)
        for g, w in zip(got, want):
            torch.testing.assert_close(g[m], w, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)


def _cfg(case, **over):
    return TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, patience=10**9, n_iter=20, n_train=256, n_val=128,
        **over)


def test_sweep_kernels_match_plain_and_a_single_run(device):
    case = get_case("damped_oscillator")
    lambdas = [-1.0, 0.0, 1.0]
    runs = {}
    for pallas in (True, False):
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        runs[pallas] = train_sweep(_cfg(case, use_pallas=pallas), case,
                                   lambdas, seed=5, chunk_size=None,
                                   device=device)
        launches = (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)
        assert launches == ((20 + 2, 20) if pallas else (0, 0))
    kernel, plain = runs[True].logs.train, runs[False].logs.train
    assert torch.isfinite(kernel).all()
    torch.testing.assert_close(kernel[:, :10], plain[:, :10], rtol=TRAIN_TOL,
                               atol=TRAIN_TOL)
    # Member 2 against a single run from its data, init and generator.
    cfg = _cfg(case, use_pallas=True, lambda_g0=1.0)
    g = member_generators(5, [2], device)[0]
    data_train, data_val = member_datasets(cfg, case, None, generator=g)
    params = make_template_model(cfg, case, device=device).init(g,
                                                                device=device)
    model = setup_model(cfg, case, data_train, device=device)
    _, logs = train_model(cfg, model, case, data_train, data_val,
                          params=params, generator=g, device=device)
    torch.testing.assert_close(kernel[2, :10], logs.train[:10],
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)


@pytest.mark.parametrize("mc_chunk", [None, 8])
def test_remat_sweep_launches_and_matches_plain_decode(device, mc_chunk):
    """``remat_decode`` in a member-batched sweep with the kernels: the
    forward launches twice a step (the forward, then the recompute in the
    backward), once a validation, and the hidden kernel once a step, each
    per MC chunk; the logs and params equal the sweep without remat."""
    case = get_case("damped_oscillator")
    lambdas = [-1.0, 0.0, 1.0]
    # MC chunks of a training step (16 samples) and of a validation (64)
    chunks, val_chunks = ((1, 1) if mc_chunk is None
                          else (16 // mc_chunk, 64 // mc_chunk))
    runs = {}
    for remat in (True, False):
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        runs[remat] = train_sweep(
            _cfg(case, use_pallas=True, remat_decode=remat,
                 mc_chunk=mc_chunk), case, lambdas, seed=5, chunk_size=None,
            device=device)
        per_step = 2 if remat else 1
        assert (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches) == (
            per_step * 20 * chunks + 2 * val_chunks, 20 * chunks)
    remat, plain = runs[True], runs[False]
    assert torch.isfinite(remat.logs.train).all()
    torch.testing.assert_close(remat.logs.train, plain.logs.train,
                               rtol=TRAIN_TOL, atol=TRAIN_TOL)
    for name, w in plain.params.items():
        torch.testing.assert_close(remat.params[name], w, rtol=TRAIN_TOL,
                                   atol=TRAIN_TOL, msg=name)
