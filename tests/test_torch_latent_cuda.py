"""The latent-Gaussian kernels (``csrc/latent_gauss.cu``, through
``ops.latent.latent_gauss``) on the card against the plain version
(``latent_gauss_reference``) on the same CUDA tensors: the outputs, and
the gradient of every raw head output against autograd through the plain
version with the same upstream grads. At simple_beam's widths (nz 2/2/2,
diagonal priors, a normal z_x prior) and damped_oscillator's (1/4/4, a
uniform z_x prior), at a training (16 MC x 64 rows) and a validation
(64 x 512) size, and with full-covariance priors. The heads hold entries
at each clamp's bounds and beyond them, where the gradient must be
nonzero and zero as ``torch.clamp``'s is. Then: the launch counters, the
span counters of one eager training block (11 forwards, 10 backwards) and
of a sweep (none: its ``vmap(grad(...))`` keeps plain PyTorch), and two
runs equal bit for bit.

Tolerances, both sides float32: the outputs are equal bit for bit (the
forward kernel rounds each operation as the plain version's kernels do
and adds every sum in the order of PyTorch's reductions on the card; a
PyTorch whose reductions add in another order fails here first);
gradients rtol 1e-4 with atol 1e-4 of the largest magnitude (the kernel
forms each gradient from its closed form, autograd from the chain of the
plain version's ops; the forward and back substitutions divide by the
diagonal of L, down to exp(-7), which scales the rounding of either).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_latent_cuda.py --noconftest -q
"""

import math

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import latent
from dpivae_tpu_torch.sweep import train_sweep
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.utils import spans
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.utils.distributions import (
    MarginalDistribution,
    Normal,
    Uniform,
)
from dpivae_tpu_torch.utils.transforms import Logistic, MaskedChain, ShiftScale

pytestmark = pytest.mark.cuda

# (nz_x, nz_c, nz_y, full-covariance priors, z_x prior as (dist, lb, ub))
WIDTHS = {
    "beam": (2, 2, 2, False, ((Normal(4.0, 1.0), 2.0, 6.0),
                              (Normal(0.5, 0.2), 0.01, 0.99))),
    "osc": (1, 4, 4, False, ((Uniform(1.0, 2.0), 1.0, 2.0),)),
    "beam_full": (2, 2, 2, True, ((Normal(4.0, 1.0), 2.0, 6.0),
                                  (Normal(0.5, 0.2), 0.01, 0.99))),
    "osc_full": (1, 4, 4, True, ((Uniform(1.0, 2.0), 1.0, 2.0),)),
}
SIZES = {"train": (16, 64), "val": (64, 512)}
# (head part, bound) of each clamp: mean ±50, log-sigma [-7, 3], tril ±20
BOUNDS = ((0, 50.0), (0, -50.0), (1, -7.0), (1, 3.0), (2, 20.0),
          (2, -20.0))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _head(g, rows, m, full, device):
    """Raw outputs of a head, with rows 0-5 at a clamp's bound and rows
    6-11 beyond it (one entry each); returns the head and the list of
    (part, row, column) entries set."""
    parts = [torch.randn(rows, m, generator=g) * 2.0,
             torch.randn(rows, m, generator=g) * 1.5 - 1.0,
             torch.randn(rows, m * m, generator=g) * 3.0 if full else None]
    marked = []
    for r, (part, bound) in enumerate(BOUNDS):
        if parts[part] is None:
            continue
        # a strictly-lower tril entry; the mean's and log-sigma's first
        col = m if part == 2 and m > 1 else 0
        if part == 2 and m == 1:
            continue
        for row, value in ((r, bound), (r + 6, bound * 1.25 + math.copysign(
                1.0, bound))):
            parts[part][row, col] = value
            marked.append((part, row, col))
    return tuple(None if t is None else t.to(device) for t in parts), marked


def _inputs(width, size, device, seed=0):
    nz_x, nz_c, nz_y, full, px = WIDTHS[width]
    n, rows = SIZES[size]
    g = torch.Generator().manual_seed(seed)
    enc, enc_marked = _head(g, rows, nz_x + nz_c + nz_y, True, device)
    prior_c, c_marked = _head(g, rows, nz_c, full, device)
    prior_y, y_marked = _head(g, rows, nz_y, full, device)
    eps = torch.randn(n, rows, nz_x + nz_c + nz_y, generator=g).to(device)
    lb = torch.tensor([b for _, b, _ in px], device=device)
    ub = torch.tensor([b for _, _, b in px], device=device)
    squash = MaskedChain(tuple(range(nz_x)), Logistic(1.0),
                         ShiftScale(lb, ub))
    prior_x = MarginalDistribution([d for d, _, _ in px])
    marked = [(0, *e) for e in enc_marked] + [(1, *e) for e in c_marked] + [
        (2, *e) for e in y_marked]
    return (enc, eps, prior_c, prior_y, squash, prior_x), marked


def _close(got, want, rtol, scale):
    torch.testing.assert_close(
        got, want, rtol=rtol,
        atol=scale * float(torch.max(torch.abs(want))) + 1e-30)


def _run(fn, args, upstream):
    """fn's outputs and the grads of the nine raw head outputs."""
    enc, eps, prior_c, prior_y, squash, prior_x = args
    leaves = [tuple(None if t is None else t.clone().requires_grad_()
                    for t in head) for head in (enc, prior_c, prior_y)]
    out = fn(leaves[0], eps, leaves[1], leaves[2], squash, prior_x)
    torch.autograd.backward(out, upstream)
    return [t.detach() for t in out], [[None if t is None else t.grad
                                        for t in head] for head in leaves]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("width", WIDTHS)
def test_kernels_match_the_plain_version(device, width, size):
    args, marked = _inputs(width, size, device)
    with torch.no_grad():
        shapes = [t.shape for t in latent.latent_gauss_reference(*args)]
    g = torch.Generator().manual_seed(1)
    upstream = [torch.randn(s, generator=g).to(device) for s in shapes]
    fwd, bwd = latent.latent_fwd.launches, latent.latent_bwd.launches
    got_out, got_grads = _run(latent.latent_gauss, args, upstream)
    assert (latent.latent_fwd.launches - fwd,
            latent.latent_bwd.launches - bwd) == (1, 1)
    want_out, want_grads = _run(latent.latent_gauss_reference, args,
                                upstream)
    for a, b in zip(got_out, want_out):
        assert torch.equal(a, b), float(torch.max(torch.abs(a - b)))
    for head_got, head_want in zip(got_grads, want_grads):
        for a, b in zip(head_got, head_want):
            assert (a is None) == (b is None)
            if a is not None:
                _close(a, b, 1e-4, 1e-4)
    # torch.clamp's masks: a grad at each bound, none beyond it
    for head, part, row, col in marked:
        a, b = got_grads[head][part], want_grads[head][part]
        assert bool(a[row, col] == 0) == bool(b[row, col] == 0), (
            head, part, row, col)
        assert bool(b[row, col] == 0) == (row >= 6), (head, part, row, col)


def test_two_runs_are_equal_bit_for_bit(device):
    args, _ = _inputs("osc_full", "val", device)
    with torch.no_grad():
        shapes = [t.shape for t in latent.latent_gauss_reference(*args)]
    upstream = [torch.ones(s, device=device) for s in shapes]
    first = _run(latent.latent_gauss, args, upstream)
    second = _run(latent.latent_gauss, args, upstream)
    for a, b in zip(first[0], second[0]):
        assert torch.equal(a, b)
    for head_a, head_b in zip(first[1], second[1]):
        for a, b in zip(head_a, head_b):
            assert a is None or torch.equal(a, b)


def _beam(device, n_iter, cuda_graph):
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=256, n_val=64, n_batch=32, n_mc_train=8, n_mc_val=8,
        n_iter=n_iter, val_freq=10, use_seed=True, use_pallas=True,
        patience=10**9)
    g = torch.Generator(device=device).manual_seed(0)
    data_train = sample_response(case, g, cfg.n_train,
                                 sample_dist=case.gt_dist(), device=device)
    data_val = sample_response(case, g, cfg.n_val,
                               sample_dist=case.gt_dist(), device=device)
    model = setup_model(cfg, case, data_train, device=device)
    params = init_params(cfg, model, device=device)
    latent.latent_fwd.launches = latent.latent_bwd.launches = 0
    with spans.recording() as rec:
        train_model(cfg, model, case, data_train, data_val, params=params,
                    generator=torch.Generator(device=device).manual_seed(1),
                    device=device, cuda_graph=cuda_graph)
    counters = rec.export()["counters"]
    return ((counters.get("latent.fused.fwd", 0),
             counters.get("latent.fused.bwd", 0)),
            (latent.latent_fwd.launches, latent.latent_bwd.launches))


def test_a_training_block_launches_the_op(device):
    """One eager block: 10 steps and the validation; graphed, 6 blocks:
    the eager block and the capture record their launches, and each of
    the replays adds the capture's to the launch counters."""
    assert _beam(device, 10, False) == ((11, 10), (11, 10))
    assert _beam(device, 60, "auto") == ((22, 20), (66, 60))


def test_a_sweep_keeps_plain_pytorch(device):
    case = get_case("damped_oscillator")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        n_train=256, n_val=64, n_batch=32, n_mc_train=8, n_mc_val=8,
        n_iter=20, val_freq=10, use_seed=True, seed=3, patience=10**9)
    latent.latent_fwd.launches = latent.latent_bwd.launches = 0
    with spans.recording() as rec:
        train_sweep(cfg, case, [-0.5, 0.5], device=device, chunk_size=None)
    counters = rec.export()["counters"]
    assert "latent.fused.fwd" not in counters
    assert "latent.fused.bwd" not in counters
    assert (latent.latent_fwd.launches, latent.latent_bwd.launches) == (0, 0)
