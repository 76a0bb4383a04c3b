"""The CUDA fused-MLP kernels against their plain PyTorch versions, on the
card: the forward, the hidden-layer recompute, and the gradients of
FusedMLPFunction against autograd through the plain forward.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no jax, since the machine with the card has none;
run it there without the repository's conftest (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances as in tests/test_pallas_mlp.py: rtol 1e-5 / atol 1e-5 for
values, rtol 1e-4 / atol 1e-5 for gradients. Both sides are full f32
(TF32 off) and differ only in summation order.
"""

import pytest
import torch

from dpivae_tpu_torch.ops.fused_mlp import (
    fused_mlp,
    fused_mlp_hidden,
    fused_mlp_hidden_reference,
    fused_mlp_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, lead, d_in, d_hidden, d_out, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=device)
    return (f(*lead, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1,
            f(d_out, d_hidden) * 0.3, f(d_out) * 0.1)


SHAPES = [
    ((262_144,), 4, 128, 32),    # serving: 512 requests x 512 MC
    ((1_024,), 4, 128, 32),      # training: 16 MC x 64 batch
    ((1_000,), 4, 128, 32),      # ragged tail
    ((4_096,), 4, 256, 32),      # wider hidden
    ((16, 125), 4, 128, 32),     # leading dims
    ((777,), 7, 100, 33),        # odd widths: scalar stores, partial chunk
    ((500,), 6, 64, 80),         # d_out over several column tiles
]


@pytest.mark.parametrize("lead, d_in, d_hidden, d_out", SHAPES)
def test_kernel_matches_plain(device, lead, d_in, d_hidden, d_out):
    args = _inputs(device, lead, d_in, d_hidden, d_out)
    before = fused_mlp.launches
    got = fused_mlp(*args)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert got.shape == (*lead, d_out)
    torch.testing.assert_close(got, fused_mlp_reference(*args),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead, d_in, d_hidden, d_out", SHAPES)
def test_hidden_kernel_matches_plain(device, lead, d_in, d_hidden, d_out):
    x, w0, b0, _, _ = _inputs(device, lead, d_in, d_hidden, d_out)
    before = fused_mlp_hidden.launches
    got = fused_mlp_hidden(x, w0, b0)
    torch.cuda.synchronize()
    assert fused_mlp_hidden.launches == before + 1
    assert got.shape == (*lead, d_hidden)
    torch.testing.assert_close(got, fused_mlp_hidden_reference(x, w0, b0),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lead, d_in, d_hidden, d_out", [
    ((1_024,), 4, 128, 32),      # training
    ((16, 125), 4, 128, 32),     # leading dims
    ((777,), 7, 100, 33),        # odd widths
])
def test_gradient_matches_plain_autograd(device, lead, d_in, d_hidden, d_out):
    """Under autograd fused_mlp goes through FusedMLPFunction: one forward
    launch, one hidden-recompute launch in the backward, and the five
    gradients of autograd through the plain forward."""
    args = [t.requires_grad_() for t in
            _inputs(device, lead, d_in, d_hidden, d_out)]
    g = torch.randn((*lead, d_out), device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    fwd, hidden = fused_mlp.launches, fused_mlp_hidden.launches
    got = torch.autograd.grad(fused_mlp(*args), args, g)
    torch.cuda.synchronize()
    assert (fused_mlp.launches, fused_mlp_hidden.launches) == (fwd + 1,
                                                              hidden + 1)
    want = torch.autograd.grad(fused_mlp_reference(*args), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_bad_inputs_raise(device):
    x, w0, b0, w1, b1 = _inputs(device, (64,), 4, 128, 32)
    with pytest.raises(TypeError, match="float32"):
        fused_mlp(x.double(), w0, b0, w1, b1)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp(x, w0.t().contiguous().t(), b0, w1, b1)
    with pytest.raises(ValueError, match="shapes"):
        fused_mlp(x, w0, b0, w1[:, :64].contiguous(), b1)
    with pytest.raises(RuntimeError, match="launch failed"):
        big = _inputs(device, (64,), 4, 4096, 32)
        fused_mlp(*big)
    with pytest.raises(RuntimeError, match="launch failed"):
        huge = _inputs(device, (64,), 64, 4096, 32)
        fused_mlp_hidden(*huge[:3])
