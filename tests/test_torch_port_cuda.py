"""The CUDA fused-MLP kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no jax, since the machine with the card has none;
run it there without the repository's conftest (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerance rtol 1e-5 / atol 1e-5, as in tests/test_pallas_mlp.py: both
sides are full f32 (TF32 off) and differ only in summation order.
"""

import pytest
import torch

from dpivae_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

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


@pytest.mark.parametrize("lead, d_in, d_hidden, d_out", [
    ((262_144,), 4, 128, 32),    # serving: 512 requests x 512 MC
    ((1_024,), 4, 128, 32),      # training: 16 MC x 64 batch
    ((1_000,), 4, 128, 32),      # ragged tail
    ((4_096,), 4, 256, 32),      # wider hidden
    ((16, 125), 4, 128, 32),     # leading dims
    ((777,), 7, 100, 33),        # odd widths: scalar stores, partial chunk
    ((500,), 6, 64, 80),         # d_out over several column tiles
])
def test_kernel_matches_plain(device, lead, d_in, d_hidden, d_out):
    args = _inputs(device, lead, d_in, d_hidden, d_out)
    before = fused_mlp.launches
    got = fused_mlp(*args)
    torch.cuda.synchronize()
    assert fused_mlp.launches == before + 1
    assert got.shape == (*lead, d_out)
    torch.testing.assert_close(got, fused_mlp_reference(*args),
                               rtol=1e-5, atol=1e-5)


def test_gradient_request_raises(device):
    x, w0, b0, w1, b1 = _inputs(device, (64,), 4, 128, 32)
    w0.requires_grad_()
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_mlp(x, w0, b0, w1, b1)
    with torch.no_grad():
        fused_mlp(x, w0, b0, w1, b1)


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
