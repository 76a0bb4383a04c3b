"""The CUDA fused-MLP kernels against their plain PyTorch versions, on the
card: the forward, the hidden-layer recompute, and the gradients of
FusedMLPFunction against autograd through the plain forward; the Conv1d
encoder on the card against the same module in float64; and the loss's
gradients under ``remat_decode`` with the kernel against the plain
decode.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no jax, since the machine with the card has none;
run it there without the repository's conftest (which imports jax):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q

Tolerances as in tests/test_pallas_mlp.py: rtol 1e-5 / atol 1e-5 for
values, rtol 1e-4 / atol 1e-5 for gradients. The plain side is full f32
(TF32 off); the kernels compute layer 1 in f32 and the forward's layer 2
on the TF32 tensor cores in the 3xTF32 split, which keeps about 21 bits
of each product. The kernel's own error is measured only here and in
chip_smoke.py (tests/test_torch_port_ops.py shows, on an f32 model of
the arithmetic, that one TF32 pass misses 1e-5 and the split does not).
"""

import copy
import dataclasses

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.models.encoders import CNNEncoder
from dpivae_tpu_torch.ops.fused_mlp import (
    fused_mlp,
    fused_mlp_hidden,
    fused_mlp_hidden_reference,
    fused_mlp_on_path,
    fused_mlp_reference,
)
from dpivae_tpu_torch.train import init_params, setup_model
from dpivae_tpu_torch.utils.data import sample_response

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, lead, d_in, d_hidden, d_out, seed=0):
    """x standard normal, W0 and W1 at scale 0.3, biases 0.1; above
    H = 256, W1 at 0.3 * sqrt(256 / H), so that the outputs keep
    H = 256's spread. At 0.3 they spread as sqrt(H), and at H = 1,024 two
    f32 summation orders then differ by over atol 1e-5 where an output
    crosses zero (chip_smoke.py holds the kernel and plain each against
    float64 there)."""
    g = torch.Generator(device=device).manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=g, device=device)
    w1_scale = 0.3 * min(1.0, (256 / d_hidden) ** 0.5)
    return (f(*lead, d_in), f(d_hidden, d_in) * 0.3, f(d_hidden) * 0.1,
            f(d_out, d_hidden) * w1_scale, f(d_out) * 0.1)


SHAPES = [
    ((262_144,), 4, 128, 32),    # serving: 512 requests x 512 MC
    ((1_024,), 4, 128, 32),      # training: 16 MC x 64 batch
    ((1_000,), 4, 128, 32),      # ragged tail
    ((4_096,), 4, 256, 32),      # wider hidden
    ((16, 125), 4, 128, 32),     # leading dims
    ((777,), 7, 100, 33),        # odd widths: scalar stores, partial chunk
    ((500,), 6, 64, 80),         # d_out over several column tiles
    ((1,), 4, 128, 32),          # m16 tile edges: one row,
    ((15,), 4, 128, 32),         # ... one short of a tile,
    ((17,), 4, 128, 32),         # ... one past it,
    ((1_023,), 4, 128, 32),      # ... one short of the training shape
    ((1_024,), 8, 128, 64),      # damped_oscillator and bridge widths:
    ((32_768,), 8, 128, 64),     # ... their validation shape,
    ((262_144,), 8, 128, 64),    # ... and their serving shape
    ((3_000,), 4, 130, 32),      # H % 4 != 0: the hidden kernel's scalar tail
    ((65_536,), 4, 256, 32),     # 65,536 x (4 -> 256), the TPU "auto" band
    ((40_000,), 7, 100, 33),     # odd widths on the persistent staged path
    ((40_000,), 12, 130, 80),    # d_in bucket 16, three column tiles, staged
    ((300,), 16, 64, 8),         # the widest d_in bucket
    ((4_096,), 4, 512, 32),      # hidden widths of the scaling study:
    ((32_768,), 4, 512, 32),     # ... staged path at H = 512,
    ((4_096,), 4, 1_024, 32),    # ... H = 1,024, staged weights over one
    ((4_096,), 8, 1_024, 64),    # ... block's shared memory: split path,
    ((32_768,), 4, 1_024, 32),   # ... at every row count
    ((1_000,), 20, 128, 32),     # d_in over 16: runtime-length loops
    ((40_000,), 24, 100, 40),    # ... at a staged-path row count
    ((2_000,), 4, 1_100, 8),     # hidden kernel over 4 x 256 units: two passes
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
    ((1_024,), 8, 128, 64),      # damped_oscillator and bridge widths
    # scaling-study widths, at 1,024 rows: dW1 sums g * h over the rows,
    # and h is recomputed in another f32 order than plain's, so at 4,096
    # rows a sum that cancels to near zero misses atol 1e-5 by that alone
    ((1_024,), 4, 1_024, 32),
    ((1_024,), 8, 1_024, 64),
    ((1_024,), 4, 512, 32),
    ((1_000,), 20, 128, 32),     # d_in over 16
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
    # d_out over 65,535 column tiles of 32: more than the grid holds
    tall = _inputs(device, (1,), 4, 1, 65_535 * 32 + 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_mlp(*tall)
    # The staged path cannot hold H = 4,096's weights: forcing it raises.
    big = _inputs(device, (64,), 4, 4_096, 32)
    with pytest.raises(RuntimeError, match="launch failed"):
        fused_mlp_on_path(*big, staged=True)


@pytest.mark.parametrize("lead, d_in, d_hidden, d_out", [
    ((64,), 4, 4_096, 32),       # staged weights far over shared memory
    ((64,), 64, 4_096, 32),      # and d_in 64
])
def test_wide_layers_run(device, lead, d_in, d_hidden, d_out):
    """Widths whose weights no block can stage run all the same: the
    forward on its split path, the hidden kernel in several passes."""
    x, w0, b0, w1, b1 = _inputs(device, lead, d_in, d_hidden, d_out)
    w0 = w0 * (4 / d_in) ** 0.5   # pre-activations spread as at d_in 4
    torch.testing.assert_close(fused_mlp(x, w0, b0, w1, b1),
                               fused_mlp_reference(x, w0, b0, w1, b1),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused_mlp_hidden(x, w0, b0),
                               fused_mlp_hidden_reference(x, w0, b0),
                               rtol=1e-5, atol=1e-5)


# (rows, d_in, d_hidden, d_out, members, x's offset in floats)
PATH_CASES = [
    (1_024, 4, 128, 32, 1, 0),
    (8_192, 4, 128, 32, 1, 0),
    (16_384, 4, 128, 32, 1, 0),
    (32_768, 4, 128, 32, 1, 0),
    (16_384 + 37, 4, 128, 32, 1, 0),   # a ragged last 64-row tile
    (32_768, 8, 128, 64, 1, 0),        # d_out 64: one tile of the tiled path
    (16_411, 4, 128, 32, 3, 0),        # the member axis, per-member strides
    (16_384, 4, 128, 32, 1, 1),        # x a contiguous view 4 bytes on
]


@pytest.mark.parametrize("rows, d_in, d_hidden, d_out, members, offset",
                         PATH_CASES)
@pytest.mark.parametrize("staged", [False, True])
def test_both_paths_match_plain(device, rows, d_in, d_hidden, d_out, members,
                                offset, staged):
    """Either forward path, forced, and the launcher's own choice, at row
    counts on both sides of the switch between them, a ragged last tile,
    d_out 64, members with weights of their own, and x at a 4-byte offset.
    The tiled path's 16-byte loads and bulk copies need 16-byte alignment:
    forced onto that x it is refused, and the launcher takes the split
    path for it."""
    each = [_inputs(device, (rows,), d_in, d_hidden, d_out, seed=m)
            for m in range(members)]
    args = [torch.stack(a) if members > 1 else a[0] for a in zip(*each)]
    if offset:
        x = torch.empty(args[0].numel() + offset, device=device)
        args[0] = x[offset:].view_as(args[0]).copy_(args[0])
    want = fused_mlp_reference(*args)
    if offset and staged:
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_mlp_on_path(*args, staged=True)
    else:
        torch.testing.assert_close(fused_mlp_on_path(*args, staged=staged),
                                   want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fused_mlp(*args), want, rtol=1e-5, atol=1e-5)


def test_cnn_encoder_matches_float64_with_cudnn_tf32_on(device):
    """The Conv1d encoder at damped_oscillator's S-model widths (9 latents
    over nd_x 64, ch_in 1) with cuDNN's TF32 flag at its default, on:
    the encoder computes its convolutions as f32 matrix products, so the
    flag does not reach it and it stays within 1e-5 of float64."""
    module = CNNEncoder(9, 64, torch.Generator().manual_seed(0),
                        torch.device("cpu")).to(device)
    exact = copy.deepcopy(module).double()
    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(1)
                    ).to(device)
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got = module(x)
            want = exact(x.double())
    finally:
        torch.backends.cudnn.allow_tf32 = before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.float(), rtol=1e-5, atol=1e-5)


def test_remat_decode_gradients_match_plain_autograd(device):
    """simple_beam/"dpivae" at its training shape (64 points x 16 MC, the
    forward at 1,024 rows) with the kernel and ``remat_decode``: one loss
    and backward launch the forward twice (the backward recomputes the
    decode) and the hidden kernel once, and every gradient equals the
    same loss's with the kernel and no remat (rtol 1e-4 / atol 1e-5, the
    recompute repeats the same arithmetic) and with plain PyTorch's decode
    (rtol 1e-3 / atol 1e-5: the kernel's 3xTF32 forward differs from
    plain f32 by up to 1e-5, and a weight's gradient sums 1,024 rows)."""
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_pallas=True, remat_decode=True)
    gen = torch.Generator(device=device).manual_seed(0)
    data = sample_response(case, gen, cfg.n_train, sample_dist=case.gt_dist(),
                           device=device)
    model = setup_model(cfg, case, data, device=device)
    assert model.use_pallas and model.remat_decode
    params = init_params(cfg, model, device=device)
    batch = tuple(a[:cfg.n_batch] for a in data[:3])
    noise = {"z": torch.randn(cfg.n_mc_train, cfg.n_batch, 6, generator=gen,
                              device=device)}
    denom = cfg.n_batch * (case.nd_x + case.nd_c + case.nd_y)

    def grads(m):
        params.zero_grad(set_to_none=True)
        out = m.loss(params, *batch, n=cfg.n_mc_train,
                     grl_alpha=cfg.lambda_g0, noise=noise)
        (torch.sum(out[0]) / denom).backward()
        return {k: p.grad.clone() for k, p in params.named_parameters()}

    fwd, hidden = fused_mlp.launches, fused_mlp_hidden.launches
    got = grads(model)
    torch.cuda.synchronize()
    assert (fused_mlp.launches - fwd, fused_mlp_hidden.launches - hidden) \
        == (2, 1)
    kernel = grads(dataclasses.replace(model, remat_decode=False))
    plain = grads(dataclasses.replace(model, remat_decode=False,
                                      use_pallas=False))
    for name, g in got.items():
        torch.testing.assert_close(g, kernel[name], rtol=1e-4, atol=1e-5,
                                   msg=name)
        torch.testing.assert_close(g, plain[name], rtol=1e-3, atol=1e-5,
                                   msg=name)
