"""The figures' data on the card: the prediction figures' data with the
fused-MLP forward kernel (use_pallas=True) against the same weights
through the plain decode, at the config's 2,000 responses per traversal
point, for simple_beam/"dpivae" (4 -> 128 -> 32) and bridge/"DPIVAE-A"
(8 -> 128 -> 64, cond); one forward launch per traversal point; and the
posterior frames, which run no decoder_x, with no launch.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. The file imports no jax; run it on the card without the repository's
conftest:

    python -m pytest tests/test_torch_viz_cuda.py --noconftest -q

Tolerance: rtol 1e-5 / atol 1e-5, as tests/test_torch_port_cuda.py holds
the kernel (the statistics average 2,000 rows each).
"""

import dataclasses

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops.fused_mlp import fused_mlp
from dpivae_tpu_torch.train import init_params, setup_model
from dpivae_tpu_torch.utils.data import sample_response
from dpivae_tpu_torch.viz.visualization import (
    marginal_post_data,
    pred_decomposition,
)

pytestmark = pytest.mark.cuda

RTOL = ATOL = 1e-5
N_PLOT, N_INTERP = 2_000, 5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _models(device, case_name, preset):
    case = get_case(case_name)
    cfg = TrainConfig().with_preset(case.presets[preset]).replace(
        use_pallas=True, use_seed=True, seed=0)
    gen = torch.Generator(device=device).manual_seed(0)
    data = sample_response(case, gen, cfg.n_train, sample_dist=case.gt_dist(),
                           device=device)
    model = setup_model(cfg, case, data, device=device)
    params = init_params(cfg, model, device=device)
    assert model.use_pallas is True
    return cfg, case, model, dataclasses.replace(model, use_pallas=False), \
        params


@pytest.mark.parametrize("case_name, preset, cond", [
    ("simple_beam", "dpivae", False), ("bridge", "DPIVAE-A", True)])
def test_prediction_figure_data_kernel_vs_plain(device, case_name, preset,
                                                cond):
    cfg, case, model, plain, params = _models(device, case_name, preset)
    for idx in range(len(case.factors)):
        fused_mlp.launches = 0
        got, sweep = pred_decomposition(model, params, cfg, case, idx,
                                        N_INTERP, N_PLOT, cond, key=idx,
                                        device=device)
        assert fused_mlp.launches == N_INTERP
        want, _ = pred_decomposition(plain, params, cfg, case, idx, N_INTERP,
                                     N_PLOT, cond, key=idx, device=device)
        assert len(sweep) == N_INTERP
        for name, g in got.items():
            assert g.shape == (N_INTERP, case.nd_x)
            assert torch.isfinite(g).all(), name
            torch.testing.assert_close(g, want[name], rtol=RTOL, atol=ATOL)


def test_posterior_frames_launch_nothing(device):
    cfg, case, model, _, params = _models(device, "simple_beam", "dpivae")
    fused_mlp.launches = 0
    (zx, zc, zy), _ = marginal_post_data(model, params, cfg, case, 0,
                                         N_INTERP, N_PLOT, device=device)
    assert fused_mlp.launches == 0
    assert zx.shape == (N_INTERP, N_PLOT, case.nz_x)
    assert zc.shape == (N_INTERP, N_PLOT, cfg.nz_c)
    assert zy.shape == (N_INTERP, N_PLOT, cfg.nz_y)
