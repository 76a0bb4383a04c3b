"""The frozen count of work: the model's FLOPs against PyTorch's own
counter on the reference at a small row count, and the fused MLP's counts
against hand-worked values."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import common
from portbench.reference import dpivae as ref
from portbench.work import counts


def _setup(name, points, seed=3):
    cfg = common.read_json("configs", name)
    g = torch.Generator().manual_seed(seed)
    arrays = common.surrogate_arrays(cfg, "cpu")
    data = ref.sample_response(cfg, arrays, g, points)
    weights = ref.bulk_params(cfg, g)
    return cfg, ref.Reference(cfg, data, torch.device("cpu")), data, weights


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("name", ["beam_s_dpivae", "osc_s_dpivae"])
def test_loss_forward_flops(name):
    points, mc = 6, 3
    cfg, reference, data, weights = _setup(name, points)
    eps = torch.randn(mc, points, ref.nz(cfg))
    got = _counted(lambda: reference.loss_comps(weights, *data, eps, 0.1))
    assert got == counts.loss_forward_flops(cfg, points, mc)


@pytest.mark.parametrize("rows, flops, nbytes", [
    (262_144, 2_415_919_104, 37_767_808),   # a 512-point request, 512 MC
    (32_768, 301_989_888, 4_737_664),       # the validation, 512 x 64 MC
    (1_024, 9_437_184, 166_528),            # a training batch, 64 x 16 MC
])
def test_fused_mlp_counts_at_the_beams_shapes(rows, flops, nbytes):
    assert counts.fused_mlp(rows, 4, 128, 32) == (flops, nbytes)


def test_fused_mlp_hidden_and_least_time():
    assert counts.fused_mlp_hidden(1_024, 4, 128) == (1_048_576, 543_232)
    # 262,144 rows: memory bound, 37,767,808 B at 3.35 TB/s
    assert counts.least_seconds(2_415_919_104, 37_767_808) == pytest.approx(
        37_767_808 / 3.35e12)
    # compute bound when the bytes are few
    assert counts.least_seconds(495e9, 1) == pytest.approx(1e-3)


def test_train_step_flops_is_three_forwards_and_a_shared_validation():
    cfg = common.read_json("configs", "beam_s_dpivae")
    step = counts.train_step_flops(cfg)
    assert step == pytest.approx(
        3 * counts.loss_forward_flops(cfg, 64, 16)
        + counts.loss_forward_flops(cfg, 512, 64) / 10)
