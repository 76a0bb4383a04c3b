"""The device mesh on the card: ``make_mesh(1)`` comes up as a one-rank
NCCL group on cuda:0, and 20 data-parallel steps of ``train_model`` with
the fused-MLP kernels inside equal the same steps without a mesh (a sum
over one rank is the identity, so rtol/atol 1e-5 is an upper bound; the
expectation is 0).

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one. Run it on the card without the repository's conftest (which imports
jax):

    python -m pytest tests/test_torch_parallel_cuda.py --noconftest -q
"""

import pytest
import torch

from dpivae_tpu_torch import TrainConfig
from dpivae_tpu_torch.cases import get_case
from dpivae_tpu_torch.ops import fused_mlp as ops
from dpivae_tpu_torch.parallel import make_mesh
from dpivae_tpu_torch.train import init_params, setup_model, train_model
from dpivae_tpu_torch.utils.data import sample_response

pytestmark = pytest.mark.cuda

TOL = 1e-5
N_ITER = 20


@pytest.fixture
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(1, ("dp",))
    yield mesh
    mesh.close()


def test_one_rank_nccl_mesh(mesh):
    import torch.distributed as dist

    assert dist.get_backend() == "nccl" and mesh.backend == "nccl"
    assert mesh.device == torch.device("cuda", 0)
    assert mesh.shape == {"dp": 1} and mesh.world_size == 1


def test_dp_steps_equal_unsharded(mesh):
    """bench.py's workload on simple_beam / "dpivae" with use_pallas=True:
    each kernel launches inside the data-parallel step, and the logs and
    params equal the unsharded run's."""
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_pallas=True, use_seed=True, seed=0, n_iter=N_ITER)
    gen = torch.Generator(device="cuda").manual_seed(0)
    data_train = sample_response(case, gen, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    data_val = sample_response(case, gen, cfg.n_val,
                               sample_dist=case.gt_dist(), device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    params = init_params(cfg, model, device="cuda")

    def run(m):
        g = torch.Generator(device="cuda").manual_seed(1)
        return train_model(cfg, model, case, data_train, data_val,
                           params=params, generator=g, device="cuda", mesh=m)

    ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
    got_params, got = run(mesh)
    assert (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches) == (
        N_ITER + N_ITER // cfg.val_freq, N_ITER)
    want_params, want = run(None)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, equal_nan=True)
    for (name, a), b in zip(got_params.state_dict().items(),
                            want_params.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL, msg=name)
