"""The device mesh on the card: ``make_mesh(1)`` comes up as a one-rank
NCCL group on cuda:0, and 20 data-parallel steps of ``train_model`` with
the fused-MLP kernels inside, replayed as a block graph with its NCCL
all-reduces captured, equal the same steps without a mesh (a sum over one
rank is the identity, so rtol/atol 1e-5 is an upper bound; the
expectation is 0) and the same mesh's eager run bit for bit.

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
# Ranks against the unsharded one-card run: the data-parallel bounds of
# tests/test_torch_parallel.py (DP_LOG, DP_PARAM), where the same
# comparison runs over gloo ranks on the CPU.
DP_LOG = dict(rtol=2e-4, atol=1e-5)
DP_PARAM = dict(rtol=5e-3, atol=1e-5)


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


def test_dp_block_graph_equals_eager_mesh(mesh):
    """The data-parallel block graph (cuda_graph=True, which a mesh no
    longer refuses) against the same mesh's eager loop, with an early
    stop inside the replays: bit for bit, the stop at the same block, the
    launches counted the same."""
    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_pallas=True, use_seed=True, seed=0, n_iter=200, patience=1,
        min_delta=0.0, n_mc_val=1,
        **{f"lr_{k}": 0.01 for k in ("e", "p", "dx", "dc", "dy")})
    gen = torch.Generator(device="cuda").manual_seed(0)
    data_train = sample_response(case, gen, cfg.n_train,
                                 sample_dist=case.gt_dist(), device="cuda")
    data_val = sample_response(case, gen, cfg.n_val,
                               sample_dist=case.gt_dist(), device="cuda")
    model = setup_model(cfg, case, data_train, device="cuda")
    params = init_params(cfg, model, device="cuda")

    def run(cuda_graph):
        ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
        g = torch.Generator(device="cuda").manual_seed(1)
        out = train_model(cfg, model, case, data_train, data_val,
                          params=params, generator=g, device="cuda",
                          mesh=mesh, cuda_graph=cuda_graph)
        return out, (ops.fused_mlp.launches, ops.fused_mlp_hidden.launches)

    (got_params, got), got_launches = run(True)
    (want_params, want), want_launches = run(False)
    assert got_launches == want_launches
    assert cfg.val_freq < got.stop_iter == want.stop_iter < cfg.n_iter
    for a, b in zip(got, want):
        assert torch.equal(torch.nan_to_num(a.float(), nan=7.0),
                           torch.nan_to_num(b.float(), nan=7.0))
    for a, b in zip(got_params.state_dict().values(),
                    want_params.state_dict().values()):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# Every card of the machine: a data-parallel block graph over NCCL ranks
# ----------------------------------------------------------------------

N_ITER_RANKS = 200


def _rank_run(rank, world, port, out):
    """One spawned rank: simple_beam at bench.py's workload over a
    ``world``-rank "dp" mesh with an early stop inside the replays (the
    config of test_dp_block_graph_equals_eager_mesh), graphed and eager;
    saves both runs' logs, params, launches and seconds."""
    import time

    import numpy as np
    import torch.distributed as dist

    torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        device = torch.device("cuda", rank)
        mesh = make_mesh(world, ("dp",), device=device)
        case = get_case("simple_beam")
        cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
            use_pallas=True, use_seed=True, seed=0, n_iter=N_ITER_RANKS,
            patience=1, min_delta=0.0, n_mc_val=1,
            **{f"lr_{k}": 0.01 for k in ("e", "p", "dx", "dc", "dy")})
        gen = torch.Generator(device=device).manual_seed(0)
        data_train = sample_response(case, gen, cfg.n_train,
                                     sample_dist=case.gt_dist(),
                                     device=device)
        data_val = sample_response(case, gen, cfg.n_val,
                                   sample_dist=case.gt_dist(), device=device)
        model = setup_model(cfg, case, data_train, device=device)
        params = init_params(cfg, model, device=device)
        saved = {}
        # The unsharded one-card run ("ref"), graphed, on rank 0 alone and
        # first: the other ranks wait for it at the mesh's first broadcast.
        runs = ((("ref", True, None),) if rank == 0 else ()) + (
            ("warm", True, mesh), ("graph", True, mesh),
            ("eager", False, mesh))
        for name, cuda_graph, m in runs:
            ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
            g = torch.Generator(device=device).manual_seed(1)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            p, logs = train_model(cfg, model, case, data_train, data_val,
                                  params=params, generator=g, device=device,
                                  mesh=m, cuda_graph=cuda_graph)
            torch.cuda.synchronize(device)
            saved[f"{name}:seconds"] = np.float64(time.perf_counter() - t0)
            saved[f"{name}:launches"] = np.array(
                [ops.fused_mlp.launches, ops.fused_mlp_hidden.launches])
            for k, v in p.state_dict().items():
                saved[f"{name}:p:{k}"] = v.cpu().numpy()
            for f in ("train", "val", "train_active", "val_active"):
                saved[f"{name}:log:{f}"] = getattr(logs, f).cpu().numpy()
        np.savez(f"{out}{rank}.npz", **saved)
    finally:
        dist.destroy_process_group()


def test_dp_block_graph_over_every_card(tmp_path):
    """The block graph over a "dp" mesh of every card (at least two; the
    NCCL all-reduces between cards captured): on every rank equal to the
    same mesh's eager loop bit for bit, every rank equal to the others,
    the early stop at the same block on all, and every rank against the
    unsharded graphed run on one card within DP_LOG / DP_PARAM, its stop
    included. Prints the graphed and the eager run's steps/s and the
    differences from the unsharded run per block (run with -s to see
    them). On two and on four H100s the stop is the unsharded run's and
    the rows stay within 1e-5 of it for the first 7 blocks, but in the
    last two, up to the stop, where the 10x learning rates diverge, they
    drift past DP_LOG (up to 2.7e-3): an open item of the roadmap."""
    import socket

    import numpy as np
    import torch.multiprocessing as mp

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    world = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "rank")
    mp.spawn(_rank_run, args=(world, port, out), nprocs=world)
    ranks = [dict(np.load(f"{out}{r}.npz")) for r in range(world)]
    first = ranks[0]
    active = first["graph:log:train_active"]
    assert 10 < active.sum() < N_ITER_RANKS
    for r in ranks:
        for key, value in r.items():
            if key.startswith("graph:") and not key.endswith("seconds"):
                np.testing.assert_array_equal(
                    value, r["eager:" + key[6:]], key)
                np.testing.assert_array_equal(value, first[key], key)
    # The drift from the unsharded run, printed before it is checked: per
    # block of training rows, the largest |difference| of rank 0's rows
    # and the rows outside DP_LOG.
    got, want = first["graph:log:train"], first["ref:log:train"]
    vf = 10
    outside = ~np.isclose(got, want, equal_nan=True, **DP_LOG)
    print(f"\n{world} ranks against the unsharded run, train rows per "
          f"block (max |difference|, elements outside DP_LOG): " + ", ".join(
              f"{b}: {np.nanmax(np.abs(got - want)[b * vf:(b + 1) * vf]):.1e}"
              f"/{int(outside[b * vf:(b + 1) * vf].sum())}"
              for b in range(-(-int(active.sum()) // vf))))
    worst = {"log": 0.0, "p": 0.0}
    for r in ranks:
        for f in ("train", "val"):
            worst["log"] = max(worst["log"], float(np.nanmax(
                np.abs(r[f"graph:log:{f}"] - first[f"ref:log:{f}"]))))
        for key, want in first.items():
            if key.startswith("ref:p:"):
                worst["p"] = max(worst["p"], float(
                    np.abs(r["graph:" + key[4:]] - want).max()))
    print(f"{world} ranks against the unsharded one-card run: logs max abs "
          f"difference {worst['log']:.3e} (rtol {DP_LOG['rtol']}, atol "
          f"{DP_LOG['atol']}), params {worst['p']:.3e} (rtol "
          f"{DP_PARAM['rtol']}, atol {DP_PARAM['atol']})")
    for r in ranks:
        for f in ("train_active", "val_active"):
            np.testing.assert_array_equal(r[f"graph:log:{f}"],
                                          first[f"ref:log:{f}"], f)
        for f in ("train", "val"):
            np.testing.assert_allclose(r[f"graph:log:{f}"],
                                       first[f"ref:log:{f}"], err_msg=f,
                                       **DP_LOG)
        for key, want in first.items():
            if key.startswith("ref:p:"):
                np.testing.assert_allclose(r["graph:" + key[4:]], want,
                                           err_msg=key, **DP_PARAM)
    steps = int(active.sum())
    print(f"{world} ranks, {steps} steps to the stop: graphed "
          + " / ".join(f"{steps / r['graph:seconds']:.1f}" for r in ranks)
          + " steps/s, eager "
          + " / ".join(f"{steps / r['eager:seconds']:.1f}" for r in ranks)
          + f" (each rank; {torch.cuda.get_device_name(0)})")
