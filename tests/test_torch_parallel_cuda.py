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

import numpy as np
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
# The two configurations each rank trains: "div", the early-stop config of
# test_dp_block_graph_equals_eager_mesh (10x learning rates, a one-sample
# validation, patience 1), which diverges before its stop; "steady", the
# preset's own rates, validation and patience, with no stop before n_iter.
RANK_CONFIGS = {
    "div": dict(patience=1, min_delta=0.0, n_mc_val=1,
                **{f"lr_{k}": 0.01 for k in ("e", "p", "dx", "dc", "dy")}),
    "steady": {},
}


def _rank_run(rank, world, port, out):
    """One spawned rank: simple_beam at bench.py's workload over a
    ``world``-rank "dp" mesh, in each configuration of RANK_CONFIGS on the
    same data, params and generators: "div" graphed and eager, "steady"
    graphed; rank 0 first trains each unsharded on its card alone. Saves
    every run's logs, params, launches and seconds."""
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
        base = TrainConfig().with_preset(case.presets["dpivae"]).replace(
            use_pallas=True, use_seed=True, seed=0, n_iter=N_ITER_RANKS)
        gen = torch.Generator(device=device).manual_seed(0)
        data_train = sample_response(case, gen, base.n_train,
                                     sample_dist=case.gt_dist(),
                                     device=device)
        data_val = sample_response(case, gen, base.n_val,
                                   sample_dist=case.gt_dist(), device=device)
        model = setup_model(base, case, data_train, device=device)
        params = init_params(base, model, device=device)
        saved = {}
        # The unsharded one-card runs ("ref"), graphed, on rank 0 alone and
        # first: the other ranks wait for them at the mesh's first
        # broadcast.
        runs = tuple((c, "ref", True, None) for c in RANK_CONFIGS
                     if rank == 0) + (
            ("div", "warm", True, mesh), ("div", "graph", True, mesh),
            ("div", "eager", False, mesh), ("steady", "graph", True, mesh))
        for config, name, cuda_graph, m in runs:
            cfg = base.replace(**RANK_CONFIGS[config])
            ops.fused_mlp.launches = ops.fused_mlp_hidden.launches = 0
            g = torch.Generator(device=device).manual_seed(1)
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            p, logs = train_model(cfg, model, case, data_train, data_val,
                                  params=params, generator=g, device=device,
                                  mesh=m, cuda_graph=cuda_graph)
            torch.cuda.synchronize(device)
            key = f"{config}:{name}"
            saved[f"{key}:seconds"] = np.float64(time.perf_counter() - t0)
            saved[f"{key}:launches"] = np.array(
                [ops.fused_mlp.launches, ops.fused_mlp_hidden.launches])
            for k, v in p.state_dict().items():
                saved[f"{key}:p:{k}"] = v.cpu().numpy()
            for f in ("train", "val", "train_active", "val_active"):
                saved[f"{key}:log:{f}"] = getattr(logs, f).cpu().numpy()
        np.savez(f"{out}{rank}.npz", **saved)
    finally:
        dist.destroy_process_group()


def _drift(got, want, vf, blocks):
    """Per block of training rows: the largest |difference| and the
    elements outside DP_LOG."""
    outside = ~np.isclose(got, want, equal_nan=True, **DP_LOG)
    return ", ".join(
        f"{b}: {np.nanmax(np.abs(got - want)[b * vf:(b + 1) * vf]):.1e}"
        f"/{int(outside[b * vf:(b + 1) * vf].sum())}" for b in range(blocks))


def test_dp_block_graph_over_every_card(tmp_path):
    """The block graph over a "dp" mesh of every card (at least two; the
    NCCL all-reduces between cards captured).

    In the diverging config ("div": 10x learning rates, a one-sample
    validation, patience 1, the early stop inside the replays) it holds
    what is exact: on every rank the graph equals the same mesh's eager
    loop bit for bit, every rank equals the others, and the stop falls at
    the unsharded one-card run's block on every rank. Its drift from the
    unsharded run is printed per block and not checked: the all-reduce
    sums the ranks' gradients in another order than one card sums its
    batch, which differs in the last bits, and this config amplifies that.
    On four and two H100s the rows stayed within 7.6e-6 of the unsharded
    run for 7 blocks, then drifted to 2.7e-3 (4 cards) and 1.8e-3 (2
    cards) in the last two, where it diverges, past DP_LOG.

    Against the unsharded run, within DP_LOG / DP_PARAM, it holds the
    steady config ("steady": the preset's own rates, validation and
    patience, n_iter 200, no stop before it) on the same data, params and
    generators: every rank's rows and params, the active rows all 200. At
    the preset's rates the port stays within 1.76e-5 of JAX for 50 steps
    (tests/test_torch_port_train.py), so a data, sharding or ordering
    fault would show here from step 0. Prints both runs' differences and
    the graphed and eager steps/s (run with -s to see them)."""
    import socket

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
    vf = 10

    # "div": exact across graph and eager and across ranks; the same stop.
    active = first["div:graph:log:train_active"]
    assert 10 < active.sum() < N_ITER_RANKS
    for r in ranks:
        for key, value in r.items():
            if key.startswith("div:graph:") and not key.endswith("seconds"):
                np.testing.assert_array_equal(
                    value, r["div:eager:" + key[10:]], key)
            if ":ref:" not in key and not key.endswith("seconds"):
                np.testing.assert_array_equal(value, first[key], key)
        for f in ("train_active", "val_active"):
            np.testing.assert_array_equal(r[f"div:graph:log:{f}"],
                                          first[f"div:ref:log:{f}"], f)
    print(f"\n{world} ranks, diverging config, against the unsharded run, "
          f"train rows per block (max |difference|, elements outside "
          f"DP_LOG; not checked): " + _drift(
              first["div:graph:log:train"], first["div:ref:log:train"], vf,
              -(-int(active.sum()) // vf)))

    # "steady": every rank against the unsharded one-card run.
    worst = {"log": 0.0, "p": 0.0}
    for r in ranks:
        for f in ("train_active", "val_active"):
            np.testing.assert_array_equal(r[f"steady:graph:log:{f}"],
                                          first[f"steady:ref:log:{f}"], f)
        assert r["steady:graph:log:train_active"].sum() == N_ITER_RANKS
        for f in ("train", "val"):
            got, want = r[f"steady:graph:log:{f}"], first[f"steady:ref:log:{f}"]
            worst["log"] = max(worst["log"],
                               float(np.nanmax(np.abs(got - want))))
        for key, want in first.items():
            if key.startswith("steady:ref:p:"):
                worst["p"] = max(worst["p"], float(np.abs(
                    r["steady:graph:p:" + key[13:]] - want).max()))
    print(f"{world} ranks, steady config, against the unsharded one-card "
          f"run: logs max abs difference {worst['log']:.3e} (rtol "
          f"{DP_LOG['rtol']}, atol {DP_LOG['atol']}), params "
          f"{worst['p']:.3e} (rtol {DP_PARAM['rtol']}, atol "
          f"{DP_PARAM['atol']}); per block: " + _drift(
              first["steady:graph:log:train"], first["steady:ref:log:train"],
              vf, N_ITER_RANKS // vf))
    for r in ranks:
        for f in ("train", "val"):
            np.testing.assert_allclose(r[f"steady:graph:log:{f}"],
                                       first[f"steady:ref:log:{f}"],
                                       err_msg=f, **DP_LOG)
        for key, want in first.items():
            if key.startswith("steady:ref:p:"):
                np.testing.assert_allclose(r["steady:graph:p:" + key[13:]],
                                           want, err_msg=key, **DP_PARAM)
    steps = int(active.sum())
    print(f"{world} ranks, {steps} steps to the diverging config's stop: "
          f"graphed " + " / ".join(
              f"{steps / r['div:graph:seconds']:.1f}" for r in ranks)
          + " steps/s, eager " + " / ".join(
              f"{steps / r['div:eager:seconds']:.1f}" for r in ranks)
          + f" (each rank; {torch.cuda.get_device_name(0)})")
