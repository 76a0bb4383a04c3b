"""Multi-device training with the port's mesh (counterpart of
examples/multichip_sweep.py), in three parts:

1. **Sweep-member sharding**: a λ-sweep whose members are split over a
   ("sweep",) mesh; each rank trains its own and the results are
   gathered (``train_sweep(mesh=...)``).
2. **Data parallelism**: one ``train_model(mesh=...)`` run whose
   minibatches and validation pass are split over a ("dp",) mesh, params
   replicated and the gradients summed in one collective a step; its
   validation ELBO must fall.
3. **Both at once**: a 2-D ("sweep", "dp") mesh, members over one axis
   and each member's batches over the other.

Rank 0 prints each part's result and wall seconds. On cards every part
trains as a run without a mesh does, one CUDA graph replayed per
validation block; in parts 2 and 3 the graph holds the "dp" axis's
all-reduces.

One process per device. On a node of cards, launch one rank per card:

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m dpivae_tpu_torch.examples.multichip_sweep --n_devices N

On one card, ``--n_devices 1`` runs in this process (a one-rank NCCL
mesh). Without a card, ``--device cpu`` spawns ``--n_devices`` gloo ranks
with ``torch.multiprocessing.spawn`` (the port's form of the JAX
example's virtual CPU devices):

    python -m dpivae_tpu_torch.examples.multichip_sweep --n_devices 2 \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Sequence

import numpy as np
import torch

from dpivae_tpu_torch.parallel.mesh import launch_problem, launched_world_size

MODULE = "dpivae_tpu_torch.examples.multichip_sweep"


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n_devices", type=int, default=8)
    parser.add_argument("--n_iter", type=int, default=200)
    parser.add_argument("--device", default=None,
                        help="cuda (the default: one rank per card) or cpu "
                             "(gloo ranks, spawned here unless launched)")
    return parser


def run(n_devices: int, n_iter: int, device=None) -> None:
    """The three parts on this rank; every rank of the job calls it."""
    from dpivae_tpu_torch import TrainConfig
    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.parallel import make_mesh
    from dpivae_tpu_torch.sweep import train_sweep
    from dpivae_tpu_torch.train import init_params, setup_model, train_model
    from dpivae_tpu_torch.utils.data import sample_response

    case = get_case("simple_beam")
    # The JAX example's sizes; validation every 20 steps, or every tenth
    # of a shorter run, so that it validates more than once.
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, n_train=256, n_val=64, n_batch=32, n_iter=n_iter,
        val_freq=max(1, min(20, n_iter // 10)), n_mc_train=4, n_mc_val=4)

    def seconds(t0):
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        return time.perf_counter() - t0

    # --- 1. λ-sweep with the member axis split over every rank ----------
    mesh = first_mesh = make_mesh(n_devices, axes=("sweep",), device=device)
    first = mesh.rank == 0
    lambdas = np.linspace(-1.0, 1.0, n_devices)
    t0 = time.perf_counter()
    res = train_sweep(cfg, case, lambdas=lambdas, n_runs=1, mesh=mesh,
                      device=mesh.device)
    final = res.logs.val[:, -1, 0].cpu().numpy()
    if first:
        print(f"sweep over {mesh.shape}: final val losses {final.round(3)} "
              f"({seconds(t0):.2f} s)")
    assert np.all(np.isfinite(final))

    # --- 2. one training, data-parallel over the same ranks -------------
    mesh = make_mesh(n_devices, axes=("dp",), device=device)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    dtr = sample_response(case, gen, cfg.n_train, sample_dist=case.gt_dist(),
                          device=mesh.device)
    dva = sample_response(case, gen, cfg.n_val, sample_dist=case.gt_dist(),
                          device=mesh.device)
    model = setup_model(cfg, case, dtr, device=mesh.device)
    params = init_params(cfg, model, device=mesh.device)
    t0 = time.perf_counter()
    params, logs = train_model(cfg, model, case, dtr, dva, params=params,
                               device=mesh.device, mesh=mesh)
    elbo = logs.scalars("ELBO_val")[1]
    if first:
        print(f"dp over {mesh.shape}: val ELBO {elbo[0]:.3f} -> "
              f"{elbo[-1]:.3f} ({seconds(t0):.2f} s)")
    assert elbo[-1] < elbo[0], "training should reduce val ELBO"

    # --- 3. both at once: a 2-D (sweep x dp) mesh -----------------------
    n_sweep = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, axes=("sweep", "dp"),
                     shape=(n_sweep, n_devices // n_sweep), device=device)
    lambdas = np.linspace(-1.0, 1.0, n_sweep)
    t0 = time.perf_counter()
    res = train_sweep(cfg, case, lambdas=lambdas, n_runs=1, mesh=mesh,
                      device=mesh.device)
    final = res.logs.val[:, -1, 0].cpu().numpy()
    if first:
        print(f"sweep x dp over {mesh.shape}: final val losses "
              f"{final.round(3)} ({seconds(t0):.2f} s)")
    assert np.all(np.isfinite(final))
    mesh.barrier()
    first_mesh.close()  # the process group, if the first mesh started it
    if first:
        print("multichip_sweep OK")


def _spawned(rank: int, n_devices: int, n_iter: int, store: str) -> None:
    """One gloo rank of a CPU job started by ``torch.multiprocessing``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n_devices),
                            rank=rank, world_size=n_devices)
    try:
        run(n_devices, n_iter, "cpu")
    finally:
        dist.destroy_process_group()


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = _parser()
    args = parser.parse_args(argv)
    on_cpu = args.device is not None and torch.device(args.device).type == "cpu"
    if on_cpu and args.n_devices > 1 and launched_world_size() is None:
        import torch.multiprocessing as mp

        # Import by package path, so that the spawned ranks find _spawned
        # however this module was started.
        from dpivae_tpu_torch.examples import multichip_sweep

        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(multichip_sweep._spawned,
                     args=(args.n_devices, args.n_iter,
                           os.path.join(tmp, "store")),
                     nprocs=args.n_devices)
        return
    problem = launch_problem(args.n_devices, MODULE)
    if problem:
        parser.error(problem)
    run(args.n_devices, args.n_iter, args.device)


if __name__ == "__main__":
    main()
