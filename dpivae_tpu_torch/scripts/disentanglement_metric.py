"""The disentanglement λ-sweep (counterpart of
scripts/1_disentanglement_metric.py).

    python -m dpivae_tpu_torch.scripts.disentanglement_metric \\
        --case damped_oscillator [--preset dpivae] [--n_runs 6] \\
        [--n_iter 20000] [--regressor linear] [--plots] [--device cpu]

The reference trains 11 λ x 6 seeds = 66 models one after another. Here
``sweep.train_sweep`` trains them in member-batched chunks on the device
(all 66 in one when the card's memory holds them), each member's metric
CSVs are written from its chunk's callback, ``chunks/`` keeps every
completed chunk so that a rerun into the same output resumes it, the
members' latents come from ``sweep_disentanglement_latents`` and the
probes from ``eval.probes.batched_probe_scores``, every probe of every
member at once on the device. ``--regressor`` takes the JAX script's four
names: ``linear`` and ``linear_jax`` are the same least squares (the
JAX script fits the first with scikit-learn, the second batched); ``mlp``
is scikit-learn's ``MLPRegressor(128, 128)`` fit with its tolerance stop
(``eval.probes.fit_mlp_probes_sklearn``); ``mlp_jax`` is the JAX
package's batched MLP(128, 128) probe, trained for ``--probe_epochs``
epochs. Writes ``<output>/<name>/``: ``args.json``,
``<member>/metrics/*.csv``, ``chunks/``, ``disentanglement_score.csv``
(columns set, gen_factor, score, idx_var, iter, lambda, with λ x 10^4 as
the JAX script writes it), ``timings.json`` (seconds per stage) and, with
--plots, ``disentanglement_score.png``: each factor's probe score of each
latent block against λ x 10^4 (symlog), mean ± sample std over the runs.

The JAX script draws that figure every time; here it takes --plots,
because the card's host has no matplotlib. --plots checks before any work
that matplotlib imports, and stops with an error naming it if not.

--n_devices N splits the members over a ("sweep",) mesh of N ranks, one
per device (``parallel.make_mesh``), as the JAX script does whenever the
flag is given: 1 is a one-rank mesh in this process, and N above 1 is
launched by ``python -m torch.distributed.run --standalone
--nproc_per_node N -m dpivae_tpu_torch.scripts.disentanglement_metric
--n_devices N ...`` (without it, it stops at parse time naming that
command). A sharded sweep keeps no chunks and has no chunk callback, as
in the JAX script: rank 0 writes the members' CSVs after training, then
runs the latents and probes and writes the scores; the other ranks wait
at a barrier and return None.

``--probe_workers`` is accepted for the JAX script's command lines and has
no effect: there is no process pool, the probes run batched.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dpivae_tpu_torch.parallel.mesh import launch_problem

MODULE = "dpivae_tpu_torch.scripts.disentanglement_metric"
SCALE_LAMBDA = 1e4
# λ·10^4 grid of the reference study
VAR_LIST = np.array(
    [1e4, 1e3, 1e2, 1e1, 1e0, 0.0, -1e0, -1e1, -1e2, -1e3, -1e4]
) / SCALE_LAMBDA
SCORE_COLUMNS = ("set", "gen_factor", "score", "idx_var", "iter", "lambda")


class Study(NamedTuple):
    """What ``main`` returns for in-process use."""

    config: object
    case: object
    result: object  # sweep.SweepResult, on the host
    rows: List[list]  # disentanglement_score.csv's rows
    failures: List[list]  # [i_lambda, j_run, member, lambda, reason]
    path: str
    timings: Dict[str, float]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--case", default="damped_oscillator")
    parser.add_argument("--preset", default="dpivae")
    parser.add_argument("--name", default="disentanglement")
    parser.add_argument("--n_runs", type=int, default=6)
    parser.add_argument("--n_iter", type=int, default=None)
    parser.add_argument("--regressor", default="linear",
                        choices=["linear", "mlp", "linear_jax", "mlp_jax"],
                        help="probe, all probes of all members batched on "
                             "the device: linear/linear_jax = least "
                             "squares; mlp = scikit-learn's "
                             "MLPRegressor(128, 128) fit (its tolerance "
                             "stop); mlp_jax = the JAX package's batched "
                             "MLP(128, 128), --probe_epochs epochs")
    parser.add_argument("--probe_epochs", type=int, default=300,
                        help="training epochs of the batched mlp_jax probe")
    parser.add_argument("--probe_workers", type=int, default=1,
                        help="accepted for the JAX script's command lines; "
                             "no effect (the probes run batched)")
    parser.add_argument("--n_train_regressor", type=int, default=2048)
    parser.add_argument("--n_test_regressor", type=int, default=2048)
    parser.add_argument("--cond", action="store_true")
    parser.add_argument("--use_mean", action="store_true")
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--output", default="output")
    parser.add_argument("--lambdas", type=float, nargs="*", default=None,
                        help="override the λ grid (raw values, not x1e4)")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="shard sweep members over a ('sweep',) mesh "
                             "of this many ranks; above 1 it needs "
                             "torch.distributed.run's launch")
    parser.add_argument("--latents_chunk", type=int, default=None,
                        help="members per batched latent extraction "
                             "(default: sweep.LATENTS_CHUNK_DEFAULT)")
    parser.add_argument("--plots", action="store_true",
                        help="also draw disentanglement_score.png (needs "
                             "matplotlib)")
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA (raises without "
                             "a card: pass cpu to run on the CPU)")
    return parser


def lambda_stats(lambdas, scores):
    """Per distinct λ, ascending (as pandas' ``groupby`` sorts its keys):
    (λ, the mean score, the sample std, ddof 1, NaN for a λ of one run)."""
    lambdas = np.asarray(lambdas, np.float64)
    scores = np.asarray(scores, np.float64)
    keys, group = np.unique(lambdas, return_inverse=True)
    counts = np.bincount(group, minlength=len(keys))
    mean = np.bincount(group, weights=scores, minlength=len(keys)) / counts
    dev = scores - mean[group]
    ss = np.bincount(group, weights=dev * dev, minlength=len(keys))
    std = np.full(len(keys), np.nan)
    many = counts > 1
    std[many] = np.sqrt(ss[many] / (counts[many] - 1))
    return keys, mean, std


def plot_scores(rows, case, path: str) -> None:
    """The score-vs-λ figure of ``rows`` (disentanglement_score.csv's,
    λ x 10^4): one panel per factor, one band per latent block."""
    from matplotlib import pyplot as plt

    from dpivae_tpu_torch.utils import CMAP_VARS

    colors = ["tab:blue", "tab:green", "tab:orange"]
    fig, ax = plt.subplots(len(case.factors), 1, sharex="col")
    ax = np.atleast_1d(ax)
    for i, factor in enumerate(case.factors):
        for color, block, label in zip(
                colors, ["zx", "zc", "zy"],
                [r"$z_\mathrm{x}$", r"$z_\mathrm{c}$", r"$z_\mathrm{y}$"]):
            picked = np.array([(r[5], r[2]) for r in rows
                               if r[1] == factor.name and r[0] == block],
                              np.float64).reshape(-1, 2)
            lam, score = picked[:, 0], picked[:, 1]
            keys, mean, std = lambda_stats(lam, score)
            ax[i].fill_between(keys, mean - std, mean + std, alpha=0.4,
                               color=color)
            ax[i].plot(keys, mean, alpha=1.0, label=label, color=color)
            ax[i].scatter(lam, score, alpha=0.9, s=4.0, color=color)
        ax[i].set_xscale("symlog", linthresh=1)
        ax[i].set_ylabel(factor.label, color=CMAP_VARS[factor.type])
    ax[-1].legend(bbox_transform=fig.transFigure, loc="lower center",
                  bbox_to_anchor=(0.5, 0.90), ncol=3)
    ax[-1].set_xlabel(r"$\lambda \cdot 10^4$")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _write_scores(path: str, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(SCORE_COLUMNS)
        writer.writerows(rows)


def main(argv: Optional[Sequence[str]] = None) -> Optional[Study]:
    parser = _parser()
    args = parser.parse_args(argv)
    problem = launch_problem(args.n_devices, MODULE)
    if problem:
        parser.error(problem)
    if args.plots:
        from dpivae_tpu_torch.viz.visualization import missing_plot_package

        missing = missing_plot_package(("matplotlib",))
        if missing is not None:
            parser.error(f"--plots needs {missing}, which does not import "
                         f"here; run without --plots")

    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.eval.probes import BLOCKS, batched_probe_scores
    from dpivae_tpu_torch.parallel import make_mesh
    from dpivae_tpu_torch.sweep import (
        sweep_disentanglement_latents,
        train_sweep,
    )
    from dpivae_tpu_torch.utils import resolve_device
    from dpivae_tpu_torch.utils.logging import save_logs_csv

    device = resolve_device(args.device)
    case = get_case(args.case)
    if args.preset not in case.presets:
        parser.error(f"unknown preset {args.preset!r} for case "
                     f"{args.case!r}; have {sorted(case.presets)}")
    cfg = TrainConfig().with_preset(case.presets[args.preset]).replace(
        use_seed=True, seed=args.seed)
    if args.n_iter is not None:
        cfg = cfg.replace(n_iter=args.n_iter)
    lambdas = np.asarray(
        args.lambdas if args.lambdas is not None else VAR_LIST, np.float32)

    mesh = None
    if args.n_devices:
        mesh = make_mesh(args.n_devices, ("sweep",), device=device)
        device = mesh.device
    writer = mesh is None or mesh.rank == 0
    path_output = os.path.join(args.output, args.name)
    if writer:
        os.makedirs(path_output, exist_ok=True)
        cfg.save_json(os.path.join(path_output, "args.json"))

    timings: Dict[str, float] = {}
    t_start = time.perf_counter()

    def mark(phase, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[phase] = round(time.perf_counter() - t0, 3)
        if writer:
            print(f"[phase] {phase}: {timings[phase]:.2f}s",
                  file=sys.stderr, flush=True)
        return time.perf_counter()

    n_members = len(lambdas) * args.n_runs
    if writer:
        print(f"Training {n_members} sweep members ({len(lambdas)} λ x "
              f"{args.n_runs} runs) on {device}"
              + (f", split over {mesh}" if mesh else "") + " ...")
    # The first device contact (context creation) apart from training.
    t0 = time.perf_counter()
    torch.zeros((), device=device).add_(1)
    t0 = mark("device_init", t0)

    # Each completed chunk's per-member CSVs go to two writer threads while
    # the next chunk trains.
    csv_pool = ThreadPoolExecutor(max_workers=2)
    csv_futures = []

    def on_chunk(start, params_chunk, logs_chunk):
        for j in range(logs_chunk.train.shape[0]):
            logs_m = type(logs_chunk)(*(a[j] for a in logs_chunk))
            csv_futures.append(csv_pool.submit(
                save_logs_csv, logs_m,
                os.path.join(path_output, str(start + j), "metrics")))

    try:
        result = train_sweep(
            cfg, case, lambdas=lambdas, n_runs=args.n_runs, seed=args.seed,
            mesh=mesh,
            # completed chunks persist; rerunning the same study resumes
            checkpoint_dir=(None if mesh
                            else os.path.join(path_output, "chunks")),
            chunk_callback=None if mesh else on_chunk, device=device)
        t0 = mark("train", t0)
        if not writer:
            mesh.barrier()
            mesh.close()
            return None
        if mesh is not None:
            # A sharded sweep streams no chunks: the members' CSVs go now.
            host = result.host()
            on_chunk(0, host.params, host.logs)
        print("Sweep training done; running disentanglement probes ...")

        latents = sweep_disentanglement_latents(
            cfg, case, result, args.n_train_regressor, args.n_test_regressor,
            cond=args.cond, use_mean=args.use_mean, seed=args.seed + 1,
            chunk_size=args.latents_chunk)
        t0 = mark("latents", t0)

        mlp_kwargs = ({"n_epochs": args.probe_epochs}
                      if args.regressor == "mlp_jax" else {})
        scores = batched_probe_scores(
            {b: latents[f"{b}_train"] for b in BLOCKS},
            {b: latents[f"{b}_test"] for b in BLOCKS},
            latents["z_train"], latents["z_test"],
            n_factors=len(case.factors), regressor=args.regressor,
            generator=torch.Generator(device=device).manual_seed(
                args.seed + 2),
            device=device, **mlp_kwargs)
        t0 = mark("probes", t0)

        rows, failures = [], []
        for m in range(result.n_members):
            i_lambda, j_run = divmod(m, args.n_runs)
            lam = float(result.lambdas[m])
            if not np.all(np.isfinite(scores[m])):
                # A diverged member is recorded, not written as NaN rows.
                failures.append([i_lambda, j_run, m, lam,
                                 "non-finite probe scores"])
                continue
            for i, factor in enumerate(case.factors):
                for k, block in enumerate(BLOCKS):
                    rows.append([block, factor.name, float(scores[m, i, k]),
                                 i_lambda, j_run, lam * SCALE_LAMBDA])
        for f in csv_futures:
            f.result()
    finally:
        csv_pool.shutdown()
    t0 = mark("member_csvs", t0)

    _write_scores(os.path.join(path_output, "disentanglement_score.csv"),
                  rows)
    if failures:
        print(f"{len(failures)} member probes failed: {failures}")
    if args.plots:
        plot_scores(rows, case,
                    os.path.join(path_output, "disentanglement_score.png"))
        t0 = mark("figure", t0)
    timings["total"] = round(time.perf_counter() - t_start, 3)
    with open(os.path.join(path_output, "timings.json"), "w") as f:
        json.dump(timings, f, indent=2)
    print(f"[phase] total: {timings['total']:.2f}s", file=sys.stderr,
          flush=True)
    print(f"Wrote {path_output}/disentanglement_score.csv and timings.json")
    if mesh is not None:
        mesh.barrier()
        mesh.close()
    return Study(cfg, case, result, rows, failures, path_output, timings)


if __name__ == "__main__":
    main()
