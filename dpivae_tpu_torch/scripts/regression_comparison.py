"""The transfer study on the bridge case (counterpart of
scripts/2_regression_comparison.py):

    python -m dpivae_tpu_torch.scripts.regression_comparison \\
        [--case bridge] [--dist_type extrapolation] [--n_runs 6] \\
        [--n_iter 20000] [--baselines sklearn] [--plot_domain] \\
        [--device cuda]

The physics-latent box splits into 4 quadrant domains
(``utils.priors.make_square_dist``); each fold trains on a 3-quadrant
mixture and tests on the held-out quadrant (interpolation), or the other
way round (extrapolation). Member m = run x 4 + domain draws its train,
validation and test sets from its own generator, seeded from (seed, m).
Each preset, "DPIVAE-A" (P model) then "DPIVAE-B" (S model), trains its
(run x domain) grid of members through ``sweep.train_sweep_data`` from a
stream of its own (completed chunks persist under ``chunks_<preset>/``
and a rerun into the same output resumes them), then ``sweep_predict_y``
gives every member's posterior-mean y over n_mc_test samples. The
LIN/GPR/MLP baselines follow, and the metrics aggregate into the JAX
script's mean ± std tables.

Both --baselines choices are the port's own torch fits, named after the
JAX script's: "sklearn" (the default) fits member by member through
``eval.run_comparison``, its GPR in float64 by L-BFGS-B as
scikit-learn's ``GaussianProcessRegressor`` fits it; "jax" fits every
member of each family at once through ``eval.run_comparison_batched``,
the JAX package's batched design, whose float32 GPR with a clamped BFGS
stops short of scikit-learn's optimum on many extrapolation folds. LIN
agrees between the two; the MLP is the port's batched MLP (a fixed 300
epochs) in both, not scikit-learn's early-stopped MLPRegressor.

Writes ``<output>/<name>/``: ``settings/args.json`` (the base config),
``metrics/raw_metrics.csv`` (columns Run, Domain, Model, R2, MSE, MAE, in
the order pandas writes the JAX script's MultiIndex frame),
``metrics/table.tex`` (mean ± std per (domain, model) and per model, the
sample std, as pandas' ``to_latex`` formats them) and ``timings.json``
(seconds of device_init, train_<preset>, predict_<preset>, baselines and
total). Nothing here needs pandas. --plot_domain also draws
``figures/domains.png``: the physics factors of the first run's four
folds, train against test (it needs matplotlib, checked before any work).

It runs on the CUDA device unless --device says otherwise. --n_devices N
splits each preset's members over a ("sweep",) mesh of N ranks, one per
device (``parallel.make_mesh``), as the JAX script does whenever the flag
is given; N must divide the member count (runs x 4 domains). 1 is a
one-rank mesh in this process; N above 1 is launched by ``python -m
torch.distributed.run --standalone --nproc_per_node N -m
dpivae_tpu_torch.scripts.regression_comparison --n_devices N ...``
(without it, it stops at parse time naming that command). With a mesh
no chunks are kept, the prediction is split over the mesh too, and rank 0
alone fits the baselines and writes the results; the other ranks wait at
a barrier and return None.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import sys
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dpivae_tpu_torch.parallel.mesh import launch_problem

MODULE = "dpivae_tpu_torch.scripts.regression_comparison"
N_DOMAINS = 4
PRESETS = ("DPIVAE-A", "DPIVAE-B")
CSV_COLUMNS = ("Run", "Domain", "Model", "R2", "MSE", "MAE")
# Stream tags of the JAX script's fold_in keys: each preset's training,
# the prediction and the batched baselines.
_TRAIN_TAG, _PREDICT_TAG, _BASELINE_TAG = 10_000, 999, 777


class Transfer(NamedTuple):
    """What ``main`` returns for in-process use."""

    config: object
    case: object
    results: Dict[str, object]  # preset -> sweep.SweepResult
    data: tuple  # (train, val, test), each (x, c, y, z) stacked on members
    rows: List[tuple]  # raw_metrics.csv's rows
    path: str
    timings: Dict[str, float]


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--case", default="bridge")
    parser.add_argument("--name", default="transfer")
    parser.add_argument("--dist_type", default="extrapolation",
                        choices=["interpolation", "extrapolation"])
    parser.add_argument("--n_runs", type=int, default=6)
    parser.add_argument("--n_iter", type=int, default=None)
    parser.add_argument("--n_train", type=int, default=None)
    parser.add_argument("--n_val", type=int, default=None)
    parser.add_argument("--n_test", type=int, default=None)
    parser.add_argument("--cond", action="store_true")
    parser.add_argument("--plot_domain", action="store_true",
                        help="also draw figures/domains.png (needs "
                             "matplotlib)")
    parser.add_argument("--skip_baselines", action="store_true")
    parser.add_argument(
        "--baselines", default="sklearn", choices=["sklearn", "jax"],
        help="how the LIN/GPR/MLP baselines are fitted; both are the port's "
             "own torch fits (eval/baselines.py), named after the JAX "
             "script's choices: 'sklearn' fits member by member, as the "
             "reference's serial loop does, its GPR in float64 by L-BFGS-B "
             "as scikit-learn fits it; 'jax' fits all members of each "
             "family at once, its GPR in float32 by a clamped BFGS (the "
             "JAX package's batched design)")
    parser.add_argument("--seed", type=int, default=123)
    parser.add_argument("--output", default="output")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="shard sweep members over a ('sweep',) mesh "
                             "of this many ranks (it must divide the member "
                             "count); above 1 it needs torch.distributed."
                             "run's launch")
    parser.add_argument("--device", default=None,
                        help="torch device; default CUDA (raises without "
                             "a card: pass cpu to run on the CPU)")
    return parser


def plot_domains(case, z_train, z_test, path: str) -> None:
    """The domains figure: for each of the first run's folds, its train
    and test factors z (each (N_DOMAINS, n, n_factors)) over the first two
    physics factors, with the fold's mean as cross hairs."""
    from matplotlib import pyplot as plt

    labels_x = [f.label for f in case.factors if f.type == "x"]
    fig, ax = plt.subplots(1, N_DOMAINS, figsize=(12, 3),
                           layout="compressed")
    for i in range(N_DOMAINS):
        ax[i].scatter(z_train[i][:, 0], z_train[i][:, 1], s=4.0)
        ax[i].scatter(z_test[i][:, 0], z_test[i][:, 1], s=4.0)
        ax[i].set_xlabel(labels_x[0], fontsize=14)
        ax[i].set_title(f"Sub-case {i + 1}")
        allz = np.vstack((z_train[i][:, :2], z_test[i][:, :2]))
        ax[i].axvline(x=allz[:, 0].mean(), color="black")
        ax[i].axhline(y=allz[:, 1].mean(), color="black")
    ax[0].set_ylabel(labels_x[1], fontsize=14)
    fig.savefig(path)
    plt.close(fig)


def _stream_seed(seed: int, tag: int) -> int:
    """A seed of its own for the stream ``tag`` of the study's seed."""
    return int(np.random.SeedSequence([int(seed), int(tag)]).generate_state(
        1, dtype=np.uint32)[0])


# ----------------------------------------------------------------------
# Aggregation and the two files pandas writes in the JAX script
# ----------------------------------------------------------------------

def metric_rows(metrics: Dict[int, Dict[int, Dict[str, dict]]],
                n_runs: int) -> List[tuple]:
    """(run, domain, model, R2, MSE, MAE) rows, each metric the mean over
    output dims, in the order of the JAX script's MultiIndex: runs, then
    domains sorted, then models in the order of run 0's first domain."""
    domains = sorted(metrics[0])
    models = list(metrics[0][domains[0]])
    return [(j, i, name, *(float(np.mean(metrics[j][i][name][k]))
                           for k in ("R2", "MSE", "MAE")))
            for j in range(n_runs) for i in domains for name in models]


def _csv_float(v: float) -> str:
    return "" if math.isnan(v) else repr(float(v))


def write_raw_metrics(path: str, rows: Sequence[tuple]) -> None:
    """``raw_metrics.csv`` as pandas' ``to_csv`` writes the JAX script's
    frame: the index columns, then each float by its shortest repr."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(CSV_COLUMNS)
        for j, i, name, *values in rows:
            writer.writerow([j, i, name, *map(_csv_float, values)])


def _mean_std(values) -> tuple:
    """Mean and sample std (ddof 1, NaN for one value), as pandas'
    ``agg(["mean", "std"])``."""
    a = np.asarray(values, np.float64)
    mean = math.fsum(a) / len(a)
    std = (math.sqrt(math.fsum((a - mean) ** 2) / (len(a) - 1))
           if len(a) > 1 else math.nan)
    return mean, std


def aggregate(rows: Sequence[tuple], by: Sequence[str]) -> List[tuple]:
    """The JAX script's ``groupby(level=by).agg(["mean", "std"])`` of the
    rows, keys sorted, formatted as its ``fmt``: (*keys, "R2 cell",
    "MSE cell"), each cell "mean $\\pm$ std" to 3 decimals."""
    pos = {"Domain": 1, "Model": 2}
    groups: Dict[tuple, List[tuple]] = {}
    for row in rows:
        groups.setdefault(tuple(row[pos[b]] for b in by), []).append(row)
    out = []
    for key in sorted(groups):
        cells = []
        for col in (3, 4):  # R2, MSE
            mean, std = _mean_std([r[col] for r in groups[key]])
            cells.append(f"{mean:.3f} $\\pm$ {std:.3f}")
        out.append((*key, *cells))
    return out


def latex_table(header: Sequence[str], table: Sequence[tuple],
                caption: str) -> str:
    """A table as pandas' ``DataFrame.to_latex(index=False,
    caption=caption, position="htb!")`` writes it: integer columns right-,
    the others left-aligned, booktabs rules."""
    align = "".join("r" if isinstance(v, (int, np.integer)) else "l"
                    for v in table[0])
    lines = ["\\begin{table}[htb!]", f"\\caption{{{caption}}}",
             f"\\begin{{tabular}}{{{align}}}", "\\toprule",
             " & ".join(header) + " \\\\", "\\midrule"]
    lines += [" & ".join(str(v) for v in row) + " \\\\" for row in table]
    lines += ["\\bottomrule", "\\end{tabular}", "\\end{table}", ""]
    return "\n".join(lines)


def tables_tex(rows: Sequence[tuple], dist_type: str) -> str:
    """``table.tex``: the per-(domain, model) and the per-model tables."""
    caption = f"Comparison of model performance metrics in {dist_type}"
    return (latex_table(("Domain", "Model", "R2", "MSE"),
                        aggregate(rows, ("Domain", "Model")), caption)
            + "\n"
            + latex_table(("Model", "R2", "MSE"), aggregate(rows, ("Model",)),
                          caption + " (avg over domains)"))


# ----------------------------------------------------------------------
# The study
# ----------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> Optional[Transfer]:
    parser = _parser()
    args = parser.parse_args(argv)
    n_members = args.n_runs * N_DOMAINS
    if args.n_devices and n_members % args.n_devices:
        parser.error(f"--n_devices must divide the member count "
                     f"({n_members} = {args.n_runs} runs x {N_DOMAINS} "
                     f"domains)")
    problem = launch_problem(args.n_devices, MODULE)
    if problem:
        parser.error(problem)
    if args.plot_domain:
        from dpivae_tpu_torch.viz.visualization import missing_plot_package

        missing = missing_plot_package(("matplotlib",))
        if missing is not None:
            parser.error(f"--plot_domain needs {missing}, which does not "
                         f"import here; run without --plot_domain")

    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.eval import run_comparison, run_comparison_batched
    from dpivae_tpu_torch.parallel import make_mesh
    from dpivae_tpu_torch.sweep import sweep_predict_y, train_sweep_data
    from dpivae_tpu_torch.train.train import member_generators
    from dpivae_tpu_torch.utils import resolve_device
    from dpivae_tpu_torch.utils.data import sample_response
    from dpivae_tpu_torch.utils.metrics import regression_metrics
    from dpivae_tpu_torch.utils.priors import make_square_dist

    device = resolve_device(args.device)
    case = get_case(args.case)
    base_cfg = TrainConfig().replace(use_seed=True, seed=args.seed)
    overrides = {k: getattr(args, k)
                 for k in ("n_iter", "n_train", "n_val", "n_test")
                 if getattr(args, k) is not None}
    if overrides:
        base_cfg = base_cfg.replace(**overrides)

    mesh = None
    if args.n_devices:
        mesh = make_mesh(args.n_devices, ("sweep",), device=device)
        device = mesh.device
    writer = mesh is None or mesh.rank == 0
    path_output = os.path.join(args.output, args.name)
    if writer:
        for sub in ("metrics", "settings") + (
                ("figures",) if args.plot_domain else ()):
            os.makedirs(os.path.join(path_output, sub), exist_ok=True)
        base_cfg.save_json(os.path.join(path_output, "settings",
                                        "args.json"))

    timings: Dict[str, float] = {}
    t_study = time.perf_counter()

    def mark(phase, t0):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[phase] = round(time.perf_counter() - t0, 3)
        if writer:
            print(f"[phase] {phase}: {timings[phase]:.2f}s",
                  file=sys.stderr, flush=True)
        return time.perf_counter()

    # The first device contact (context creation) apart from the rest.
    t0 = time.perf_counter()
    torch.zeros((), device=device).add_(1)
    t0 = mark("device_init", t0)

    # Domain splits, then every member's (train, val, test) from its own
    # generator: member = j_run * N_DOMAINS + i_dom.
    if args.dist_type == "interpolation":
        dists_train, dists_test = make_square_dist(case)
    else:
        dists_test, dists_train = make_square_dist(case)
    splits = ([], [], [])
    for m, g in enumerate(member_generators(args.seed, range(n_members),
                                            device)):
        i = m % N_DOMAINS
        for split, n, dist in zip(
                splits, (base_cfg.n_train, base_cfg.n_val, base_cfg.n_test),
                (dists_train[i], dists_train[i], dists_test[i])):
            split.append(sample_response(case, g, n, sample_dist=dist,
                                         device=device))
    data_train, data_val, data_test = (
        tuple(torch.stack([d[k] for d in split]) for k in range(4))
        for split in splits)

    if args.plot_domain and writer:
        plot_domains(case, data_train[3][:N_DOMAINS].cpu().numpy(),
                     data_test[3][:N_DOMAINS].cpu().numpy(),
                     os.path.join(path_output, "figures", "domains.png"))

    metrics = {j: {i + 1: {} for i in range(N_DOMAINS)}
               for j in range(args.n_runs)}

    def record(m, by_model):
        j, i = divmod(m, N_DOMAINS)
        metrics[j][i + 1].update(by_model)

    y_test = data_test[2].cpu().numpy()
    results = {}
    for preset_idx, preset in enumerate(PRESETS):
        cfg = base_cfg.with_preset(case.presets[preset])
        if writer:
            print(f"Training {preset}: {n_members} members ({args.n_runs} "
                  f"runs x {N_DOMAINS} domains) batched on {device}"
                  + (f", split over {mesh}" if mesh else "") + " ...")
        result = train_sweep_data(
            cfg, case, np.full(n_members, cfg.lambda_g0, np.float32),
            data_train, data_val,
            seed=_stream_seed(args.seed, _TRAIN_TAG + preset_idx),
            mesh=mesh,
            # completed chunks persist: a rerun into the same output
            # resumes them
            checkpoint_dir=(None if mesh else
                            os.path.join(path_output, f"chunks_{preset}")),
            device=device)
        results[preset] = result
        t0 = mark(f"train_{preset}", t0)
        # Posterior-mean y over n_mc_test samples, y alone sampled
        y_pred = sweep_predict_y(
            cfg, case, result, data_train, data_test[0], data_test[1],
            cond=args.cond, n=cfg.n_mc_test,
            seed=_stream_seed(args.seed, _PREDICT_TAG),
            mesh=mesh).cpu().numpy()
        for m in range(n_members):
            record(m, {preset: regression_metrics(y_test[m], y_pred[m])})
        t0 = mark(f"predict_{preset}", t0)

    if not writer:
        mesh.barrier()
        mesh.close()
        return None
    if not args.skip_baselines:
        seed = _stream_seed(args.seed, _BASELINE_TAG)
        if args.baselines == "jax":
            by_member, _ = run_comparison_batched(
                data_train, data_test,
                generator=torch.Generator(device=device).manual_seed(seed),
                device=device)
            for m, by_model in enumerate(by_member):
                record(m, by_model)
        else:
            for m, g in enumerate(member_generators(seed, range(n_members),
                                                    device)):
                j, i = divmod(m, N_DOMAINS)
                print(f"Baselines: run {j + 1}/{args.n_runs} domain "
                      f"{i + 1}/{N_DOMAINS}")
                by_model, _ = run_comparison(
                    base_cfg, case, tuple(a[m] for a in data_train),
                    tuple(a[m] for a in data_test), generator=g,
                    device=device)
                record(m, by_model)
        t0 = mark("baselines", t0)

    rows = metric_rows(metrics, args.n_runs)
    write_raw_metrics(os.path.join(path_output, "metrics", "raw_metrics.csv"),
                      rows)
    with open(os.path.join(path_output, "metrics", "table.tex"), "w") as f:
        f.write(tables_tex(rows, args.dist_type))
    for key, *cells in aggregate(rows, ("Model",)):
        r2, mse = (cell.replace(" $\\pm$ ", " ± ") for cell in cells)
        print(f"{key:10s} R2 {r2}  MSE {mse}")
    timings["total"] = round(time.perf_counter() - t_study, 3)
    with open(os.path.join(path_output, "timings.json"), "w") as f:
        json.dump(timings, f, indent=2)
    print(f"[phase] total: {timings['total']:.2f}s", file=sys.stderr,
          flush=True)
    print(f"Wrote {path_output}/metrics/{{raw_metrics.csv,table.tex}} and "
          f"timings.json")
    if mesh is not None:
        mesh.barrier()
        mesh.close()
    return Transfer(base_cfg, case, results, (data_train, data_val, data_test),
                    rows, path_output, timings)


if __name__ == "__main__":
    main()
