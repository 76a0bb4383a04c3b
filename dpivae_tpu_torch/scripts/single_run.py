"""One training run, its metric logs, a servable checkpoint, the baseline
comparison, the VAE's evaluation and, with --plots, the figures
(counterpart of scripts/0_single_run.py):

    python -m dpivae_tpu_torch.scripts.single_run --case simple_beam \\
        --preset dpivae [--name single_run] [--n_iter 20000] [--cond] \\
        [--plots] [--device cuda]

Outputs: output/<name>/settings/args.json (the config), metrics/ (the
training logs as CSVs: train.csv, val.csv and one per series),
models/model (``train.checkpoint.save_model``; restore it with
``load_model(path, case)``) and, with --export_serving,
models/predictor.pt2 and its .meta.json (``serving.save_predictor``;
serve it with ``serving.load_predictor``). The R², MSE and MAE of LIN, GPR, MLP and the
VAE on the test split are printed, with the wall time of each stage.

--plots draws the JAX program's figures into figures/, under its file
names: loss_curve.png, regression_error_test_<model>.png (LIN, GPR, MLP
and the VAE, under the run's name), fig_pred_x_<factor>.png,
fig_pred_interp_x.png, fig_post_marginal_z.png, fig_post_marginal_z_01.png,
fig_prior_marginal_z.png and fig_posterior_ground_truth.png. Their data
are computed on the run's device (``viz.visualization``), the drawing on
the host. Unlike the JAX program, the default is no figures (--no-plots
is accepted): the card's host has no matplotlib, and the traversal KDE
grids take minutes of host time. --plots checks before any work that
matplotlib and seaborn import, and stops with an error naming the one
that does not.

The data come from the port's ``sample_response``, from generators on the
device seeded with the seed (--seed, else the preset's config's), seed + 1
and seed + 2 (train, validation, test); the initial weights come from a
CPU generator seeded with it and training draws from one seeded seed + 3.
torch's random streams are not JAX's, so the datasets and the run differ
from the JAX program's at the same seed.

It runs on the CUDA device unless --device says otherwise (--device cpu
runs it on the CPU). --n_devices N above 1 trains data-parallel over a
("dp",) mesh of N ranks, one per device (``parallel.make_mesh``; NCCL
between cards, gloo with --device cpu); on cards each rank replays one
CUDA graph per validation block with the gradients' all-reduces inside,
as a run without a mesh replays its own. It is launched by

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m dpivae_tpu_torch.scripts.single_run --n_devices N ...

Every rank trains; rank 0 alone writes the settings, CSVs, checkpoint and
artifact, evaluates, fits the baselines and draws the figures, while the
others wait at a barrier and return None. Without the launcher, N above 1
stops at parse time with that command. --n_devices 1 (the default) is the
run without a mesh.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dpivae_tpu_torch.parallel.mesh import launch_problem

BASELINES = ("LIN", "GPR", "MLP")
MODULE = "dpivae_tpu_torch.scripts.single_run"




class SingleRun(NamedTuple):
    """What a run made, for callers that drive ``main`` in process."""

    config: object
    case: object
    model: object
    params: object
    logs: object
    data_train: tuple
    data_val: tuple
    data_test: tuple
    metrics: Dict[str, dict]
    predictions: Dict[str, np.ndarray]
    paths: Dict[str, str]
    seconds: Dict[str, float]


def draw_figures(cfg, case, model, params, logs, data_test, metrics,
                 predictions, fig_dir, cond=False, seed=0, device=None):
    """The JAX program's figures of a run, under its file names, into
    ``fig_dir``; their data are computed on ``device``."""
    from dpivae_tpu_torch.viz import (
        plot_ground_truth_posterior,
        plot_interp_pred,
        plot_marginal_post,
        plot_marginal_prior,
        plot_pred,
        plot_regression_error,
        save_close_fig,
        visualize_training_loss,
    )

    def save(fig, name):
        save_close_fig(fig, os.path.join(fig_dir, name))

    fig, _ = visualize_training_loss(
        logs, n_skip_train=cfg.n_skip_plot_train,
        n_skip_val=cfg.n_skip_plot_val)
    save(fig, "loss_curve.png")
    y_test = data_test[2].cpu().numpy()
    for name, pred in predictions.items():
        fig, _ = plot_regression_error(y_test, pred, case,
                                       metrics=metrics[name],
                                       title=f"{name}: Test")
        save(fig, f"regression_error_test_{name}.png")
    figure = dict(cond=cond, n_plot=cfg.n_plot, seed=seed, device=device)
    for idx in range(len(case.factors)):
        fig, _ = plot_pred(model, params, cfg, case, idx, **figure)
        save(fig, f"fig_pred_x_{idx}.png")
    fig, _ = plot_interp_pred(model, params, cfg, case, **figure)
    save(fig, "fig_pred_interp_x.png")
    fig, _ = plot_marginal_post(model, params, cfg, case, **figure)
    save(fig, "fig_post_marginal_z.png")
    fig, _ = plot_marginal_post(model, params, cfg, case, vars_interp=[0, 1],
                                **figure)
    save(fig, "fig_post_marginal_z_01.png")
    fig, _ = plot_marginal_prior(model, params, cfg, case, n_plot=cfg.n_plot,
                                 seed=seed, device=device)
    save(fig, "fig_prior_marginal_z.png")
    fig = plot_ground_truth_posterior(model, params, cfg, case,
                                      case.gt_dist(), **figure)
    save(fig, "fig_posterior_ground_truth.png")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--case", default="simple_beam")
    parser.add_argument("--preset", default="dpivae")
    parser.add_argument("--name", default="single_run")
    parser.add_argument("--n_iter", type=int, default=None)
    parser.add_argument("--n_train", type=int, default=None)
    parser.add_argument("--n_val", type=int, default=None)
    parser.add_argument("--n_test", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--n_plot", type=int, default=None,
                        help="responses per traversal point of a figure "
                             "(default: the config's 2,000)")
    parser.add_argument("--n_interp", type=int, default=None,
                        help="traversal points per factor (default: the "
                             "config's 5)")
    parser.add_argument("--cond", action="store_true")
    parser.add_argument("--no-plots", action="store_true",
                        help="draw no figures (the default; accepted for the "
                             "JAX program's command lines)")
    parser.add_argument("--plots", action="store_true",
                        help="draw the figures into figures/ (needs "
                             "matplotlib and seaborn)")
    parser.add_argument("--output", default="output")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="data-parallel devices: each training and "
                             "validation batch is split over a 'dp' mesh "
                             "axis of this many ranks (params replicated, "
                             "gradients summed in one collective a step); "
                             "above 1 it needs torch.distributed.run's "
                             "launch; 1 = no mesh")
    parser.add_argument("--export_serving", action="store_true",
                        help="also write models/predictor.pt2, the serving "
                             "artifact (torch.export), with its .meta.json")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Optional[SingleRun]:
    parser = _parser()
    args = parser.parse_args(argv)
    problem = launch_problem(args.n_devices, MODULE)
    if problem:
        parser.error(problem)
    if args.plots:
        from dpivae_tpu_torch.viz.visualization import missing_plot_package

        missing = missing_plot_package()
        if missing is not None:
            parser.error(f"--plots needs {missing}, which does not import "
                         f"here; run without --plots")

    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.eval import evaluate_model, run_comparison
    from dpivae_tpu_torch.parallel import make_mesh
    from dpivae_tpu_torch.serving import save_predictor
    from dpivae_tpu_torch.train import init_params, setup_model, train_model
    from dpivae_tpu_torch.train.checkpoint import save_model
    from dpivae_tpu_torch.utils import resolve_device
    from dpivae_tpu_torch.utils.data import sample_response
    from dpivae_tpu_torch.utils.logging import save_logs_csv

    device = resolve_device(args.device)
    case = get_case(args.case)
    if args.preset not in case.presets:
        parser.error(f"unknown preset {args.preset!r} for case "
                     f"{args.case!r}; have {sorted(case.presets)}")
    cfg = TrainConfig().with_preset(case.presets[args.preset])
    cfg = cfg.replace(name=args.name, use_seed=True)
    for field in ("n_iter", "n_train", "n_val", "n_test", "seed", "n_plot",
                  "n_interp"):
        value = getattr(args, field)
        if value is not None:
            cfg = cfg.replace(**{field: value})
    if cfg.n_batch > cfg.n_train:
        cfg = cfg.replace(n_batch=cfg.n_train)

    mesh = None
    if args.n_devices > 1:
        mesh = make_mesh(args.n_devices, ("dp",), device=device)
        device = mesh.device
    writer = mesh is None or mesh.rank == 0
    path_output = os.path.join(args.output, args.name)
    paths = {sub: os.path.join(path_output, sub)
             for sub in ("metrics", "settings", "models")
             + (("figures",) if args.plots else ())}
    if writer:
        for p in paths.values():
            os.makedirs(p, exist_ok=True)
        cfg.save_json(os.path.join(paths["settings"], "args.json"))

    seconds: Dict[str, float] = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[name] = time.perf_counter() - t0
        return out

    def generator(offset):
        return torch.Generator(device=device).manual_seed(cfg.seed + offset)

    dist_gt = case.gt_dist()
    data_train, data_val, data_test = (
        sample_response(case, generator(i), n, sample_dist=dist_gt,
                        device=device)
        for i, n in enumerate((cfg.n_train, cfg.n_val, cfg.n_test)))

    model = setup_model(cfg, case, data_train, device=device)
    params = init_params(cfg, model, device=device)
    if writer:
        print(f"Training {args.case}/{args.preset} for {cfg.n_iter} iters "
              f"on {device} (fused-MLP kernel: {model.use_pallas})"
              + (f", data-parallel over {mesh}" if mesh else "") + " ...")
    params, logs = stage("train", lambda: train_model(
        cfg, model, case, data_train, data_val, params=params,
        generator=generator(3), device=device, mesh=mesh))
    if not writer:
        mesh.barrier()
        mesh.close()
        return None
    print(f"Done: stopped at iter {logs.stop_iter}, "
          f"final train ELBO {logs.scalars('ELBO')[1][-1]:.4f}, "
          f"final val ELBO {logs.scalars('ELBO_val')[1][-1]:.4f}")

    stage("csv", lambda: save_logs_csv(logs, paths["metrics"]))
    stage("save", lambda: save_model(os.path.join(paths["models"], "model"),
                                      model, params, cfg, case=case))
    if args.export_serving:
        paths["predictor"] = stage("export", lambda: save_predictor(
            os.path.join(paths["models"], "predictor.pt2"), model, params,
            cfg, case, cond=args.cond))
        print(f"Serving artifact: {paths['predictor']} (+ .meta.json)")

    metrics, predictions = {}, {}
    for name in BASELINES:
        m, p = stage(name, lambda: run_comparison(
            cfg, case, data_train, data_test, generator=generator(4),
            models=(name,), device=device))
        metrics.update(m)
        predictions.update(p)
    m, p = stage("evaluate", lambda: evaluate_model(
        cfg, case, model, params, data_test, cond=args.cond))
    metrics.update(m)
    predictions.update(p)
    for name, m in metrics.items():
        print(f"{name}: R2={np.round(m['R2'], 4)} MSE={np.round(m['MSE'], 5)} "
              f"MAE={np.round(m['MAE'], 5)}")
    if args.plots:
        stage("figures", lambda: draw_figures(
            cfg, case, model, params, logs, data_test, metrics, predictions,
            paths["figures"], cond=args.cond, seed=cfg.seed + 5,
            device=device))
        print(f"Figures written to {paths['figures']}")
    print("stage seconds: " + ", ".join(
        f"{name} {s:.3f}" for name, s in seconds.items()))
    if mesh is not None:
        mesh.barrier()
        mesh.close()
    return SingleRun(cfg, case, model, params, logs, data_train, data_val,
                     data_test, metrics, predictions, paths, seconds)


if __name__ == "__main__":
    main()
