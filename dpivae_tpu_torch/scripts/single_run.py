"""One training run, its metric logs, a servable checkpoint, the baseline
comparison and the VAE's evaluation (counterpart of scripts/0_single_run.py,
without its plots):

    python -m dpivae_tpu_torch.scripts.single_run --case simple_beam \\
        --preset dpivae [--name single_run] [--n_iter 20000] [--cond] \\
        [--device cuda]

Outputs: output/<name>/settings/args.json (the config), metrics/ (the
training logs as CSVs: train.csv, val.csv and one per series),
models/model (``train.checkpoint.save_model``; restore it with
``load_model(path, case)``) and, with --export_serving,
models/predictor.pt2 and its .meta.json (``serving.save_predictor``;
serve it with ``serving.load_predictor``). The R², MSE and MAE of LIN, GPR, MLP and the
VAE on the test split are printed, with the wall time of each stage.

The data come from the port's ``sample_response``, from generators on the
device seeded with the seed (--seed, else the preset's config's), seed + 1
and seed + 2 (train, validation, test); the initial weights come from a
CPU generator seeded with it and training draws from one seeded seed + 3.
torch's random streams are not JAX's, so the datasets and the run differ
from the JAX program's at the same seed.

It runs on the CUDA device unless --device says otherwise (--device cpu
runs it on the CPU). Not ported: --n_devices above 1 (data parallelism,
ROADMAP.md queue 1, item 11) and the figures (viz/, item 10): asking for
them raises.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

BASELINES = ("LIN", "GPR", "MLP")


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
    parser.add_argument("--cond", action="store_true")
    parser.add_argument("--no-plots", action="store_true",
                        help="accepted for the JAX program's command lines; "
                             "the figures are not ported, so none are drawn")
    parser.add_argument("--plots", action="store_true",
                        help="draw the figures: not ported yet, raises")
    parser.add_argument("--output", default="output")
    parser.add_argument("--n_devices", type=int, default=1,
                        help="data-parallel devices; only 1 is ported")
    parser.add_argument("--export_serving", action="store_true",
                        help="also write models/predictor.pt2, the serving "
                             "artifact (torch.export), with its .meta.json")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: cuda)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> SingleRun:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.n_devices != 1:
        parser.error("--n_devices above 1 (data parallelism) is not ported "
                     "to dpivae_tpu_torch yet (ROADMAP.md, queue 1, item 11)")
    if args.plots:
        parser.error("the figures (viz/) are not ported to dpivae_tpu_torch "
                     "yet (ROADMAP.md, queue 1, item 10)")

    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.eval import evaluate_model, run_comparison
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
    for field in ("n_iter", "n_train", "n_val", "n_test", "seed"):
        value = getattr(args, field)
        if value is not None:
            cfg = cfg.replace(**{field: value})
    if cfg.n_batch > cfg.n_train:
        cfg = cfg.replace(n_batch=cfg.n_train)

    path_output = os.path.join(args.output, args.name)
    paths = {sub: os.path.join(path_output, sub)
             for sub in ("metrics", "settings", "models")}
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
    print(f"Training {args.case}/{args.preset} for {cfg.n_iter} iters on "
          f"{device} (fused-MLP kernel: {model.use_pallas}) ...")
    params, logs = stage("train", lambda: train_model(
        cfg, model, case, data_train, data_val, params=params,
        generator=generator(3), device=device))
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
    print("stage seconds: " + ", ".join(
        f"{name} {s:.3f}" for name, s in seconds.items()))
    return SingleRun(cfg, case, model, params, logs, data_train, data_val,
                     data_test, metrics, predictions, paths, seconds)


if __name__ == "__main__":
    main()
