"""A hyperparameter grid trained as one member-batched sweep (counterpart
of examples/hyper_search.py).

A grid over config fields that may differ between the members of one
batched training (per-group learning rates, weight decays, the clip norm,
the β/α loss weights: ``train.train.TRACEABLE_HYPER_FIELDS``) trains in
one ``sweep.train_hyper_sweep``: every member's values enter the step as
tensors, so the whole grid runs one ``torch.func.vmap``-ed step. Like
every sweep trainer it also takes ``checkpoint_dir=`` (chunk-level resume)
and ``chunk_callback=`` (completed chunks streamed during training).

This program crosses learning rate × weight decay for the beam S-model and
ranks the grid by the seed-averaged final validation loss (each member's
last validation before its early stop).

    python -m dpivae_tpu_torch.examples.hyper_search [--n_iter 2000] \\
        [--n_runs 2] [--device cpu]

``--device`` defaults to CUDA and raises without a card.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple, Optional, Sequence

import numpy as np


class HyperSearch(NamedTuple):
    """The sweep's result (on the host), each grid row's seed-averaged
    final validation loss, and the rows from best to worst."""

    result: object
    final: np.ndarray
    order: np.ndarray


def _final_val_loss(logs) -> np.ndarray:
    """Each member's last active validation ELBO, (M,)."""
    val = logs.val[..., 0].numpy()
    last = logs.val_active.numpy().sum(axis=1) - 1
    return val[np.arange(val.shape[0]), last]


def main(argv: Optional[Sequence[str]] = None) -> HyperSearch:
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--n_iter", type=int, default=2000)
    parser.add_argument("--n_runs", type=int, default=2)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    from dpivae_tpu_torch.cases import get_case
    from dpivae_tpu_torch.config import TrainConfig
    from dpivae_tpu_torch.sweep import train_hyper_sweep

    case = get_case("simple_beam")
    cfg = TrainConfig().with_preset(case.presets["dpivae"]).replace(
        use_seed=True, n_iter=args.n_iter)

    # Cross product -> pre-crossed columns (members are rows, not axes)
    lrs, wds = np.meshgrid([3e-4, 1e-3, 3e-3], [0.0, 1e-3])
    grid = {"lr_e": lrs.ravel(), "wd_e": wds.ravel()}
    n_rows = lrs.size

    print(f"Training {n_rows} grid points x {args.n_runs} seeds "
          f"({n_rows * args.n_runs} members) as one batched sweep ...")
    res = train_hyper_sweep(cfg, case, grid=grid, n_runs=args.n_runs,
                            seed=0, device=args.device).host()

    # Mean final val loss per grid row, over seeds
    final = _final_val_loss(res.logs).reshape(n_rows,
                                              args.n_runs).mean(axis=1)
    order = np.argsort(final)
    for i in order:
        ov = res.member_overrides(i * args.n_runs)
        print(f"  lr_e={ov['lr_e']:8.1e}  wd_e={ov['wd_e']:8.1e}  "
              f"val loss {final[i]:+.4f}")
    best = res.member_overrides(int(order[0]) * args.n_runs)
    print(f"best: {best}")
    if not np.all(np.isfinite(final)):
        raise RuntimeError(f"non-finite final validation losses: {final}")
    print("hyper_search OK")
    return HyperSearch(res, final, order)


if __name__ == "__main__":
    main()
