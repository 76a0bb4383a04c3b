"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``portbench/reference``), each number beside
its limit from ``portbench/limits/<cell>.json``.

Training (one run or one sweep member): the reference follows the job's
first steps from the same weights and data with the same generator's
draws. Read are:

- ``loss0_gap``: the gap of the first step's loss (the ELBO row: the
  forward, before any update), over the reference's;
- ``sigma_gap``: the widest relative gap of sigma_x after each step, the
  one parameter the logs keep;
- ``change_gap``: the parameters' change over the whole of a short job
  (set-up's warm-up job: its eager block, its capture and a replay),
  taken by the worst leaf: the gap between the norm of the program's
  change of a leaf and the reference's, over the reference's norm of that
  leaf's change or of the median leaf's, whichever is larger. Leaves whose
  first gradient in the reference is under a thousandth of the median
  leaf's move by rounding alone and are left out (``DEAD_GRAD``);
- ``loss_gap``: the widest gap of a step's loss over those steps, over
  the mean size of the reference's; ``val_gap``: the same for the
  validations.

The cells' limits compare the first three. Adam's first update moves
every weight by about its learning rate whatever the size of its
gradient, so a weight whose gradient is nought to rounding moves one way
in the program and the other in the reference now and then, and the
later losses of a sound run then differ by up to ~2e-5, within four times
of the control's: ``loss_gap`` and ``val_gap`` are read, not compared
(PERF.md §6).

The control is the reference in TF32 put in the program's place
(``portbench/calibrate.py``).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from portbench.reference import dpivae as ref

# A leaf whose first gradient in the reference is under this share of the
# median leaf's is left out of ``change_gap``.
DEAD_GRAD = 1e-3


def _gap(prog: torch.Tensor, want: torch.Tensor, scale) -> float:
    return float(torch.max(torch.abs(prog.double() - want.double())) / scale)


def training_gaps(train_p, val_p, train_r, val_r) -> Dict[str, float]:
    """The row numbers from the program's (or the control's) rows and
    the reference's: train rows (steps, the ELBO first, sigma_x last),
    validation rows."""
    loss_r = train_r[:, 0]
    scale = float(torch.mean(torch.abs(loss_r.double())))
    vscale = float(torch.mean(torch.abs(val_r[:, 0].double())))
    return {"loss0_gap": _gap(train_p[:1, 0], loss_r[:1],
                              abs(float(loss_r[0]))),
            "loss_gap": _gap(train_p[:, 0], loss_r, scale),
            "val_gap": _gap(val_p[:, 0], val_r[:, 0], vscale),
            "sigma_gap": float(torch.max(torch.abs(
                train_p[:, -1].double() - train_r[:, -1].double())
                / train_r[:, -1].double()))}


def change_gap(start, after, followed: ref.Followed) -> float:
    """The worst leaf's gap of the parameters' change from ``start``:
    the program's (``after``) against the reference's (``followed``)."""
    med_grad = statistics.median(followed.grad0.values())
    kept = [k for k in start if followed.grad0[k] >= DEAD_GRAD * med_grad]

    def norm(a, k):
        return float(torch.linalg.vector_norm(
            a[k].double().to(start[k].device) - start[k].double()))

    want = {k: norm(followed.params, k) for k in kept}
    med = statistics.median(want.values())
    return max(abs(norm(after, k) - want[k]) / max(want[k], med)
               for k in kept)


def readings(cfg, followed: ref.Followed, train_p, val_p, n_rows: int,
             start=None, after=None) -> Dict[str, float]:
    """The numbers of one run against the reference: the row numbers over
    the first ``n_rows`` steps, and ``change_gap`` where the run's leaves
    ``after`` its steps are given."""
    n_val = -(-n_rows // cfg["val_freq"])
    out = training_gaps(train_p[:n_rows], val_p[:n_val],
                        followed.train[:n_rows], followed.val[:n_val])
    if after is not None:
        out["change_gap"] = change_gap(start, after, followed)
    return out


def follow(cfg, weights, data_train, data_val, g, lam, n_steps,
           tf32=False) -> ref.Followed:
    """The reference over ``n_steps`` steps (float32, or TF32)."""
    reference = ref.Reference(cfg, data_train, g.device)
    with ref.matmul_precision(tf32):
        return ref.follow_training(cfg, reference, weights, data_train,
                                   data_val, g, n_steps, lam)


def training_control(cfg, runs, n_rows, n_steps):
    """The control's readings for training runs given as (make_generator,
    weights, data_train, data_val, λ): the reference in TF32 against the
    reference in float32, each from a fresh generator, over ``n_steps``
    steps, the rows over the first ``n_rows``."""
    out = []
    for make_g, weights, data_train, data_val, lam in runs:
        want = follow(cfg, weights, data_train, data_val, make_g(), lam,
                      n_steps)
        got = follow(cfg, weights, data_train, data_val, make_g(), lam,
                     n_steps, tf32=True)
        out.append(readings(cfg, want, got.train, got.val, n_rows,
                            weights, got.params))
    return out


def compare_training(cfg, weights, data_train, data_val, g, lam, train_p,
                     val_p, n_rows, after: Optional[dict] = None,
                     n_steps: Optional[int] = None) -> Dict[str, float]:
    """The program's logged rows of one run against the reference over
    its first ``n_rows`` steps; with ``after``, the run's leaves after
    its ``n_steps`` steps, the parameters' change too."""
    followed = follow(cfg, weights, data_train, data_val, g, lam,
                      max(n_rows, n_steps or 0))
    rows = torch.cat([train_p[:n_rows, :8], train_p[:n_rows, 12:13]], 1)
    return readings(cfg, followed, rows, val_p, n_rows, weights, after)


def verdict(readings: List[Dict[str, float]], limits) -> Dict[str, dict]:
    """The widest reading of each number beside its limit; a number that
    is not finite, or that no reading has, reads as infinite and fails."""
    out = {}
    for name, limit in limits.items():
        vals = [r[name] for r in readings if name in r]
        worst = (max(vals) if vals and all(math.isfinite(v) for v in vals)
                 else math.inf)
        out[name] = {"value": worst, "limit": limit}
    return out
