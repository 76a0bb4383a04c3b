"""Readings for a cell's limits, on the card (not run by the benchmark).

    python3 -m portbench.calibrate --workload <cell> --seeds <n> ... \\
        --control-seeds <n> ... --seconds <s> --out <file.json>

For each of ``--seeds`` it makes one run of the cell in this process (the
window ``--seconds`` long, so at least one whole job) and records every
compared number: the largest over a dozen seeds or more
is a limit's lower reading. For each of ``--control-seeds`` it puts the
reference in TF32 in the program's place at the cell's own size and
records the same numbers against the float32 reference: the smallest is
the upper reading. For a training cell, each fault of the contract is
also planted in the reference put in the program's place, on the
control's seeds (``--control-seeds``): a step that returns its state
unchanged (no learning rate), half of the batch left out with the mean
over the rest, one group's update skipped (decoder_y's learning rate 0),
a loss altered by a thousandth where it is produced.
``portbench/limits/<cell>.json`` holds limits set between the readings;
``PERF.md`` gives them.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch


@contextlib.contextmanager
def _half_batch():
    """The reference's loss over the first half of each batch, twice: the
    mean over the half that is left."""
    from portbench.reference import dpivae as ref

    loss = ref.Reference.loss_comps

    def half(self, p, x, c, y, eps, lam):
        h = x.shape[0] // 2
        dup = lambda a, dim=0: torch.cat([a.narrow(dim, 0, h)] * 2, dim)
        return loss(self, p, dup(x), dup(c), dup(y), dup(eps, 1), lam)

    ref.Reference.loss_comps = half
    try:
        yield
    finally:
        ref.Reference.loss_comps = loss


def _with_lr(cfg, **lr):
    return dict(cfg, adam=dict(cfg["adam"], lr=dict(cfg["adam"]["lr"], **lr)))


def fault_readings(cfg, mix, runs, n):
    """Each fault's readings against the reference over ``n`` steps,
    widest over ``runs``."""
    from portbench import compare

    n_rows = mix["check_steps"]
    frozen = _with_lr(cfg, **{k: 0.0 for k in cfg["adam"]["lr"]})
    out = {}
    for make_g, w, dtr, dva, lam in runs:
        clean = compare.follow(cfg, w, dtr, dva, make_g(), lam, n)
        planted = {"unchanged": compare.follow(frozen, w, dtr, dva, make_g(),
                                               lam, n),
                   "skipped_group": compare.follow(
                       _with_lr(cfg, decoder_y=0.0), w, dtr, dva, make_g(),
                       lam, n)}
        with _half_batch():
            planted["half_batch"] = compare.follow(cfg, w, dtr, dva,
                                                   make_g(), lam, n)
        planted["altered"] = clean._replace(train=clean.train * (1.0 + 1e-3))
        for name, got in planted.items():
            gaps = compare.readings(cfg, clean, got.train, got.val, n_rows,
                                    w, got.params)
            seen = out.setdefault(name, {})
            for k, v in gaps.items():
                seen[k] = max(seen.get(k, 0.0), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    from portbench import common, run

    bench = common.load_benchmark()
    work, cfg, mix, _ = common.cell(bench, args.workload)
    device = common.cuda_or_exit(work["chips"])
    drv = common.driver(mix["kind"])
    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {}}
    for seed in args.seeds:
        t = time.perf_counter()
        rec, _, checks, _ = run.execute(bench, args.workload, seed,
                                        args.seconds, False, device,
                                        time.perf_counter)
        out["program"][seed] = {n: c["value"] for n, c in checks.items()}
        print(f"program seed {seed}: {out['program'][seed]} failed "
              f"{rec['failed']} ({time.perf_counter() - t:.1f} s)",
              flush=True)
    for seed in args.control_seeds:
        readings = drv.control(cfg, mix, seed, device)
        out["control"][seed] = {n: max(r[n] for r in readings)
                                for n in readings[0]}
        print(f"control seed {seed}: {out['control'][seed]}", flush=True)
        out["faults"][seed] = fault_readings(
            cfg, mix, drv.runs(cfg, mix, seed, device), drv.change_steps(mix))
        print(f"faults seed {seed}: {out['faults'][seed]}", flush=True)
    for side, agg in (("program", max), ("control", min)):
        if out[side]:
            names = next(iter(out[side].values()))
            summary = {n: agg(v[n] for v in out[side].values())
                       for n in names}
            out[side + "_summary"] = summary
            print(f"{side} {agg.__name__}: {summary}", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
