"""Readings for the transfer cell's limits, on the card (not run by the
benchmark): ``portbench/calibrate.py`` for a cell of the P model
(``portbench/drivers/transfer_jobs.py``, reference
``portbench/reference/dpivae_p.py``).

    python3 -m portbench.calibrate_transfer --workload bridge_transfer24 \\
        --seeds <n> ... --control-seeds <n> ... --seconds <s> --out <file>

For each of ``--seeds`` one run of the cell in this process and its
compared numbers (the largest over the seeds is a limit's lower reading);
for each of ``--control-seeds`` the reference in TF32 in the program's
place, and each planted fault in the reference: a step that returns its
state unchanged, half of the batch left out with the mean over the rest,
decoder_y's update skipped, a loss altered by a thousandth (the least
over the seeds is the upper reading).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from portbench.calibrate import _with_lr


@contextlib.contextmanager
def _half_batch():
    """The P reference's loss over the first half of each batch, twice."""
    from portbench.reference import dpivae_p as ref_p

    loss = ref_p.Reference.loss_comps

    def half(self, p, x, c, y, eps, lam):
        h = x.shape[0] // 2
        dup = lambda a, dim=0: torch.cat([a.narrow(dim, 0, h)] * 2, dim)
        return loss(self, p, dup(x), dup(c), dup(y), dup(eps, 1), lam)

    ref_p.Reference.loss_comps = half
    try:
        yield
    finally:
        ref_p.Reference.loss_comps = loss


def fault_readings(cfg, mix, runs, part, n):
    """Each fault's readings against the reference over ``n`` steps,
    widest over ``runs``."""
    from portbench.drivers import transfer_jobs as drv
    from portbench.reference import dpivae_p as ref_p

    n_rows = mix["check_steps"]
    frozen = _with_lr(cfg, **{k: 0.0 for k in cfg["adam"]["lr"]})
    out = {}
    for make_g, w, dtr, dva, lam in runs:
        follow = lambda c: ref_p.follow(c, part, w, dtr, dva, make_g(), lam,
                                        n)
        clean = follow(cfg)
        planted = {"unchanged": follow(frozen),
                   "skipped_group": follow(_with_lr(cfg, decoder_y=0.0))}
        with _half_batch():
            planted["half_batch"] = follow(cfg)
        planted["altered"] = clean._replace(train=clean.train * (1.0 + 1e-3))
        for name, got in planted.items():
            gaps = drv.readings(cfg, clean, got.train, got.val, n_rows, w,
                                got.params)
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
    from portbench.reference import dpivae_p as ref_p

    bench = common.load_benchmark()
    work, cfg, mix, _ = common.cell(bench, args.workload)
    device = common.cuda_or_exit(work["chips"])
    drv = common.driver(mix["kind"])
    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {}}
    for seed in args.seeds:
        t = time.perf_counter()
        rec, e2e, checks, _ = run.execute(bench, args.workload, seed,
                                          args.seconds, False, device,
                                          time.perf_counter)
        out["program"][seed] = {n: c["value"] for n, c in checks.items()}
        print(f"program seed {seed}: {out['program'][seed]} failed "
              f"{rec['failed']} rate {e2e['train_member_steps_per_s']:.1f} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    part = ref_p.load_arrays(cfg, device, "part_")
    for seed in args.control_seeds:
        readings = drv.control(cfg, mix, seed, device)
        out["control"][seed] = {n: max(r[n] for r in readings)
                                for n in readings[0]}
        print(f"control seed {seed}: {out['control'][seed]}", flush=True)
        out["faults"][seed] = fault_readings(
            cfg, mix, drv.runs(cfg, mix, seed, device), part,
            drv.change_steps(mix))
        print(f"faults seed {seed}: {out['faults'][seed]}", flush=True)
    for side, agg in (("program", max), ("control", min)):
        if out[side]:
            names = next(iter(out[side].values()))
            summary = {n: agg(v[n] for v in out[side].values())
                       for n in names}
            out[side + "_summary"] = summary
            print(f"{side} {agg.__name__}: {summary}", flush=True)
    if out["faults"]:
        faults = {f: {n: min(s[f][n] for s in out["faults"].values())
                      for n in next(iter(out["faults"].values()))[f]}
                  for f in next(iter(out["faults"].values()))}
        out["faults_summary"] = faults
        print(f"faults min: {faults}", flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
