"""Runs one cell of the port's benchmark and prints its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The cell names
a configuration (``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<mix>.json``), whose ``kind`` names its driver
(``portbench/drivers/<kind>.py``); the cell's limits are in
``portbench/limits/<cell>.json`` and each per-layer metric is read by
``portbench/metrics/<metric>.py``. The run:

1. makes the inputs and weights from ``--seed`` on the card and warms up
   the cell's own shapes (``setup_s``: from the process's start to the
   first timed unit of work);
2. runs the cell's traffic for ``--seconds`` (with ``--trace 1`` a slice of
   it under ``torch.profiler``);
3. reads the peak memory, frees the program's state and checks what the
   timed path produced against the plain reference in
   ``portbench/reference``;
4. fails if ``jax``, ``jaxlib``, ``flax`` or ``dpivae_tpu`` were loaded;
5. prints each compared number beside its limit on stderr, and as its last
   line on stdout one JSON object: ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device`` (and ``breakdown`` when traced), the checks last.

Without as many CUDA devices as the cell asks for it exits with code 2 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _since_process_start() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


FORBIDDEN = ("jax", "jaxlib", "flax", "dpivae_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, whole."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_main = time.perf_counter()
    offset = _since_process_start()
    args = parse(argv)
    from portbench import common

    bench = common.load_benchmark()
    work = common.cell(bench, args.workload)[0]
    device = common.cuda_or_exit(work["chips"])
    out = execute(bench, args.workload, args.seed, args.seconds,
                  bool(args.trace), device,
                  lambda: offset + time.perf_counter() - t_main)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: "
              f"{found}; no result", file=sys.stderr)
        return 3
    return report(bench, args, *out, device)


def execute(bench, workload, seed, seconds, traced, device, since_start,
            mix_overrides=None):
    """One run of a cell up to its verdict on ``device``: (the window's
    record, the end-to-end metrics, the checks, the peak memory).
    ``since_start()`` gives the seconds since the process started;
    ``mix_overrides`` replace entries of the traffic mix (the CPU tests run
    small ones)."""
    import torch

    from portbench import common

    _, cfg, mix, limits = common.cell(bench, workload)
    mix = dict(mix, **(mix_overrides or {}))
    drv = common.driver(mix["kind"])
    state = drv.setup(cfg, mix, seed, device)
    setup_s = since_start()
    rec = drv.window(state, seconds, traced)
    common.sync(device)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    e2e = drv.end_to_end(rec)
    e2e["setup_s"] = setup_s
    checks = drv.check(state, rec, limits)
    return rec, e2e, checks, memory_peak


def verdict(rec, checks) -> bool:
    """Correct: every compared number within its limit and nothing
    failed."""
    return (not rec["failed"]
            and all(c["value"] <= c["limit"] for c in checks.values()))


def report(bench, args, rec, e2e, checks, memory_peak, device) -> int:
    import torch

    from portbench import common, trace

    def unit(m):
        return {"value": float(m[1]), "unit": m[0]["unit"]}

    def listed(m):
        return args.workload in m.get("workloads", [args.workload])

    out_metrics = {}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": verdict(rec, checks),
              "attempted": rec["attempted"], "failed": rec["failed"]}
    if args.trace:
        ev = rec["slice"]
        for m in bench["per_layer"]:
            if listed(m):
                value = common.metric_reader(m["name"])(rec)
                if value is not None:
                    out_metrics[m["name"]] = unit((m, value))
        dev["busy_s"] = trace.busy_s(ev)
        dev["window_s"] = trace.window_s(ev)
    else:
        for m in bench["end_to_end"]:
            if listed(m):
                out_metrics[m["name"]] = unit((m, e2e[m["name"]]))
    result["metrics"] = out_metrics
    result["device"] = dev
    if args.trace:
        result["breakdown"] = trace.breakdown(rec["slice"])
    for err in rec["errors"][:3]:
        print(f"portbench: failed: {err}", file=sys.stderr)
    # Each job's seconds: a run's rate moves with the mix of fast and slow
    # jobs in its window (PERF.md §2).
    units = ", ".join(f"{s[2] - s[1]:.3f}" for s in rec["spans"][:40])
    print(f"portbench: window's units (s): {units}", file=sys.stderr)
    # A number that is not finite has failed; JSON carries it as the
    # largest double.
    result["checks"] = {name: {"value": c["value"] if math.isfinite(
        c["value"]) else sys.float_info.max, "limit": c["limit"]}
        for name, c in checks.items()}
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
