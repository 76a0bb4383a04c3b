"""Where each training job's time goes, from the port's own spans: one cell
of the port's benchmark run with ``dpivae_tpu_torch.utils.spans``
recording its window.

    python3 train_spans.py --workload beam_train --seed 7 --seconds 51 \\
        --trace 1 --out spans_beam.json

runs the cell as ``python3 -m portbench.run`` runs it (set-up, the
window, the check; ``--trace 1`` puts the benchmark's profiler slice in
the window's first job) with the recorder on around the window alone, and
prints one JSON line: the device, the cell's rate and ``correct``, the
readings below, and each window job's seconds beside its spans' numbers.
``--recording 0`` leaves the recorder off (the rate, to time what
recording costs). ``--out`` also writes the line with the recording's
spans. ``--device cpu --small 1`` rehearses it on the CPU at a few
steps.

Each reading is a ``read_*(rec)`` of the window's record, whose
``"program"`` is the recording's export: the median over the window's
jobs after the first (the first carries the profiler's slice in a traced
run), or None where there is nothing to read.

- ``job_setup_ms``: a job's start to its first ``train.block``.
- ``eager_block_ms``: the host's time in block 0, run eagerly.
- ``capture_ms``: ``graph.capture`` without ``graph.capture.count``.
- ``replay_launch_ms``: the host's time in ``graph.replay``.
- ``flag_wait_ms``: ``train.flag_wait``.
- ``block_device_ms``: a replay's event pair, start to end on the stream.
- ``block_gap_ms``: a replay's end event to the next replay's start event:
  the stream idle between blocks.
- ``graph_kernels_per_step``: the capture's ``kernel_nodes`` (kernel and
  memcpy nodes) over ``val_freq``.
- ``device_idle_in_launch_pct.train`` (traced runs): the slice's idle
  time whose gap's middle lies inside a ``graph.replay`` span mapped onto
  the profiler's clock, over the slice's window.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time

NS_MS = 1e6


def _median(values):
    values = list(values)
    return statistics.median(values) if values else None


def _ms(s):
    return (s[5] - s[4]) / NS_MS


def all_jobs(rec):
    """The window's jobs in order, each as (its ``job`` span, its
    spans)."""
    out = rec.get("program")
    if not out:
        return []
    by_job = {}
    for s in out["spans"]:
        by_job.setdefault(s[2], []).append(s)
    ordered = sorted((s for s in out["spans"] if s[3] == "job"),
                     key=lambda s: s[4])
    return [(j, by_job[j[0]]) for j in ordered]


def jobs(rec):
    """The window's jobs after the first."""
    return all_jobs(rec)[1:]


def _named(spans_of_job, name):
    return [s for s in spans_of_job if s[3] == name]


def job_setup(spans_of_job):
    job = _named(spans_of_job, "job")[0]
    blocks = _named(spans_of_job, "train.block")
    return (min(b[4] for b in blocks) - job[4]) / NS_MS if blocks else None


def capture(spans_of_job):
    counting = {}
    for s in _named(spans_of_job, "graph.capture.count"):
        counting[s[1]] = counting.get(s[1], 0.0) + _ms(s)
    return [_ms(c) - counting.get(c[0], 0.0)
            for c in _named(spans_of_job, "graph.capture")]


def device_blocks(rec, spans_of_job):
    """(block's device ms, gap before it in ms or None) for each replay of
    the job, in order; the gap only after the previous block of the same
    loop."""
    device = rec["program"]["device"]
    by_id = {s[0]: s for s in spans_of_job}
    out, last = [], None
    for r in _named(spans_of_job, "graph.replay"):
        if r[0] not in device:
            continue
        t0, t1 = device[r[0]]
        block = by_id.get(r[1])
        where = (block[1], block[6].get("b")) if block else None
        gap = None
        if last is not None and where is not None and last[0] is not None \
                and last[0][0] == where[0] and last[0][1] == where[1] - 1:
            gap = (t0 - last[1]) / NS_MS
        out.append(((t1 - t0) / NS_MS, gap))
        last = (where, t1)
    return out


def _per_job(rec, one):
    values = [one(rec, ss) for _, ss in jobs(rec)]
    return _median(v for v in values if v is not None)


def _each(rec, pick):
    return _median(v for _, ss in jobs(rec) for v in pick(rec, ss))


def read_job_setup_ms(rec):
    return _per_job(rec, lambda rec, ss: job_setup(ss))


def read_eager_block_ms(rec):
    return _each(rec, lambda rec, ss: [
        _ms(b) for b in _named(ss, "train.block") if b[6].get("b") == 0])


def read_capture_ms(rec):
    return _each(rec, lambda rec, ss: capture(ss))


def read_replay_launch_ms(rec):
    return _each(rec, lambda rec, ss: map(_ms, _named(ss, "graph.replay")))


def read_flag_wait_ms(rec):
    return _each(rec, lambda rec, ss: map(_ms,
                                          _named(ss, "train.flag_wait")))


def read_block_device_ms(rec):
    return _each(rec, lambda rec, ss: [d for d, _ in device_blocks(rec, ss)])


def read_block_gap_ms(rec):
    return _each(rec, lambda rec, ss: [
        g for _, g in device_blocks(rec, ss) if g is not None])


def read_graph_kernels_per_step(rec):
    return _each(rec, lambda rec, ss: [
        c[6]["kernel_nodes"] / rec["val_freq"]
        for c in _named(ss, "graph.capture") if "kernel_nodes" in c[6]])


def read_device_idle_in_launch_pct_train(rec):
    from dpivae_tpu_torch.utils import spans
    from portbench import trace

    out, ev = rec.get("program"), rec.get("slice")
    if not out or not ev:
        return None
    replays = sorted((spans.unix_ns(out, s[4]), spans.unix_ns(out, s[5]))
                     for s in out["spans"] if s[3] == "graph.replay")
    if not replays:
        return None
    w0, w1 = ev["window_ns"]
    edges = [w0] + [t for iv in trace.busy_intervals(ev) for t in iv] + [w1]
    idle = 0
    for a, b in zip(edges[::2], edges[1::2]):
        mid = (a + b) // 2
        if b > a and any(s <= mid <= e for s, e in replays):
            idle += b - a
    return 100.0 * idle / (w1 - w0)


READERS = {
    "job_setup_ms": read_job_setup_ms,
    "eager_block_ms": read_eager_block_ms,
    "capture_ms": read_capture_ms,
    "replay_launch_ms": read_replay_launch_ms,
    "flag_wait_ms": read_flag_wait_ms,
    "block_device_ms": read_block_device_ms,
    "block_gap_ms": read_block_gap_ms,
    "graph_kernels_per_step": read_graph_kernels_per_step,
    "device_idle_in_launch_pct.train": read_device_idle_in_launch_pct_train,
}


def job_table(rec):
    """Every window job: its seconds as the harness times them, and its
    spans' numbers (the share of those seconds the ``job`` span's direct
    children cover, set-up, eager block, capture, medians of the
    replays)."""
    program = all_jobs(rec)
    rows = []
    for _, t0, t1, *_ in rec["spans"]:
        inside = [(j, ss) for j, ss in program if t0 <= j[4] / 1e9 <= t1]
        if not inside:
            continue
        job, ss = inside[0]
        blocks = device_blocks(rec, ss)
        eager = [s for s in _named(ss, "train.block") if s[6].get("b") == 0]
        device = rec["program"]["device"]
        eager_dev = [device[s[0]] for s in eager if s[0] in device]
        rows.append({
            "job_s": t1 - t0,
            "covered": sum(s[5] - s[4] for s in ss if s[1] == job[0])
            / 1e9 / (t1 - t0),
            "setup_ms": job_setup(ss),
            "eager_block_ms": [_ms(s) for s in eager],
            "eager_block_device_ms": [(e - s) / NS_MS for s, e in eager_dev],
            "capture_ms": capture(ss),
            "capture_body_ms": [_ms(s) for s in
                                _named(ss, "graph.capture.body")],
            "member_starts_ms": [_ms(s) for s in
                                 _named(ss, "sweep.member_starts")],
            "replays": len(_named(ss, "graph.replay")),
            "replay_launch_ms": _median(map(_ms,
                                            _named(ss, "graph.replay"))),
            "flag_wait_ms": _median(map(_ms, _named(ss, "train.flag_wait"))),
            "block_device_ms": _median(d for d, _ in blocks),
            "block_gap_ms": _median(g for _, g in blocks if g is not None),
        })
    return rows


SMALL = {"train_jobs": dict(n_iter=30, warm_iter=20),
         "sweep_jobs": dict(n_iter=20, members=4)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--recording", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from dpivae_tpu_torch.utils import spans
    from portbench import common, run, trace

    t_start = time.perf_counter()
    bench = common.load_benchmark()
    work, cfg, mix, limits = common.cell(bench, args.workload)
    if args.small:
        mix = dict(mix, **SMALL[mix["kind"]])
    device = (common.cuda_or_exit(work["chips"]) if args.device == "cuda"
              else torch.device(args.device))
    drv = common.driver(mix["kind"])
    state = drv.setup(cfg, mix, args.seed, device)
    setup_s = time.perf_counter() - t_start
    tc = state["tc"]
    with (spans.recording() if args.recording
          else contextlib.nullcontext()) as recorder:
        rec = drv.window(state, args.seconds, bool(args.trace))
    common.sync(device)
    if recorder is not None:
        rec["program"] = recorder.export()
    rec.setdefault("val_freq", tc.val_freq)
    e2e = drv.end_to_end(rec)
    checks = drv.check(state, rec, limits)
    line = {
        "workload": args.workload, "seed": args.seed, "trace": args.trace,
        "recording": args.recording,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "correct": run.verdict(rec, checks), "checks": checks,
        "setup_s_in_process": setup_s, **e2e,
        "readings": {name: read(rec) for name, read in READERS.items()},
        "jobs": job_table(rec),
    }
    if args.trace:
        line["per_layer"] = {
            m["name"]: common.metric_reader(m["name"])(rec)
            for m in bench["per_layer"]
            if args.workload in m.get("workloads", [args.workload])}
        line["breakdown"] = trace.breakdown(rec["slice"])
    if recorder is not None:
        line["counters"] = rec["program"]["counters"]
    print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(line, program=rec.get("program")), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
