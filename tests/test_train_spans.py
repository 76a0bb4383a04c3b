"""``train_spans.py``'s readings on a synthetic recording: each reading
from the window's jobs after the first, None where there is nothing to
read, the profiler slice's idle time inside the replays' spans, and each
job's covered share."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import train_spans as ts  # noqa: E402

MS = 1_000_000
UNIX = 1_790_000_000_000_000_000


def _job(jid, t0, scale=1):
    """A graphed job of three blocks from ``t0`` (ms); ``scale`` stretches
    every time in it."""
    at = lambda ms: (t0 + ms * scale) * MS
    rows = [
        (jid, None, jid, "job", at(0), at(115), {"entry": "train_model"}),
        (jid + 1, jid, jid, "train.setup", at(0), at(5), {}),
        (jid + 2, jid, jid, "train.block", at(10 / scale), at(30),
         {"b": 0, "graphed": False}),
        (jid + 3, jid, jid, "train.block", at(30), at(100),
         {"b": 1, "graphed": True}),
        (jid + 4, jid + 3, jid, "graph.capture", at(31), at(81),
         {"kernel_nodes": 7174 * scale}),
        (jid + 5, jid + 4, jid, "graph.capture.body", at(32), at(50), {}),
        (jid + 6, jid + 4, jid, "graph.capture.count", at(51), at(61), {}),
        (jid + 7, jid + 3, jid, "graph.replay", at(82), at(84), {}),
        (jid + 8, jid, jid, "train.block", at(100), at(115),
         {"b": 2, "graphed": True}),
        (jid + 9, jid + 8, jid, "graph.replay", at(100), at(101), {}),
        (jid + 10, jid + 8, jid, "train.flag_wait", at(101), at(114), {}),
    ]
    device = {jid + 2: (0, 20 * MS * scale),
              jid + 7: (25 * MS, 38 * MS * scale),
              jid + 9: (38 * MS * scale + MS // 2,
                        51 * MS * scale + MS // 2)}
    return rows, device


def _rec(n_jobs=3):
    spans, device, harness = [], {}, []
    for j in range(n_jobs):
        t0 = 1000 * j
        rows, dev = _job(100 * j + 1, t0, scale=10 if j == 0 else 1)
        spans += rows
        device.update(dev)
        harness.append(("job", (t0 - 1) / 1e3, (t0 + 115) / 1e3, 500, True))
    program = {"spans": spans, "counters": {}, "device": device,
               "anchors": [(0, UNIX), (10 ** 13, UNIX + 10 ** 13)]}
    return {"program": program, "spans": harness, "val_freq": 10}


def test_readings_leave_the_first_job_out():
    rec = _rec()
    got = {name: read(rec) for name, read in ts.READERS.items()}
    assert got.pop("device_idle_in_launch_pct.train") is None
    assert got == pytest.approx({
        "job_setup_ms": 10.0, "eager_block_ms": 20.0, "capture_ms": 40.0,
        "replay_launch_ms": 1.5, "flag_wait_ms": 13.0,
        "block_device_ms": 13.0, "block_gap_ms": 0.5,
        "graph_kernels_per_step": 717.4})


@pytest.mark.parametrize("rec", [{}, _rec(n_jobs=1)], ids=["none", "one"])
def test_nothing_to_read_gives_none(rec):
    for read in ts.READERS.values():
        assert read(rec) is None


def test_idle_inside_the_replays_on_the_profilers_clock():
    rec = _rec()
    # the traced job's replay spans 820-840 and 1000-1010 ms (perf clock)
    w0 = UNIX + 800 * MS
    rec["slice"] = {
        "device": [("k", w0, w0 + 25 * MS, (1,)),
                   ("k", w0 + 35 * MS, w0 + 100 * MS, (2,))],
        "runtime": [], "window_ns": (w0, w0 + 120 * MS)}
    # idle 25-35 ms (middle 830 ms: inside a replay) and 100-120 ms (middle
    # 910 ms: outside), over a 120 ms window
    assert ts.read_device_idle_in_launch_pct_train(rec) == pytest.approx(
        100 * 10 / 120)


def test_job_table_covers_each_job():
    rows = ts.job_table(_rec())
    assert len(rows) == 3
    row = rows[1]
    assert row["job_s"] == pytest.approx(0.116)
    assert row["covered"] == pytest.approx(110 / 116)
    assert row["capture_ms"] == pytest.approx([40.0])
    assert row["eager_block_device_ms"] == pytest.approx([20.0])
    assert row["block_gap_ms"] == pytest.approx(0.5)
    assert row["replays"] == 2
