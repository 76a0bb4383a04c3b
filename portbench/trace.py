"""The traced slice of a ``--trace 1`` run and the reduction of its events.

The profiler cannot hold a whole window at hundreds of thousands of
kernels a second, so a traced run profiles one slice of it: ``start`` and
``stop`` on one thread (the profiler's state belongs to the thread that
started it; CUPTI records the card's work and the CUDA runtime calls of
every thread). It is PyTorch's Kineto profiler driven directly, as
``torch.profiler.profile`` drives it, without what that class adds at
its stop: a ``torch.cuda.synchronize()``, which fails while another
thread captures a CUDA graph, and building a Python object for every
event, which takes minutes for a slice of a training job. Only the card's activities are recorded (its operations
and the CUDA runtime calls): recording the host's operators as well slows
the host several times over and would measure the profiler. The slice's
events are reduced in memory to plain tuples, and nothing is written to
disk.

The slice's window opens with the launch call of a one-cycle sleep
kernel made at ``start`` (the profiler's clock is its own) and lasts as
long as ``start`` to ``stop`` on the host's clock.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

GRAPH_LAUNCH = "cudaGraphLaunch"
# A kernel's name in the breakdown: the start of its signature.
NAME_CHARS = 120


class Slice:
    def __init__(self):
        self.t0 = self.t1 = None
        self.events: Optional[dict] = None

    def start(self) -> None:
        from torch.autograd import ProfilerActivity
        from torch.autograd.profiler import (
            ProfilerConfig,
            ProfilerState,
            _enable_profiler,
            _ExperimentalConfig,
            _prepare_profiler,
        )

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                False, False, _ExperimentalConfig())
        activities = {ProfilerActivity.CUDA}
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities)
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1)

    def stop(self) -> None:
        from torch.autograd.profiler import _disable_profiler

        self.t1 = time.perf_counter()
        result = _disable_profiler()
        self.events = reduce(result.events(), self.t0, self.t1)


class ReplayWatch:
    """Places a ``Slice`` around one training job's replays ``first`` to
    ``last - 1``, from the job's own thread, and notes when the job's
    first replay starts.

    A ``sys.setprofile`` hook on the calling thread, while the ``with``
    block runs, counts the calls of ``torch.cuda.CUDAGraph.replay``: the
    profiler starts as replay ``first`` is called and stops, after a
    synchronize, as replay ``last`` is called. The slice then holds whole
    replayed blocks only and no capture, and the job's thread both starts
    and stops the profiler. The hook observes; it changes nothing the job
    does, and costs a Python call per Python call of the job's thread (the
    replays make few)."""

    def __init__(self, tracer: Slice, first: int, last: int):
        self.code = torch.cuda.CUDAGraph.replay.__code__
        self.tracer, self.first, self.last = tracer, first, last
        self.calls = 0
        self.t_first: Optional[float] = None

    def __call__(self, frame, event, arg):
        if event != "call" or frame.f_code is not self.code:
            return
        self.calls += 1
        if self.calls == 1:
            self.t_first = time.perf_counter()
        if self.calls == self.first:
            self.tracer.start()
        elif self.calls == self.last:
            torch.cuda.synchronize()
            self.tracer.stop()

    def __enter__(self):
        sys.setprofile(self)
        return self

    def __exit__(self, *exc):
        sys.setprofile(None)
        return False


def _ids(e) -> Tuple[int, ...]:
    ids = [e.correlation_id()]
    linked = getattr(e, "linked_correlation_id", None)
    if linked is not None:
        ids.append(linked())
    return tuple(i for i in ids if i)


def reduce(events, t0: float, t1: float) -> dict:
    """The slice as plain data: device operations (name, start, end, ids),
    CUDA runtime calls (name, start, end, ids) and the window (start, end)
    on the profiler's clock."""
    device, runtime = [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((name, e.start_ns(), e.end_ns(), _ids(e)))
        elif name.startswith("cuda"):
            runtime.append((name, e.start_ns(), e.end_ns(), _ids(e)))
    mark = [d for d in device if "spin_kernel" in d[0]]
    launch = launched(runtime, mark[:1])
    if not launch:
        raise RuntimeError("the profiler recorded no start mark")
    w0 = launch[0][1]
    device.sort(key=lambda e: e[1])
    runtime.sort(key=lambda e: e[1])
    return {"device": device, "runtime": runtime,
            "window_ns": (w0, w0 + int((t1 - t0) * 1e9))}


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset", "Memory"))


def busy_intervals(ev: dict) -> List[Tuple[int, int]]:
    """The union of the device operations' intervals inside the window."""
    w0, w1 = ev["window_ns"]
    out: List[Tuple[int, int]] = []
    for _, s, e, _ in ev["device"]:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(ev: dict) -> float:
    return sum(e - s for s, e in busy_intervals(ev)) / 1e9


def window_s(ev: dict) -> float:
    w0, w1 = ev["window_ns"]
    return (w1 - w0) / 1e9


def graph_launches(ev: dict) -> List[tuple]:
    return [r for r in ev["runtime"] if r[0] == GRAPH_LAUNCH]


def launched(runtime, device_ops) -> List[tuple]:
    """The runtime calls that launched ``device_ops``, by correlation id."""
    ids = {i for d in device_ops for i in d[3]}
    return [r for r in runtime if ids.intersection(r[3])]


def launched_by(ev: dict, launches) -> List[tuple]:
    """The device operations that ``launches`` (runtime calls) started, by
    correlation id."""
    ids = {i for r in launches for i in r[3]}
    return [d for d in ev["device"] if ids.intersection(d[3])]


def breakdown(ev: dict, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, summed by name, and the
    device's idle time inside the window summed by what the host was in:
    the CUDA runtime call that spans the gap's middle, else "host:
    outside CUDA calls"."""
    ops: Dict[str, float] = {}
    for name, s, e, _ in ev["device"]:
        name = name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
    w0, w1 = ev["window_ns"]
    edges = [w0] + [t for iv in busy_intervals(ev) for t in iv] + [w1]
    spans = sorted((s, e, n) for n, s, e, _ in ev["runtime"])
    idle: Dict[str, float] = {}
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        label = "host: outside CUDA calls"
        while j < len(spans) and spans[j][1] < a:
            j += 1
        for s, e, n in spans[j:]:
            if s > mid:
                break
            if e >= mid:
                label = n
                break
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    by = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [list(kv) for kv in by(ops)],
            "idle_gaps": [list(kv) for kv in by(idle)]}
