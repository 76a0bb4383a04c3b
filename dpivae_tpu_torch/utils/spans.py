"""Spans, counters and CUDA-event intervals of the training path, kept in
memory while an operator records them.

Recording is off by default. Each instrumented boundary then reads one
module-level flag and gets a shared no-op context back: no allocation, no
clock read, no CUDA event. To see where a training call's time goes::

    from dpivae_tpu_torch.utils import spans

    with spans.recording() as rec:
        params, logs = train_model(config, model, case, data_train, data_val)
    out = rec.export()

``out`` holds:

- ``"spans"``: one tuple ``(id, parent id, job id, name, t0_ns, t1_ns,
  attrs)`` a span, in the order they opened. Times are
  ``time.perf_counter_ns()``; the parent is the span open on the same
  thread when it opened; the job id is the id of the outermost ``job``
  span, so every span of one training call shares it (None outside a
  job).
- ``"counters"``: name -> count.
- ``"counter_attrs"``: name -> ``[(attrs, count), ...]``, the shares of
  the counters counted with attributes.
- ``"device"``: span id -> ``(t0_ns, t1_ns)`` for the spans that record a
  CUDA event pair: when the stream reached the span's start and its end,
  from the first event recorded in the same job. The pairs are read at
  export, so recording adds no synchronize to the program.
- ``"anchors"``: ``(perf_counter_ns, time_ns)`` pairs sampled when the
  recording started and at export. ``unix_ns`` maps a span's time onto the
  Unix clock, the clock of the events of PyTorch's profiler, so the spans
  can be laid over a profiler trace.

What is recorded (names as in ``out``):

- ``job`` (attrs ``entry``, ``members``, ``n_iter``): one call of
  ``train_model``, ``train_sweep``, ``train_hyper_sweep`` or
  ``train_sweep_data``. A call made while a job is open joins that job.
- ``sweep.chunk``: one chunk of members of a sweep, child
  ``sweep.member_starts``: the members' generators, data and initial
  weights, stacked on the device.
- ``train.setup``: building the ``Trainer`` / ``MemberTrainer``.
- ``train.block`` (attrs ``b``, ``graphed``): one iteration of the loop
  over validation blocks: block ``b``'s launch, with its capture at the
  first graphed block, and the wait on the previous block's flag. A block
  run eagerly on CUDA records its event pair.
- ``graph.capture`` (attr ``kernel_nodes``): a CUDA graph's capture, the
  whole ``torch.cuda.graph`` block; children ``graph.capture.body`` (the
  body's launches) and ``graph.capture.count`` (counting the graph's
  kernel and memcpy nodes, which only a recording does). Its self time is the
  capture's entry and exit: a synchronize, emptying the caching
  allocator, ending the capture and instantiating the graph.
- ``graph.replay``, with its event pair: one replay of a graph.
- ``train.flag_wait``: the host waiting for a block's all-stopped flag.
- counters ``graph.captures``, ``graph.replays``, ``graph.kernel_nodes``
  (the kernel and memcpy nodes of every graph captured, which the card
  runs as kernels: ``train/graph.py`` ``kernel_nodes``).
- ``sweep.member_data`` (attrs ``bytes``, ``members``): ``train_sweep_data``
  copying the given per-member datasets to host arrays; counter
  ``sweep.member_data_bytes``, the bytes of those arrays.
- counters ``latent.fused.fwd`` / ``latent.fused.bwd`` (a launch of the
  latent kernels, ``ops/latent.py``) and ``latent.plain`` (attr
  ``model_type``): a latent-Gaussian composition the loss runs in plain
  PyTorch, the P model's always and the S model's under ``torch.func``
  transforms and traces. All three count where the host launches the
  work: eager blocks and captures, not replays.

A recording is one per process at a time; spans opened on several threads
nest per thread.
"""

from __future__ import annotations

import contextlib
import itertools
import statistics
import threading
import time
from typing import Iterator, Optional

import torch

# The recording in progress; None while recording is off.
_REC: Optional["Recording"] = None
_LOCAL = threading.local()


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _anchor():
    before = time.perf_counter_ns()
    unix = time.time_ns()
    return (before + time.perf_counter_ns()) // 2, unix


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class Recording:
    """What ``recording()`` gathers; ``export()`` returns it as plain
    data."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self.counter_attrs = {}
        self.pairs = []
        self.anchors = [_anchor()]
        self.ids = itertools.count(1)
        self.lock = threading.Lock()

    def export(self) -> dict:
        """The spans, counters, device intervals and clock anchors
        (module docstring). Waits for the recorded events."""
        device, base = {}, {}
        for sid, job, start, end in self.pairs:
            end.synchronize()
            first = base.setdefault(job, start)
            device[sid] = (round(first.elapsed_time(start) * 1e6),
                           round(first.elapsed_time(end) * 1e6))
        return {"spans": [tuple(row) for row in self.spans],
                "counters": dict(self.counters),
                "counter_attrs": {name: [(dict(key), n) for key, n in
                                         by.items()]
                                  for name, by in self.counter_attrs.items()},
                "device": device,
                "anchors": self.anchors + [_anchor()]}


class Span:
    """One open span; ``set(**attrs)`` adds attributes."""

    __slots__ = ("rec", "row", "start")

    def __init__(self, rec: Recording, name: str, device: bool, job: bool):
        stack = _stack()
        top = stack[-1] if stack else None
        sid = next(rec.ids)
        self.rec = rec
        self.row = [sid, top[0] if top else None,
                    sid if job else (top[2] if top else None), name,
                    0, None, {}]
        self.start = None
        if device:
            self.start = torch.cuda.Event(enable_timing=True)

    def set(self, **attrs) -> None:
        self.row[6].update(attrs)

    def __enter__(self) -> "Span":
        self.rec.spans.append(self.row)
        _stack().append(self.row)
        if self.start is not None:
            self.start.record()
        self.row[4] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.rec.pairs.append((self.row[0], self.row[2], self.start,
                                   end))
        self.row[5] = time.perf_counter_ns()
        _stack().pop()
        return False


def span(name: str, device: bool = False):
    """A span named ``name`` as a context, entered as a ``Span``; while
    recording is off, a no-op entered as None. ``device`` also records a
    CUDA event pair on the current stream at its start and end."""
    if _REC is None:
        return _OFF
    return Span(_REC, name, device, False)


def job(entry: str):
    """The ``job`` span of one training call (``entry``: the public
    function's name), or a no-op where recording is off or a job is
    already open on this thread."""
    if _REC is None:
        return _OFF
    stack = _stack()
    if stack and stack[-1][2] is not None:
        return _OFF
    sp = Span(_REC, "job", False, True)
    sp.set(entry=entry)
    return sp


def count(name: str, n: int = 1, **attrs) -> None:
    """Adds ``n`` to the counter ``name`` while recording, and with
    ``attrs`` to its share under those attributes."""
    rec = _REC
    if rec is None:
        return
    with rec.lock:
        rec.counters[name] = rec.counters.get(name, 0) + n
        if attrs:
            by = rec.counter_attrs.setdefault(name, {})
            key = tuple(sorted(attrs.items()))
            by[key] = by.get(key, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Records spans and counters while the block runs."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a span recording is already open")
    rec = Recording()
    _REC = rec
    try:
        yield rec
    finally:
        _REC = None


def unix_ns(out: dict, t_ns: int) -> int:
    """A time of an export ``out`` (``time.perf_counter_ns()``) on the Unix
    clock, by the (low) median offset of its anchors."""
    return t_ns + statistics.median_low(u - p for p, u in out["anchors"])
