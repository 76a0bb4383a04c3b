"""CUDA-graph capture and replay of a training or an inference body
(counterpart of the JAX package's compiled loop,
dpivae_tpu/train/train.py:398-500: the scan over validation blocks, jitted
once and cached by ``get_train_fn``; and of its jitted sampling, which
``utils/graph_cache.py`` captures with this class).

The card's counterpart of one XLA program is a CUDA graph: a body's
launches (a whole validation block of training: ``val_freq`` train steps
with their forward, backward, clip and Adam, the validation pass, the
early-stop update and the block's ``pick``; or one sampling call)
recorded once and replayed with one launch. ``Graphed`` captures a body
on a side stream, on its own memory pool or on one that several graphs
share (``pool=``), after registering every CUDA ``torch.Generator`` the
body draws from, so that each replay advances each generator as the eager
body would (the default generator alone is registered by
``torch.cuda.graph`` itself). Replays then draw the same numbers an eager
run would.

A captured body reads nothing from the host, and every value that changes
from call to call (the block and step index, the schedule row, Adam's
step count, the early-stop state) lives in a device tensor the body
reads: a Python number is baked into the graph at capture.

A data-parallel block holds NCCL all-reduces (``parallel/mesh.py``
``all_reduce_sum_``), and is captured all the same (NCCL >= 2.9.6 records
its kernels into a graph). What ProcessGroupNCCL does with a collective
enqueued under capture: the blocking ``dist.all_reduce`` (``async_op``
False) makes the capturing stream wait on the collective's end, which
the capture records as a dependency of the graph and which blocks no
host thread; the collective's work object is not handed to the
watchdog thread while the stream captures (it would query an event of
the capture), and capture in ``thread_local`` mode keeps that thread's
own CUDA calls from voiding it; the communicator is made by the first,
eager, block, before any capture. A replay then runs the all-reduce
with the rest of the block, on every rank, each rank replaying its own
graph.

The kernels' wrappers count their launches in Python
(``fused_mlp.launches``, ``fused_mlp_hidden.launches``,
``latent.latent_fwd.launches``, ``latent.latent_bwd.launches``), which a
replay does not run. ``Graphed`` takes back what the capture added to the counts
and adds it again on every replay, so the counts stay those of an eager
run.

While ``utils.spans`` records, ``Graphed`` records the spans
``graph.capture`` (with the graph's kernel and memcpy nodes, counted
inside the capture by ``kernel_nodes``) and ``graph.replay`` (with a CUDA
event pair on the stream), and counts captures, replays and those
nodes.

``resolve_cuda_graph`` resolves a ``cuda_graph`` argument, a trainer's
or an inference call's: "auto" is True on CUDA, with or without a mesh.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Iterable, Optional

import torch

from dpivae_tpu_torch.ops import fused_mlp as _ops
from dpivae_tpu_torch.ops import latent as _latent
from dpivae_tpu_torch.utils import spans

_COUNTED = (_ops.fused_mlp, _ops.fused_mlp_hidden, _latent.latent_fwd,
            _latent.latent_bwd)


def resolve_cuda_graph(cuda_graph, device: Optional[torch.device],
                       mesh=None) -> bool:
    """``cuda_graph`` as a bool: "auto" is True on a CUDA device and False
    otherwise; True raises on another device; False stays False. With a
    ``mesh`` and no ``device`` the mesh's device is read (a trainer's
    check at build time)."""
    if not (cuda_graph == "auto" or isinstance(cuda_graph, bool)):
        raise ValueError(f"cuda_graph must be True, False or 'auto', got "
                         f"{cuda_graph!r}")
    if device is None:
        device = mesh.device
    if cuda_graph is True and device.type != "cuda":
        raise ValueError(f"cuda_graph=True needs a CUDA device, the call "
                         f"is on {device}")
    return cuda_graph is True or (cuda_graph == "auto"
                                  and device.type == "cuda")


def _counts():
    return [f.launches for f in _COUNTED]


# CUgraphNodeType's kernel and memcpy nodes (cuda.h).
_KERNEL_NODES = (0, 1)


def kernel_nodes(stream: torch.cuda.Stream) -> int:
    """The kernel and memcpy nodes of the graph being captured on
    ``stream``, so far. A block's memcpy nodes copy between device
    buffers; the card runs them as copy kernels (``memcpy32_post`` in a
    profiler trace), or on the copy engine in a graph instantiated after
    the profiler first attached to the process. Memset and event nodes are
    not counted. Called inside the capture, through ``libcuda``
    (``cuStreamGetCaptureInfo``, then ``cuGraphGetNodes`` and
    ``cuGraphNodeGetType``; querying the graph under capture is
    allowed)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    ptr, size_t = ctypes.c_void_p, ctypes.c_size_t

    def check(result: int, call: str) -> None:
        if result != 0:
            raise RuntimeError(f"{call} returned CUresult {result}")

    status, capture_id = ctypes.c_int(), ctypes.c_ulonglong()
    graph, deps, n_deps = ptr(), ptr(), size_t()
    get_info = cuda.cuStreamGetCaptureInfo_v2
    get_info.argtypes = [ptr] + [ptr] * 5
    check(get_info(ptr(stream.cuda_stream), ctypes.byref(status),
                   ctypes.byref(capture_id), ctypes.byref(graph),
                   ctypes.byref(deps), ctypes.byref(n_deps)),
          "cuStreamGetCaptureInfo_v2")
    if not graph.value:
        raise RuntimeError("the stream is not capturing a graph")
    get_nodes, get_type = cuda.cuGraphGetNodes, cuda.cuGraphNodeGetType
    get_nodes.argtypes, get_type.argtypes = [ptr, ptr, ptr], [ptr, ptr]
    n = size_t(0)
    check(get_nodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ptr * n.value)()
    check(get_nodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes[:n.value]:
        check(get_type(ptr(node), ctypes.byref(kind)), "cuGraphNodeGetType")
        kernels += kind.value in _KERNEL_NODES
    return kernels


class Graphed:
    """``body()`` captured once into a CUDA graph; ``replay()`` runs it
    again and returns its output tensors (the same tensors every time,
    overwritten by each replay).

    Args:
        body: a function of no arguments that launches its work on the
            current stream and returns a tensor or a tuple of tensors. It
            must have run eagerly on ``stream`` first (lazy allocations,
            the ctypes kernels' first-launch attributes, Adam's state).
        generators: every CUDA generator the body draws from.
        stream: the side stream to capture on.
        pool: a memory pool (``torch.cuda.graph_pool_handle()``) to capture
            into, shared with other graphs; None gives the graph its own.
            Graphs that share a pool may reuse each other's freed memory,
            so their replays must not overlap, and each replay's outputs
            must be read before another graph of the pool replays.

    A capture or replay that fails raises; nothing falls back to eager.
    """

    def __init__(self, body: Callable, generators: Iterable[torch.Generator],
                 stream: torch.cuda.Stream, pool=None):
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            if g.device.type != "cuda":
                raise ValueError(
                    f"a CUDA graph draws from CUDA generators only, got one "
                    f"on {g.device}; pass a CUDA generator, or "
                    f"cuda_graph=False to draw from this one eagerly")
            self.graph.register_generator_state(g)
        before = _counts()
        # thread_local: another thread's CUDA calls during the capture (the
        # NCCL watchdog's, say) do not void it; the autograd engine's
        # launches onto the capturing stream, and NCCL's collectives joined
        # to it, are captured all the same.
        with spans.span("graph.capture") as capture:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                with spans.span("graph.capture.body"):
                    self.out = body()
                if capture is not None:
                    with spans.span("graph.capture.count"):
                        nodes = kernel_nodes(torch.cuda.current_stream())
                    capture.set(kernel_nodes=nodes)
                    spans.count("graph.kernel_nodes", nodes)
        spans.count("graph.captures")
        self.launches = [a - b for a, b in zip(_counts(), before)]
        for f, n in zip(_COUNTED, before):
            f.launches = n

    def replay(self):
        with spans.span("graph.replay", device=True):
            self.graph.replay()
        spans.count("graph.replays")
        for f, n in zip(_COUNTED, self.launches):
            f.launches += n
        return self.out


class SideStream:
    """The stream a graphed loop runs on, as a context: it waits for the
    work queued before it, runs the loop (eager warm-up, captures and
    replays) as its current stream, and the caller's stream waits for it
    on exit."""

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device=device)
        self._ctx: Optional[torch.cuda.StreamContext] = None

    def __enter__(self) -> torch.cuda.Stream:
        self._caller = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(self._caller)
        self._ctx = torch.cuda.stream(self.stream)
        self._ctx.__enter__()
        return self.stream

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        self._caller.wait_stream(self.stream)
        return False
