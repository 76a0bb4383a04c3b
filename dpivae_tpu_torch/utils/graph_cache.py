"""Shared CUDA-graph cache of the inference calls (counterpart of
dpivae_tpu/utils/jit_cache.py).

The JAX package runs every sampling call of evaluation, of the figures and
of serving as an XLA program compiled once per call signature and kept in
a bounded LRU. The card's counterpart of a compiled program is a CUDA
graph (``train/graph.py``): the call's launches recorded once and replayed
with one launch. This module keeps one graph per signature:

- ``cached_sample_mean``: MC means of ``DPIVAE.sample`` slots, reduced
  inside the graph (jit_cache.py:89-119);
- ``cached_sample``: ``DPIVAE.sample`` of some slots (jit_cache.py:122-135);
- ``cached_sample_prior``: ``DPIVAE.sample_prior``, which the JAX figures
  jit (dpivae_tpu/viz/visualization.py:254);
- ``cached_program``: a loaded serving artifact's program with its
  normals drawn inside the graph, as the JAX artifact is jitted once per
  request shape (dpivae_tpu/serving.py:180-190).

A signature is what jit_cache.py keys on (the model's identity, the shapes
of x and c, ``cond``, ``n``, ``grl_alpha``, the slots) and, because a
graph bakes in the addresses of what it reads where JAX passes params as
arguments, the params' identity and their tensors' addresses; then the
inputs' dtypes, whether the randomness comes from a generator or from a
``noise`` mapping (and the mapping's shapes), and the device. The model
and the params are held by weakref: a recycled ``id`` rebuilds the graph
and never replays a stale one (jit_cache.py:75-86).

Each entry holds static input buffers, allocated outside the capture, one
generator registered with the graph, and the graph. A call

1. copies x and c (and the noise) into the static buffers, and the
   caller's generator state into the entry's generator;
2. replays the graph;
3. copies the outputs out, and the advanced generator state back into the
   caller's generator, whose next draw is then what it would be after the
   eager call.

The first call of a signature runs the body eagerly on those buffers (the
warm-up a capture needs), answers from that run, then captures; the
fused-MLP launch counters count one launch per call either way (``Graphed``
takes back what the capture counted).

All graphs of a device capture into one memory pool. One lock covers the
whole of every call, so no two replays overlap and each call's outputs are
copied out before the next replay: a later graph may then reuse memory
that an earlier one freed. (jit_cache.py's lock covers only the lookup: an
XLA executable is reentrant, a graph with static buffers is not.)

The bodies read nothing from the host: a value read there would be baked
into the graph (tests/test_torch_graph_cache.py runs them under a guard).

The sweeps' sampling (``sweep/sweep.py``: ``sweep_sample``,
``sweep_predict_y``, ``sweep_disentanglement_latents``, the counterparts
of the JAX package's ``jit(vmap(...))`` in its ``_SWEEP_JIT_CACHE``)
replays one graph per chunk of members through ``cached_members``. Such a
call's params are static inputs too, copied in like x and c, so its
signature holds only shapes, dtypes and what the caller names (config,
case, options), never an address: one graph serves every chunk of every
sweep of those shapes. It draws from one generator per member slot (two
in the study's latents: the member's key and its probes'), each owned by
the entry and registered with its graph; a call copies the caller's
generator states in and the advanced states back. These entries sit in an
LRU of their own, bounded by bytes: each captures into its own memory
pool, so that an evicted entry's memory goes back to the card
(``torch.cuda.empty_cache()``), and together they hold at most
``_MEMBER_SHARE`` of the card's memory, the newest entry always kept.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Callable, Dict, Mapping, Optional, Sequence

import torch

from dpivae_tpu_torch.train.graph import Graphed, SideStream
from dpivae_tpu_torch.utils import draw_normals

# Bounded LRU: each entry pins its graph, its static buffers and its
# outputs on the device (jit_cache.py:17-20).
_MAX_ENTRIES = 64

# The share of a card's memory the member-chunk graphs may hold together:
# the share of its free memory that one training chunk of a sweep plans
# for (sweep/sweep.py _MEMORY_SHARE).
_MEMBER_SHARE = 0.5

# One lock for every cache: the graphs of a device share one pool.
_LOCK = threading.Lock()
# device -> (the side stream of its warm-ups, captures and replays, its
# graphs' memory pool), made on first use.
_DEVICES: Dict[torch.device, tuple] = {}


class GraphLRU:
    """Bounded LRU of graph entries keyed by signature. Not locked itself:
    every use is under the module's lock."""

    def __init__(self, maxsize: int = _MAX_ENTRIES):
        self._max = maxsize
        self._entries: OrderedDict = OrderedDict()

    def get(self, key, owners) -> Optional["_Entry"]:
        """The entry of ``key`` if it was built for these very ``owners``
        (compared by weakref, not by ``id``), else None."""
        entry = self._entries.get(key)
        if entry is None or not entry.owned_by(owners):
            return None
        self._entries.move_to_end(key)
        return entry

    def put(self, key, entry: "_Entry") -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self._max:
            self._entries.popitem(last=False)

    def entries(self):
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)


class ByteLRU:
    """LRU of graph entries, each on its own memory pool, bounded by the
    device bytes they hold together: ``share`` of the card's memory. The
    newest entry stays even when it alone is over the bound. Not locked
    itself: every use is under the module's lock."""

    def __init__(self, share: float):
        self.share = share
        self._entries: OrderedDict = OrderedDict()

    def get(self, key, owners=()) -> Optional["_Entry"]:
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry: "_Entry") -> None:
        device = next(iter(entry.inputs.values())).device
        entry.nbytes = _static_bytes(entry) + _pool_bytes(entry.graph)
        self._entries[key] = entry
        limit = self.share * _memory(device)
        evicted = False
        while len(self._entries) > 1 and self.nbytes() > limit:
            self._entries.popitem(last=False)
            evicted = True
        if evicted and device.type == "cuda":
            torch.cuda.empty_cache()

    def nbytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def entries(self):
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)


class _Entry:
    """One signature's static input buffers, generators and graph."""

    def __init__(self, owners, inputs: Dict[str, torch.Tensor],
                 generators: Sequence[torch.Generator]):
        self.refs = tuple(weakref.ref(o) for o in owners)
        self.inputs = inputs
        self.generators = list(generators)
        self.graph: Optional[Graphed] = None
        self.nbytes = 0

    def owned_by(self, owners) -> bool:
        return all(r() is o for r, o in zip(self.refs, owners))


_MEAN_CACHE = GraphLRU()
_SAMPLE_CACHE = GraphLRU()
_PRIOR_CACHE = GraphLRU()
_PROGRAM_CACHE = GraphLRU()
_MEMBER_CACHE = ByteLRU(_MEMBER_SHARE)


def _memory(device: torch.device) -> int:
    """The card's memory in bytes."""
    return torch.cuda.get_device_properties(device).total_memory


def _static_bytes(entry: _Entry) -> int:
    return sum(t.numel() * t.element_size() for t in entry.inputs.values())


def _pool_bytes(graph: Graphed) -> int:
    """Device bytes of the segments of ``graph``'s own memory pool: its
    outputs and the memory its launches reuse."""
    pool = tuple(graph.graph.pool())
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == pool)


def _context(device: torch.device):
    """The side stream and the memory pool of ``device``'s graphs."""
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, the call is on "
                         f"{device}; pass cuda_graph=False")
    ctx = _DEVICES.get(device)
    if ctx is None:
        with torch.cuda.device(device):
            ctx = _DEVICES[device] = (SideStream(device),
                                      torch.cuda.graph_pool_handle())
    return ctx


def _load(entry: _Entry, args, generators) -> None:
    for name, a in args.items():
        entry.inputs[name].copy_(a)
    for own, g in zip(entry.generators, generators):
        own.set_state(g.get_state())


def _store(entry: _Entry, generators) -> None:
    for own, g in zip(entry.generators, generators):
        g.set_state(own.get_state())


def _run(cache, sig, owners, args: Dict[str, torch.Tensor],
         generators: Sequence[torch.Generator], make_body: Callable):
    """One cached call: ``args`` into the entry's static buffers and each
    of ``generators``' states into the entry's generator of its place, a
    replay, and copies of the outputs, the advanced states back in
    ``generators``. ``make_body(inputs, generators)`` gives a new entry's
    body, a function of no arguments that reads the static ``inputs`` and
    draws from the entry's ``generators``. The first of ``args`` gives the
    device. An inference cache's graphs capture into the device's shared
    pool and run under inference mode; a ``ByteLRU``'s (the member
    chunks') each into its own pool, under ``no_grad``, so that their
    outputs are ordinary tensors."""
    device = next(iter(args.values())).device
    for g in generators:
        if g.device.type != device.type:
            raise ValueError(
                f"a graphed call draws from a generator on its own device "
                f"({device}), got one on {g.device}; pass such a "
                f"generator, or cuda_graph=False to draw from this one "
                f"eagerly")
    key = (sig, tuple((n, a.shape, a.dtype) for n, a in args.items()),
           len(generators), device)
    members = isinstance(cache, ByteLRU)
    with _LOCK, torch.no_grad(), torch.inference_mode(not members):
        side, shared = _context(device)
        entry = cache.get(key, owners)
        with side as stream:
            if entry is None:
                entry = _Entry(owners, {
                    name: torch.empty(a.shape, dtype=a.dtype, device=device)
                    for name, a in args.items()},
                    [torch.Generator(device=device) for _ in generators])
                body = make_body(entry.inputs, entry.generators)
                _load(entry, args, generators)
                out = body()
                _store(entry, generators)
                entry.graph = Graphed(body, entry.generators, stream,
                                      pool=None if members else shared)
                cache.put(key, entry)
                return out
            _load(entry, args, generators)
            out = entry.graph.replay()
            _store(entry, generators)
        # On the caller's stream, which waited for the replay.
        return _copies(out)


def _copies(out) -> tuple:
    """Copies of the tensors ``out`` (all float32, as every body returns
    them): views of one new buffer, filled by one kernel."""
    flat = torch.cat([o.reshape(-1) for o in out])
    return tuple(part.view(o.shape) for part, o in
                 zip(torch.split(flat, [o.numel() for o in out]), out))


def _listed(generator: Optional[torch.Generator]) -> list:
    return [] if generator is None else [generator]


def _one(generators) -> Optional[torch.Generator]:
    return generators[0] if generators else None


def _noise_args(noise: Optional[Mapping[str, torch.Tensor]]):
    return {} if noise is None else {f"noise_{k}": v
                                     for k, v in sorted(noise.items())}


def _noise_of(inputs):
    """The ``noise`` mapping held in the static ``inputs``, or None."""
    noise = {k[len("noise_"):]: v for k, v in inputs.items()
             if k.startswith("noise_")}
    return noise or None


def _addresses(module) -> list:
    """The addresses of ``module``'s parameters and buffers, walked as
    they stand now (a third of ``parameters()``'s host time)."""
    out = [t.data_ptr() for t in (*module._parameters.values(),
                                  *module._buffers.values())
           if t is not None]
    for child in module._modules.values():
        if child is not None:
            out += _addresses(child)
    return out


def _params_sig(params):
    return (id(params), tuple(_addresses(params)))


def _sample(cache, reduce, model, params, x, c, cond, n, grl_alpha, slots,
            generator, noise):
    """``model.sample`` of ``slots`` through ``cache``, each slot's output
    passed through ``reduce`` inside the graph."""
    sig = (id(model), _params_sig(params), bool(cond), int(n),
           None if grl_alpha is None else float(grl_alpha), slots)

    def make_body(inputs, gens):
        def body():
            out = model.sample(params, inputs["x"], inputs["c"], cond=cond,
                               n=n, grl_alpha=grl_alpha,
                               generator=_one(gens), noise=_noise_of(inputs),
                               slots=slots)
            return tuple(reduce(out[i]) for i in slots)
        return body

    return _run(cache, sig, (model, params),
                dict(x=x, c=c, **_noise_args(noise)), _listed(generator),
                make_body)


def cached_sample_mean(model, params, x, c, *, cond: bool, n: int,
                       grl_alpha, outputs: Sequence[int] = (4,),
                       generator: Optional[torch.Generator] = None,
                       noise=None):
    """MC means of the ``model.sample`` slots ``outputs``, reduced inside
    the graph: the (n, batch, d) samples never leave it. Randomness from
    ``generator`` (its state is copied in, and the advanced state back) or
    from ``noise``, as in ``DPIVAE.sample``."""
    return _sample(_MEAN_CACHE, lambda a: torch.mean(a, dim=0), model,
                   params, x, c, cond, n, grl_alpha, tuple(outputs),
                   generator, noise)


def cached_sample(model, params, x, c, *, cond: bool, n: int, grl_alpha,
                  slots: Optional[Sequence[int]] = None,
                  generator: Optional[torch.Generator] = None, noise=None):
    """``model.sample(...)`` of ``slots`` (default all nine) through the
    cache: the 9-tuple, None in the places of the slots not computed."""
    slots = tuple(range(9)) if slots is None else tuple(slots)
    out = dict(zip(slots, _sample(_SAMPLE_CACHE, lambda a: a, model, params,
                                  x, c, cond, n, grl_alpha, slots, generator,
                                  noise)))
    return tuple(out.get(i) for i in range(9))


def cached_sample_prior(model, params, c, y, n: int = 1, *,
                        generator: Optional[torch.Generator] = None,
                        noise=None):
    """``model.sample_prior(params, c, y, n, ...)`` through the cache:
    (zc, log p(zc|c), zy, log p(zy|y)) on the device of ``c``."""
    sig = (id(model), _params_sig(params), int(n))

    def make_body(inputs, gens):
        def body():
            return model.sample_prior(
                params, inputs["c"], inputs["y"], n, generator=_one(gens),
                noise=_noise_of(inputs), device=inputs["c"].device)
        return body

    return _run(_PRIOR_CACHE, sig, (model, params),
                dict(c=c, y=y, **_noise_args(noise)), _listed(generator),
                make_body)


def cached_program(module, meta: dict, x, c, *,
                   generator: Optional[torch.Generator] = None, noise=None):
    """A loaded serving artifact's program (``module``, its sidecar
    ``meta``) on a request, through the cache: one graph per request
    shape, its body drawing the ABI's normals from the registered
    generator in the sidecar's ``draws`` order (or taking ``noise``), then
    calling the program."""
    names = tuple(i["name"] for i in meta["inputs"][2:])
    draws, n_mc = meta["draws"], meta["n_mc"]

    def make_body(inputs, gens):
        def body():
            eps = _noise_of(inputs)
            if gens:
                eps = draw_normals(draws, gens[0],
                                   (n_mc, inputs["x"].shape[0]),
                                   inputs["x"].device)
            return tuple(module(inputs["x"], inputs["c"],
                                *(eps[k] for k in names)))
        return body

    noise = None if noise is None else {k: noise[k] for k in names}
    return _run(_PROGRAM_CACHE, id(module), (module,),
                dict(x=x, c=c, **_noise_args(noise)), _listed(generator),
                make_body)


def cached_members(sig, args: Dict[str, torch.Tensor],
                   generators: Sequence[torch.Generator],
                   make_body: Callable) -> tuple:
    """One chunk of a sweep's members through the member-chunk cache:
    ``args`` (the chunk's params, data and inputs, each with a leading
    member axis) copied into the entry's static buffers, the states of
    ``generators`` (the chunk's, in slot order) into its own, a replay,
    copies of the outputs (float32 tensors) and the advanced states back.
    ``sig`` names what the body computes (config, case, options) and must
    hold no address; ``make_body(inputs, generators)`` as in ``_run``. The
    first call of a signature answers from the eager warm-up, then
    captures into the entry's own pool. The outputs are ordinary tensors
    (the bodies run under ``no_grad``)."""
    return _run(_MEMBER_CACHE, sig, (), args, generators, make_body)


def _inference_caches():
    return (_MEAN_CACHE, _SAMPLE_CACHE, _PRIOR_CACHE, _PROGRAM_CACHE)


def held_bytes() -> int:
    """Device bytes the caches hold: the segments of the shared pools
    (their graphs' outputs and the memory they reuse), each member-chunk
    graph's own pool (measured at its capture) and every static input
    buffer."""
    with _LOCK:
        pools = {tuple(pool) for _, pool in _DEVICES.values()}
        segments = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                       if tuple(s["segment_pool_id"]) in pools) if pools else 0
        static = sum(_static_bytes(entry) for cache in _inference_caches()
                     for entry in cache.entries())
        return segments + static + _MEMBER_CACHE.nbytes()


def entries() -> int:
    """The number of graphs the caches hold."""
    with _LOCK:
        return sum(len(cache)
                   for cache in (*_inference_caches(), _MEMBER_CACHE))
