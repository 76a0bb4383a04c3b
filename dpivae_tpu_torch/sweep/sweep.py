"""Member-batched sweep training (counterpart of dpivae_tpu/sweep/sweep.py).

``train_sweep`` turns N independent trainings (the reference's serial
loops over λ and seeds) into batched trainings of ``chunk_size`` members
at a time:

- each member has its own ``torch.Generator``, seeded from the sweep seed
  and the member's id (``train.train.member_generators``): it draws the
  member's datasets, its init and every step's batch rows and noise, so a
  member's result depends neither on the chunk size nor on its chunk's
  other members;
- λ (the GRL strength) and, in ``train_hyper_sweep``, any of
  ``TRACEABLE_HYPER_FIELDS`` are per-member values;
- members stack on a leading axis; ``train.train.MemberTrainer`` runs the
  single-member model code under ``torch.func.vmap`` and the fused-MLP
  kernels launch once per call for all members; the decode's options
  (``remat_decode``, through ``ops.remat.recompute``, and
  ``compute_dtype="bfloat16"``) run member-batched too.

A member's identity (``SweepResult.keys``) is its (seed, id) pair: the
JAX package's per-member PRNG key. Chunks persist under ``checkpoint_dir``
named by a digest of the sweep's identity, as in the JAX package
(``_sweep_manifest``), so a rerun resumes completed chunks and never
another sweep's. While ``utils.spans`` records, a sweep is one ``job``
span and each chunk a ``sweep.chunk`` span, with ``sweep.member_starts``
(the members' generators, data and initial weights) and the chunk's
training under it; ``train_sweep_data``'s copy of the given datasets to
host arrays is a ``sweep.member_data`` span.

With a ``mesh`` (``parallel.make_mesh``) the members are split over its
``member_axis`` ("sweep"), as in the JAX package: the trainers pad them
to a multiple of the axis size by repeating the last member (the pads
train and are dropped; ``train_sweep_data`` instead requires that the
count divides), rank r trains its contiguous slice, and the params and
logs are gathered over the axis and returned on every rank. A member's
generator depends on its id and not on its rank, so a sharded sweep
trains exactly the members of the unsharded one. A mesh that also has a
"dp" axis of size above 1 makes each member's steps data-parallel over
it (``train.train.MemberTrainer``). On CUDA every chunk's training
replays one CUDA graph per validation block (``cuda_graph="auto"``,
``train.train.build_member_train_fn``), with a mesh too: the block graph
holds the "dp" axis's all-reduces. The evaluators split their members
the same way and gather their outputs. A sharded sweep has no chunk
files or chunk callback: ``checkpoint_dir`` and ``chunk_callback`` are
refused with a mesh, as in the JAX package.

The evaluators (``sweep_sample``, ``sweep_predict_y``,
``sweep_disentanglement_latents``) run their members in chunks padded to
one shape, each chunk under ``torch.func.vmap``; on CUDA each chunk
replays one CUDA graph (``cuda_graph="auto"``), cached by signature in
``utils/graph_cache.py``'s member-chunk LRU, bounded by bytes: the
counterpart of the JAX package's ``jit(vmap(...))`` in its
``_SWEEP_JIT_CACHE``. The JAX package's ``_aot`` and
``warm_disentanglement_latents`` only warm compiled programs, and have no
counterpart. Neither have ``member_step_cost``,
``_warn_if_over_budget`` and ``_warn_if_dir_large``: they size chunks
and warn against a TPU transport's per-program deadline, which a card
does not have (``auto_chunk_size`` sizes chunks by free memory).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import sys
import time
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from dpivae_tpu_torch.cases import Case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.eval.evaluate import build_eval_sample_fn
from dpivae_tpu_torch.models.decoders import DECODER_X_HIDDEN
from dpivae_tpu_torch.parallel.mesh import Mesh, all_gather_rows
from dpivae_tpu_torch.train.checkpoint import save_model
from dpivae_tpu_torch.train.graph import resolve_cuda_graph
from dpivae_tpu_torch.train.setup import make_template_model, setup_model
from dpivae_tpu_torch.train.train import (
    TRACEABLE_HYPER_FIELDS,
    TrainLogs,
    build_member_train_fn,
    encoder_noise,
    member_config,
    member_generators,
    stack_params,
)
from dpivae_tpu_torch.utils import (
    DeviceLike,
    graph_cache,
    randn,
    resolve_device,
    spans,
)
from dpivae_tpu_torch.utils.data import sample_response

# Members per batched latent-extraction (and prediction) call, shared by
# sweep_disentanglement_latents and the study script, as in the JAX
# package.
LATENTS_CHUNK_DEFAULT = 22


def _sweep_device(mesh: Optional[Mesh], device: DeviceLike) -> torch.device:
    """``device`` resolved (None means CUDA); with a mesh, the mesh's
    device, which must be of the same type."""
    device = resolve_device(device)
    if mesh is None:
        return device
    if mesh.device.type != device.type:
        raise ValueError(f"the mesh is on {mesh.device}, the sweep on "
                         f"{device}")
    return mesh.device


def _refuse_chunk_io(mesh, checkpoint_dir, chunk_callback) -> None:
    if mesh is None:
        return
    if chunk_callback is not None:
        raise ValueError(
            "chunk_callback requires the chunked (non-mesh) path — the "
            "mesh path trains each rank's members and gathers them, with "
            "no chunk stream")
    if checkpoint_dir is not None:
        raise ValueError(
            "checkpoint_dir (and gc_stale_chunks) require the chunked "
            "(non-mesh) path — the mesh path has no chunk files to save, "
            "resume, or GC")


def _member_share(mesh: Mesh, member_axis: str, n_members: int):
    """(this rank's slice of the members padded to a multiple of the
    axis size, the padded count)."""
    size = mesh.shape[member_axis]
    n_padded = n_members + (-n_members) % size
    return mesh.rows(member_axis, n_padded), n_padded


def _pad_members(a, n_padded: int):
    """``a`` with its last member repeated up to ``n_padded`` members."""
    n_pad = n_padded - a.shape[0]
    if not n_pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a[-1:].expand(n_pad, *a.shape[1:])])
    return np.concatenate([a, np.repeat(a[-1:], n_pad, axis=0)])


def _gather_members(mesh: Mesh, member_axis: str, a: torch.Tensor,
                     n_members: int) -> torch.Tensor:
    """Every rank's members of ``a`` joined in rank order, the pads
    dropped."""
    return all_gather_rows(a, mesh.groups[member_axis],
                           mesh.shape[member_axis])[:n_members]


def _sharded_members(config, case, mesh, member_axis, lam, keys, device,
                     chunk_size, hyper=None, data=None, cuda_graph="auto"):
    """The members of a sharded sweep: this rank's slice (padded, or exact
    for ``data``) trained in chunks of ``chunk_size``, then every rank's
    gathered. With a "dp" axis of size above 1 each member's steps are
    data-parallel over it, in the block graph ``cuda_graph`` resolves to
    as without the axis."""
    n_members = lam.shape[0]
    share, n_padded = _member_share(mesh, member_axis, n_members)
    pick = lambda a: _pad_members(a, n_padded)[share]
    local_n = share.stop - share.start
    dp = mesh if mesh.shape.get("dp", 1) > 1 else None
    local = _chunked_execute(
        _run_members(config, case, pick(lam), pick(keys), device,
                     hyper={f: pick(v) for f, v in hyper.items()}
                     if hyper else None,
                     data=None if data is None
                     else tuple(tuple(pick(a) for a in d) for d in data),
                     mesh=dp, cuda_graph=cuda_graph),
        local_n, _chunk(chunk_size, local_n, config, case, device),
        label="sweep")
    gather = lambda a: _gather_members(mesh, member_axis, a, n_members)
    params = {k: gather(v) for k, v in local[0].items()}
    return params, TrainLogs(*(gather(a) for a in local[1]))


class SweepResult(NamedTuple):
    """Stacked results; leading axis = sweep member.

    params: state dict of (M, ...) tensors; logs: ``TrainLogs`` with a
    leading member axis; lambdas: (M,) float32; keys: (M, 2) int64, each
    member's (seed, id), which seed its generator; device: the device the
    members trained on, whose generators replay their draws.
    """

    params: dict
    logs: TrainLogs
    lambdas: np.ndarray
    keys: np.ndarray
    device: str

    @property
    def n_members(self) -> int:
        return int(self.lambdas.shape[0])

    def member_params(self, i: int) -> dict:
        """Member ``i``'s params as a ``DPIVAEParams`` state dict."""
        return {k: v[i] for k, v in self.params.items()}

    def member_logs(self, i: int) -> TrainLogs:
        return TrainLogs(*(a[i] for a in self.logs))

    def host(self) -> "SweepResult":
        """Every tensor copied to the CPU, one transfer per tensor, for
        per-member host work (CSV writes, row loops)."""
        cpu = lambda a: a.cpu() if isinstance(a, torch.Tensor) else a
        return self._replace(
            params={k: cpu(v) for k, v in self.params.items()},
            logs=TrainLogs(*(cpu(a) for a in self.logs)))


class HyperSweepResult(NamedTuple):
    """Stacked hyperparameter-sweep results; leading axis = member.

    ``grid`` maps each swept config field to its (M,) values."""

    params: dict
    logs: TrainLogs
    grid: dict
    lambdas: np.ndarray
    keys: np.ndarray
    device: str

    n_members = SweepResult.n_members
    member_params = SweepResult.member_params
    member_logs = SweepResult.member_logs
    host = SweepResult.host

    def member_overrides(self, i: int) -> dict:
        return {k: float(v[i]) for k, v in self.grid.items()}


def _keys(seed: int, ids) -> np.ndarray:
    ids = np.asarray(ids, np.int64).reshape(-1)
    return np.stack([np.full_like(ids, int(seed)), ids], axis=1)


def _generators(keys: np.ndarray, device) -> list:
    return [member_generators(int(s), [int(i)], device)[0] for s, i in keys]


def member_datasets(config: TrainConfig, case: Case, member_key,
                    device: DeviceLike = None, generator=None):
    """Replay a sweep member's (train, val) datasets from its key, the
    (seed, id) pair in ``SweepResult.keys``, on ``device`` (the device it
    trained on: generators differ between devices). With ``generator``
    (the member's, fresh) the draws come from it, which leaves it where
    the member's init starts."""
    if generator is None:
        seed, i = (int(v) for v in np.asarray(member_key).reshape(2))
        generator = member_generators(seed, [i], device)[0]
    device = generator.device
    gt = case.gt_dist()
    data_train = sample_response(case, generator, config.n_train,
                                 sample_dist=gt, device=device)
    data_val = sample_response(case, generator, config.n_val,
                               sample_dist=gt, device=device)
    return data_train, data_val


def _member_start(config, case, template, generator, data=None):
    """A member's (data_train, data_val, params) from its generator: the
    datasets (unless given), then the init, as ``build_member_fn`` splits
    its key; the generator is left at the member's training draws."""
    if data is None:
        data = member_datasets(config, case, None, generator=generator)
    params = template.init(generator, device=generator.device)
    return data[0], data[1], params


def member_model(config: TrainConfig, case: Case, result, i: int,
                 data_train=None):
    """(model, params) of sweep member ``i``: the model with its input
    scalers fitted on the member's training data (replayed from its key on
    ``result.device``, or ``data_train`` for a data sweep) and a
    ``DPIVAEParams`` holding its params, on ``result.device``."""
    config = member_config(config)
    device = torch.device(result.device)
    if data_train is None:
        data_train, _ = member_datasets(config, case, result.keys[i], device)
    model = setup_model(config, case, data_train, device=device)
    params = model.init(torch.Generator(), device=device)
    params.load_state_dict(result.member_params(i))
    return model, params


def export_member(config: TrainConfig, case: Case, result, i: int,
                  path: str, data_train=None):
    """Save sweep member ``i`` as a servable checkpoint
    (``train.checkpoint.save_model``) with its λ and index in the meta
    sidecar; restore it with ``load_model(path, case)``. Returns the
    (model, params) saved."""
    model, params = member_model(config, case, result, i, data_train)
    save_model(path, model, params, member_config(config), case=case,
               extra_meta={"sweep_member": int(i),
                           "lambda": float(result.lambdas[i])})
    return model, params


def export_member_predictor(config: TrainConfig, case: Case, result, i: int,
                            path: str, data_train=None, **export_kwargs):
    """Export sweep member ``i`` as a serving artifact
    (``serving.save_predictor``): its predict path with its weights and
    its scalers (fitted on its training data, replayed from its key or
    ``data_train`` for a data sweep) baked in, loadable with no sweep,
    model or case code. The member's λ replaces ``lambda_g0`` in the
    sidecar's config (the GRL is the identity in the forward pass, so
    predictions do not depend on it: this is provenance). Extra keyword
    arguments (``outputs=``, ``cond=``, ``n=``) pass through to
    ``save_predictor``. Returns the artifact path."""
    from dpivae_tpu_torch.serving import save_predictor

    model, params = member_model(config, case, result, i, data_train)
    cfg_i = member_config(config).replace(
        lambda_g0=float(result.lambdas[i]))
    return save_predictor(path, model, params, cfg_i, case, **export_kwargs)


# ----------------------------------------------------------------------
# Chunk sizes
# ----------------------------------------------------------------------

# Share of the free device memory one chunk may plan for.
_MEMORY_SHARE = 0.5


def member_bytes(config: TrainConfig, case: Case) -> int:
    """Bytes one member needs at its peak, reckoned from the shapes: the
    validation pass (n_val x n_mc_val rows, no autograd graph) and the
    training step (n_batch x n_mc_train rows, its activations kept for the
    backward, counted three times), both live at once (both are in the
    block's CUDA graph, whose memory pool holds them), each row holding
    the decoder outputs and hidden layers and the latents; plus params,
    gradients, both Adam moments and two saved states for the early
    stop."""
    hidden = int(config.hidden_width or DECODER_X_HIDDEN)
    nz = case.nz_x + config.nz_c + config.nz_y
    per_row = 4 * (4 * case.nd_x + 3 * hidden + 8 * nz + case.nd_c
                   + case.nd_y + 16)
    val = config.n_val * config.n_mc_val * per_row
    train = 3 * config.n_batch * config.n_mc_train * per_row
    data = 4 * (config.n_train + config.n_val) * (
        case.nd_x + case.nd_c + case.nd_y)
    n_params = 100_000 + 4 * hidden * (case.nd_x + nz + hidden)
    return int(val + train + data + 4 * 10 * n_params)


def _free_bytes(device: torch.device) -> int:
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def auto_chunk_size(n_members: int, config: TrainConfig, case: Case,
                    device: DeviceLike = None) -> int:
    """Members per batched training: as many as half the device's free
    memory holds at ``member_bytes`` each, at most all of them. One chunk
    is the fastest: a step's host cost is nearly the same for any member
    count, so fewer chunks means fewer steps. (The JAX package's rule is
    calibrated to a TPU transport deadline that does not exist here.)"""
    if n_members <= 0:
        return 1
    device = resolve_device(device)
    fits = int(_MEMORY_SHARE * _free_bytes(device)
               // member_bytes(config, case))
    return max(1, min(n_members, fits))


# ----------------------------------------------------------------------
# Checkpointed, chunked execution
# ----------------------------------------------------------------------

_DIGEST_CHUNK_RE = re.compile(r"^chunk_([0-9a-f]{12})_\d{6}\.npz$")


def _progress(msg: str) -> None:
    """One narrator line on stderr (stdout stays for results)."""
    print(msg, file=sys.stderr, flush=True)


def _sweep_manifest(config: TrainConfig, case: Case, arrays, n_members: int,
                    chunk_size: int, flavor="") -> dict:
    """Identity of a checkpointed sweep: everything that determines its
    members' results. It covers the resolved config (so ``use_pallas``
    resolved, never "auto"), the case, the member-identity columns
    (keys, λs, hyper columns, datasets), the chunk size and ``flavor``
    (the sweep kind and swept field names). The digest prefixes every
    chunk filename, so a sweep can only resume chunks an identical sweep
    wrote."""
    h = hashlib.sha256()
    h.update(repr(flavor).encode())
    h.update(member_config(config).to_json().encode())
    h.update(case.name.encode())
    h.update(case.fingerprint().encode())
    h.update(f"chunk_size={int(chunk_size)}".encode())
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a)[:n_members])
        h.update(str((a.shape, a.dtype.str)).encode())
        h.update(a.tobytes())
    return {"digest": h.hexdigest(), "n_members": int(n_members)}


def _read_manifest(checkpoint_dir: str) -> dict:
    try:
        with open(os.path.join(checkpoint_dir, "manifest.json")) as f:
            data = json.load(f)
        if isinstance(data, dict):
            return data
    except (OSError, ValueError):
        pass
    return {}


def _manifest_history(prev: dict) -> dict:
    """Digest registry {digest12: {"ts", "n_members"}} of a manifest."""
    history = prev.get("history")
    history = dict(history) if isinstance(history, dict) else {}
    old = prev.get("digest")
    if isinstance(old, str) and len(old) >= 12 and old[:12] not in history:
        history[old[:12]] = {"ts": None, "n_members": prev.get("n_members")}
    return history


def clean_checkpoint_dir(checkpoint_dir: str, keep=None):
    """Delete stale sweep chunk checkpoints from a shared dir: chunk files
    whose digest is not in ``keep`` (default: every digest the dir's
    manifest registry records). Other files are never touched. The
    registry is pruned to match. Returns the deleted filenames."""
    if not os.path.isdir(checkpoint_dir):
        return []
    prev = _read_manifest(checkpoint_dir)
    history = _manifest_history(prev)
    kept = set(history) if keep is None else {str(k)[:12] for k in keep}
    deleted = []
    for f in sorted(os.listdir(checkpoint_dir)):
        m = _DIGEST_CHUNK_RE.match(f)
        if m is None or m.group(1) in kept:
            continue
        os.remove(os.path.join(checkpoint_dir, f))
        deleted.append(f)
    pruned = {d: meta for d, meta in history.items() if d in kept}
    if prev or pruned:
        prev["history"] = pruned
        top = prev.get("digest")
        if isinstance(top, str) and top[:12] not in kept:
            prev.pop("digest", None)
        with open(os.path.join(checkpoint_dir, "manifest.json"), "w") as f:
            json.dump(prev, f)
    if deleted:
        _progress(f"[sweep] checkpoint GC removed {len(deleted)} stale "
                  f"chunk file(s) from {checkpoint_dir}")
    return deleted


def _write_sweep_manifest(checkpoint_dir: str, manifest: dict) -> str:
    """Record this sweep in manifest.json (latest identity plus the
    ``history`` registry) and return the digest prefix of its chunk
    filenames, ``chunk_<digest12>_<start>.npz``."""
    digest12 = manifest["digest"][:12]
    foreign = [f for f in os.listdir(checkpoint_dir)
               if f.startswith("chunk_") and f.endswith(".npz")
               and not f.startswith(f"chunk_{digest12}_")]
    if foreign:
        _progress(f"[sweep] checkpoint dir holds {len(foreign)} chunk "
                  "file(s) of other sweep identities: ignored, not resumed")
    history = _manifest_history(_read_manifest(checkpoint_dir))
    history[digest12] = {"ts": time.time(),
                         "n_members": manifest["n_members"]}
    with open(os.path.join(checkpoint_dir, "manifest.json"), "w") as f:
        json.dump({**manifest, "history": history}, f)
    return digest12


def _save_chunk(path: str, params: dict, logs: TrainLogs) -> None:
    """Persist one chunk's (params, logs), CPU tensors, as npz."""
    payload = {f"p:{k}": v.numpy() for k, v in params.items()}
    payload.update({f"log:{name}": getattr(logs, name).numpy()
                    for name in TrainLogs._fields})
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _load_chunk(path: str, expect_members: int):
    """A saved chunk as CPU tensors, or None if it does not hold
    ``expect_members`` members."""
    with np.load(path) as data:
        params = {k[2:]: torch.from_numpy(data[k]) for k in data.files
                  if k.startswith("p:")}
        logs = TrainLogs(*(torch.from_numpy(data[f"log:{name}"])
                           for name in TrainLogs._fields))
    if logs.train.shape[0] != expect_members:
        return None
    return params, logs


def _chunked_execute(run_chunk: Callable, n_members: int, chunk_size: int,
                     checkpoint_dir: Optional[str] = None,
                     chunk_callback=None, manifest: Optional[dict] = None,
                     label: str = "sweep", gc_stale_chunks: bool = False):
    """Run ``run_chunk(slice) -> (params, logs)`` over the members in
    chunks of ``chunk_size`` and concatenate the results on the member
    axis (counterpart of the JAX package's ``_chunked_execute``).

    With ``checkpoint_dir`` every completed chunk persists as npz named by
    the ``manifest`` digest and its start, and a rerun resumes it (trains
    nothing for it). With ``chunk_callback(start, params_chunk,
    logs_chunk)`` each completed chunk, fresh or resumed, reaches the
    caller as CPU tensors. Chunks stay on their device unless one of the
    two needs them on the host."""
    if gc_stale_chunks and checkpoint_dir is None:
        raise ValueError("gc_stale_chunks requires checkpoint_dir")
    hosted = checkpoint_dir is not None or chunk_callback is not None
    digest12 = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        digest12 = _write_sweep_manifest(checkpoint_dir, manifest)
        if gc_stale_chunks:
            clean_checkpoint_dir(checkpoint_dir)
    starts = range(0, n_members, chunk_size)
    chunks, t0 = [], time.perf_counter()
    for i, start in enumerate(starts):
        with spans.span("sweep.chunk"):
            sl = slice(start, min(start + chunk_size, n_members))
            n_in = sl.stop - sl.start
            path = (None if checkpoint_dir is None
                    else os.path.join(checkpoint_dir,
                                      f"chunk_{digest12}_{start:06d}.npz"))
            out = None
            if path is not None and os.path.exists(path):
                out = _load_chunk(path, n_in)
                if out is None:
                    _progress(f"{label} checkpoint {path} holds another "
                              "member count; recomputing this chunk")
                elif len(starts) > 1:
                    _progress(f"[{label}] chunk {i + 1}/{len(starts)} "
                              "resumed from checkpoint")
            if out is None:
                params, logs = run_chunk(sl)
                if hosted:
                    params = {k: v.cpu() for k, v in params.items()}
                    logs = TrainLogs(*(a.cpu() for a in logs))
                    if path is not None:
                        _save_chunk(path, params, logs)
                out = (params, logs)
                if len(starts) > 1:
                    _progress(f"[{label}] chunk {i + 1}/{len(starts)} done "
                              f"({sl.stop}/{n_members} members, "
                              f"{time.perf_counter() - t0:.1f}s)")
            if chunk_callback is not None:
                chunk_callback(start, *out)
            chunks.append(out)
    params = {k: torch.cat([c[0][k] for c in chunks])
              for k in chunks[0][0]}
    logs = TrainLogs(*(torch.cat([c[1][j] for c in chunks])
                       for j in range(len(TrainLogs._fields))))
    return params, logs


def _run_members(config: TrainConfig, case: Case, lambdas: np.ndarray,
                 keys: np.ndarray, device: torch.device, hyper=None,
                 data=None, mesh: Optional[Mesh] = None, cuda_graph="auto"):
    """The chunk runner: each member of a slice starts from its generator
    (data unless given, init), then all train at once (data-parallel over
    ``mesh``'s "dp" axis when given), each chunk capturing its own CUDA
    graph of a validation block when ``cuda_graph`` resolves so
    (``build_member_train_fn``)."""
    template = make_template_model(config, case, device=device)
    train_fn = build_member_train_fn(config, case, mesh,
                                     cuda_graph=cuda_graph)

    def run(sl):
        with spans.span("sweep.member_starts"):
            gens = _generators(keys[sl], device)
            starts = []
            for j, g in enumerate(gens):
                given = None
                if data is not None:
                    given = tuple(tuple(a[sl.start + j] for a in d[:3])
                                  for d in data)
                starts.append(_member_start(config, case, template, g,
                                            given))
            stack = lambda k: tuple(torch.stack([torch.as_tensor(
                s[k][c], dtype=torch.float32, device=device)
                for s in starts]) for c in range(3))
            params = stack_params([s[2] for s in starts])
            data_train, data_val = stack(0), stack(1)
            lam = torch.as_tensor(lambdas[sl], device=device)
            hyp = ({f: torch.as_tensor(v[sl], device=device)
                    for f, v in hyper.items()} if hyper else None)
        return train_fn(params, gens, data_train, data_val, lam, hyp)

    return run


def _chunk(chunk_size, n_members, config, case, device) -> int:
    if chunk_size == "auto":
        chunk_size = auto_chunk_size(n_members, config, case, device)
    return max(1, min(int(chunk_size or n_members), n_members))


def train_sweep(
    config: TrainConfig,
    case: Case,
    lambdas: Sequence[float],
    n_runs: int = 1,
    seed: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    chunk_size: Union[int, str, None] = "auto",
    checkpoint_dir: Optional[str] = None,
    chunk_callback=None,
    gc_stale_chunks: bool = False,
    device: DeviceLike = None,
    member_axis: str = "sweep",
    cuda_graph="auto",
) -> SweepResult:
    """Train the (λ × run) grid in member-batched chunks on ``device``
    (None means CUDA).

    Args:
        lambdas: GRL strengths; the grid is their cross product with
            ``n_runs`` seeds (the reference study: 11 λ x 6 runs).
        seed: the sweep seed (default ``config.seed``); member m's
            generator is seeded from (seed, m).
        mesh: members split over its ``member_axis`` and gathered (module
            docstring); every rank calls this with the same arguments.
        chunk_size: members per batched training (per rank with a mesh);
            "auto" (``auto_chunk_size``) or None for all at once.
        checkpoint_dir: if set, every completed chunk is saved and a rerun
            of the identical sweep resumes it; chunks of other sweeps
            sharing the dir are never resumed (``_sweep_manifest``).
        chunk_callback: ``callback(member_start, params_chunk,
            logs_chunk)`` with CPU tensors for every completed chunk.
        gc_stale_chunks: with ``checkpoint_dir``, delete chunk files no
            registered sweep owns (``clean_checkpoint_dir``).
        cuda_graph: "auto" (each chunk replays a CUDA graph per
            validation block on CUDA, with a mesh too), False (eager) or
            True (``train.train.build_member_train_fn``).

    Returns:
        SweepResult ordered λ-major (member = i_lambda * n_runs + i_run).
    """
    with spans.job("train_sweep") as job:
        _refuse_chunk_io(mesh, checkpoint_dir, chunk_callback)
        if gc_stale_chunks and checkpoint_dir is None:
            raise ValueError("gc_stale_chunks requires checkpoint_dir")
        device = _sweep_device(mesh, device)
        config = member_config(config)
        seed = config.seed if seed is None else int(seed)
        lam = np.repeat(np.asarray(lambdas, np.float32).reshape(-1), n_runs)
        n_members = lam.shape[0]
        if job is not None:
            job.set(members=n_members, n_iter=config.n_iter)
        keys = _keys(seed, np.arange(n_members))
        if mesh is not None:
            params, logs = _sharded_members(
                config, case, mesh, member_axis, lam, keys, device,
                chunk_size, cuda_graph=cuda_graph)
            return SweepResult(params, logs, lam, keys, str(device))
        chunk_size = _chunk(chunk_size, n_members, config, case, device)
        params, logs = _chunked_execute(
            _run_members(config, case, lam, keys, device,
                         cuda_graph=cuda_graph),
            n_members, chunk_size,
            checkpoint_dir, chunk_callback,
            manifest=(_sweep_manifest(config, case, (keys, lam), n_members,
                                      chunk_size, flavor=("lambda-sweep",
                                                          device.type))
                      if checkpoint_dir is not None else None),
            label="sweep", gc_stale_chunks=gc_stale_chunks)
        return SweepResult(params, logs, lam, keys, str(device))


def train_hyper_sweep(
    config: TrainConfig,
    case: Case,
    grid: dict,
    n_runs: int = 1,
    lambdas=None,
    seed: Optional[int] = None,
    chunk_size: Union[int, str, None] = "auto",
    mesh: Optional[Mesh] = None,
    checkpoint_dir: Optional[str] = None,
    chunk_callback=None,
    gc_stale_chunks: bool = False,
    device: DeviceLike = None,
    member_axis: str = "sweep",
    cuda_graph="auto",
) -> HyperSweepResult:
    """Train a hyperparameter grid in member-batched chunks: any subset of
    ``TRACEABLE_HYPER_FIELDS`` (per-group learning rates and weight
    decays, the clip norm, the β/α loss weights) varies per member.

    Args:
        grid: field name -> per-row values, all of one length (members are
            rows; the cross product is the caller's).
        n_runs: seeds per row (member = i_row * n_runs + i_run). The same
            n_runs member seeds repeat across rows, so each seed's data and
            init are paired across settings.
        lambdas: optional per-row GRL strengths (default
            ``config.lambda_g0``).
        seed, mesh, chunk_size, checkpoint_dir, chunk_callback,
            gc_stale_chunks, device, member_axis, cuda_graph: as in
            ``train_sweep`` (the digest covers the grid).
    """
    with spans.job("train_hyper_sweep") as job:
        _refuse_chunk_io(mesh, checkpoint_dir, chunk_callback)
        if gc_stale_chunks and checkpoint_dir is None:
            raise ValueError("gc_stale_chunks requires checkpoint_dir")
        fields = tuple(sorted(grid))
        if not fields:
            raise ValueError("grid must contain at least one field")
        bad = set(fields) - TRACEABLE_HYPER_FIELDS
        if bad:
            raise ValueError(f"{sorted(bad)} cannot be swept per member; "
                             f"allowed: {sorted(TRACEABLE_HYPER_FIELDS)}")
        cols = [np.asarray(grid[f], np.float32).reshape(-1) for f in fields]
        n_rows = cols[0].shape[0]
        for f, c in zip(fields, cols):
            if c.shape[0] != n_rows:
                raise ValueError(f"grid column {f!r} has {c.shape[0]} values, "
                                 f"expected {n_rows}")
        if lambdas is None:
            lam_rows = np.full(n_rows, config.lambda_g0, np.float32)
        else:
            lam_rows = np.asarray(lambdas, np.float32).reshape(-1)
            if lam_rows.shape[0] != n_rows:
                raise ValueError("lambdas must match the grid length")
        rep = lambda a: np.repeat(a, n_runs, axis=0)
        grid_out = {f: rep(c) for f, c in zip(fields, cols)}
        lam = rep(lam_rows)
        n_members = n_rows * n_runs
        if job is not None:
            job.set(members=n_members, n_iter=config.n_iter)
        device = _sweep_device(mesh, device)
        config = member_config(config)
        seed = config.seed if seed is None else int(seed)
        keys = _keys(seed, np.tile(np.arange(n_runs), n_rows))
        if mesh is not None:
            params, logs = _sharded_members(
                config, case, mesh, member_axis, lam, keys, device,
                chunk_size, hyper=grid_out, cuda_graph=cuda_graph)
            return HyperSweepResult(params, logs, grid_out, lam, keys,
                                    str(device))
        chunk_size = _chunk(chunk_size, n_members, config, case, device)
        params, logs = _chunked_execute(
            _run_members(config, case, lam, keys, device, hyper=grid_out,
                         cuda_graph=cuda_graph),
            n_members, chunk_size, checkpoint_dir, chunk_callback,
            manifest=(_sweep_manifest(
                config, case, (keys, lam, *grid_out.values()), n_members,
                chunk_size, flavor=("hyper-sweep", fields, device.type))
                if checkpoint_dir is not None else None),
            label="hyper-sweep", gc_stale_chunks=gc_stale_chunks)
        return HyperSweepResult(params, logs, grid_out, lam, keys, str(device))


def train_sweep_data(
    config: TrainConfig,
    case: Case,
    lambdas,
    data_train,
    data_val,
    seed: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    chunk_size: Union[int, str, None] = "auto",
    checkpoint_dir: Optional[str] = None,
    chunk_callback=None,
    gc_stale_chunks: bool = False,
    device: DeviceLike = None,
    member_axis: str = "sweep",
    cuda_graph="auto",
) -> SweepResult:
    """Sweep over given per-member datasets: ``data_train``/``data_val``
    are (x, c, y) whose arrays carry a leading member axis (e.g. the
    domain-transfer grid of the regression study). Each member's
    generator, from (seed, m), draws its init and training noise;
    chunking, checkpoints, ``mesh`` and ``cuda_graph`` as in
    ``train_sweep`` (the digest covers the datasets), except that with a
    mesh the member count must divide by the ``member_axis`` size."""
    with spans.job("train_sweep_data") as job:
        _refuse_chunk_io(mesh, checkpoint_dir, chunk_callback)
        if gc_stale_chunks and checkpoint_dir is None:
            raise ValueError("gc_stale_chunks requires checkpoint_dir")
        lam = np.asarray(lambdas, np.float32).reshape(-1)
        n_members = lam.shape[0]
        if job is not None:
            job.set(members=n_members, n_iter=config.n_iter)
        as_np = lambda a: (a.detach().cpu().numpy()
                           if isinstance(a, torch.Tensor)
                           else np.asarray(a, np.float32))
        with spans.span("sweep.member_data") as sp:
            data_train = tuple(as_np(a) for a in data_train[:3])
            data_val = tuple(as_np(a) for a in data_val[:3])
            nbytes = sum(a.nbytes for a in (*data_train, *data_val))
            if sp is not None:
                sp.set(bytes=nbytes, members=n_members)
            spans.count("sweep.member_data_bytes", nbytes)
        for a in (*data_train, *data_val):
            if a.shape[0] != n_members:
                raise ValueError("data member axis must match len(lambdas)")
        device = _sweep_device(mesh, device)
        config = member_config(config)
        seed = config.seed if seed is None else int(seed)
        keys = _keys(seed, np.arange(n_members))
        if mesh is not None:
            if n_members % mesh.shape[member_axis]:
                raise ValueError("pad members to a multiple of the mesh axis "
                                 "for train_sweep_data")
            params, logs = _sharded_members(
                config, case, mesh, member_axis, lam, keys, device,
                chunk_size, data=(data_train, data_val),
                cuda_graph=cuda_graph)
            return SweepResult(params, logs, lam, keys, str(device))
        chunk_size = _chunk(chunk_size, n_members, config, case, device)
        params, logs = _chunked_execute(
            _run_members(config, case, lam, keys, device,
                         data=(data_train, data_val), cuda_graph=cuda_graph),
            n_members, chunk_size, checkpoint_dir, chunk_callback,
            manifest=(_sweep_manifest(
                config, case, (keys, lam, *data_train, *data_val), n_members,
                chunk_size, flavor=("data-sweep", device.type))
                if checkpoint_dir is not None else None),
            label="data-sweep", gc_stale_chunks=gc_stale_chunks)
        return SweepResult(params, logs, lam, keys, str(device))


# ----------------------------------------------------------------------
# Batched evaluation of a sweep's members
# ----------------------------------------------------------------------

def _observation_noise(template, generator, n: int, batch: int, cond: bool,
                       slots, device) -> dict:
    """One member's standard normals for ``DPIVAE.sample`` of ``slots``:
    the encoder's, the conditional prior's with ``cond``, and the
    observation noise only of the slots that read it, in the order
    ``sample`` draws them."""
    noise = {"z": encoder_noise(template, generator, n, batch, device)}
    if cond:
        noise["z_prior"] = randn((n, batch, template.nz_c), generator, device)
    for slot, name, width in ((0, "x", template.nd_x),
                              (3, "c", template.nd_c),
                              (4, "y", template.nd_y)):
        if slot in slots:
            noise[name] = randn((n, batch, width), generator, device)
    return noise


def _stack_noise(noises) -> dict:
    return {k: torch.stack([d[k] for d in noises]) for k in noises[0]}


def _member_chunks(n_members: int, chunk_size: Optional[int]):
    """(members per chunk, the member count padded to whole chunks): as
    few chunks as ``chunk_size`` (at most; default
    ``LATENTS_CHUNK_DEFAULT``) allows, all of one size, so that fewer
    members are padded than there are chunks (24 members at most 22 a
    chunk: two of 12, where the JAX package pads the last 2 with 20)."""
    most = max(1, min(chunk_size or LATENTS_CHUNK_DEFAULT, n_members))
    n_chunks = -(-n_members // most)
    size = -(-n_members // n_chunks)
    return size, size * n_chunks


def _copy_generator(g: torch.Generator) -> torch.Generator:
    copy = torch.Generator(device=g.device)
    copy.set_state(g.get_state())
    return copy


def _prefixed(inputs: dict, prefix: str) -> dict:
    """The entries of ``inputs`` named ``prefix`` + name, by name."""
    return {k[len(prefix):]: v for k, v in inputs.items()
            if k.startswith(prefix)}


def _params_args(result, ids, device) -> dict:
    """The params of the members ``ids`` as chunk inputs, ``p:<name>``,
    on ``device``."""
    index = torch.as_tensor(np.asarray(ids), device=device)
    return {f"p:{k}": v.to(device)[index]
            for k, v in result.params.items()}


def _run_chunks(sig, args: dict, generators, make_body, n_members: int,
                chunk_size: Optional[int], graphed: bool) -> tuple:
    """``make_body(inputs, generators)()`` over the members in chunks
    (``_member_chunks``), the members padded to whole chunks by repeating
    the last, as the JAX package pads them
    (dpivae_tpu/sweep/sweep.py:1421-1429), in the graphed path and the
    eager one alike: both then compute the same, and one signature serves
    every chunk. ``args`` are tensors with a leading member axis (params,
    data, inputs, noise); ``generators`` a list per member, the generators
    of its slot (empty where the noise is given), the padded slots drawing
    from copies of the last member's, whose advanced states go back to no
    member. Graphed, each chunk is one call of
    ``graph_cache.cached_members`` under ``sig``; else the body runs
    eagerly under ``no_grad``. Returns the outputs of the ``n_members``
    members, the pads' dropped."""
    size, n_padded = _member_chunks(n_members, chunk_size)
    args = {k: _pad_members(v, n_padded).contiguous()
            for k, v in args.items()}
    generators = list(generators) + [
        [_copy_generator(g) for g in generators[-1]]
        for _ in range(n_padded - n_members)]
    outs = []
    for start in range(0, n_padded, size):
        chunk = {k: v[start:start + size] for k, v in args.items()}
        gens = [g for slot in generators[start:start + size] for g in slot]
        if graphed:
            outs.append(graph_cache.cached_members(sig, chunk, gens,
                                                   make_body))
        else:
            with torch.no_grad():
                outs.append(make_body(chunk, gens)())
    return tuple(torch.cat([o[j] for o in outs])[:n_members]
                 for j in range(len(outs[0])))


def _sample_members(config, case, result, data_train, x, c, *, cond, n,
                    slots, seed, noise, chunk_size, cuda_graph, mean=False,
                    ids=None):
    """``DPIVAE.sample`` of ``slots`` for the members ``ids`` (default
    all; stacked, leading member axis), in chunks of members
    (``_run_chunks``) under ``torch.func.vmap`` on the device the members
    trained on: each member's scalers fitted on its ``data_train``, its
    noise from ``noise`` (stacked mappings) or drawn inside the chunk from
    its own generator, seeded from (seed, member). With ``mean`` each
    slot's MC mean is taken inside the chunk. ``cuda_graph`` ("auto",
    True, False) as ``train.graph.resolve_cuda_graph`` resolves it on that
    device: graphed, each chunk replays one CUDA graph. ``data_train``,
    ``x``, ``c`` and ``noise`` hold the members ``ids``."""
    config = member_config(config)
    device = torch.device(result.device)
    graphed = resolve_cuda_graph(cuda_graph, device)
    ids = np.arange(result.n_members) if ids is None else np.asarray(ids)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    args = {**_params_args(result, ids, device),
            **{name: as_t(a) for name, a in zip(
                ("x_train", "c_train", "y_train"), data_train[:3])},
            "x": as_t(x), "c": as_t(c),
            **{f"noise_{k}": as_t(v)
               for k, v in sorted((noise or {}).items())}}
    gens = ([[g] for g in member_generators(seed, ids, device)]
            if noise is None else [[] for _ in ids])
    template = make_template_model(config, case, device=device)
    sample_fn = torch.func.vmap(build_eval_sample_fn(
        config, case, cond, n, slots=slots, device=device))

    def make_body(inputs, gens):
        def body():
            eps = _prefixed(inputs, "noise_") or _stack_noise([
                _observation_noise(template, g, n, inputs["x"].shape[1],
                                   cond, slots, device) for g in gens])
            out = sample_fn(_prefixed(inputs, "p:"),
                            (inputs["x_train"], inputs["c_train"],
                             inputs["y_train"]),
                            inputs["x"], inputs["c"], eps)
            return tuple(torch.mean(o, dim=1) if mean else o for o in out)
        return body

    sig = ("sample", config, case.fingerprint(), bool(cond), int(n),
           tuple(slots), bool(mean))
    return _run_chunks(sig, args, gens, make_body, len(ids), chunk_size,
                       graphed)


def _sharded_sample(config, case, result, data_train, x, c, *, mesh,
                    member_axis, noise, **kwargs):
    """``_sample_members`` of every member, with a mesh each rank's
    contiguous share (the member count must divide by the axis size) and
    the outputs gathered over ``member_axis``, outside any graph."""
    if mesh is None:
        return _sample_members(config, case, result, data_train, x, c,
                               noise=noise, **kwargs)
    n_members = result.n_members
    if n_members % mesh.shape[member_axis]:
        raise ValueError("n_members must be a multiple of the mesh axis")
    share = mesh.rows(member_axis, n_members)
    outs = _sample_members(
        config, case, result, tuple(a[share] for a in data_train[:3]),
        x[share], c[share], ids=np.arange(n_members)[share],
        noise=None if noise is None else {k: v[share]
                                          for k, v in noise.items()},
        **kwargs)
    return tuple(_gather_members(mesh, member_axis, o, n_members)
                 for o in outs)


def sweep_sample(config: TrainConfig, case: Case, result, data_train, x, c,
                 cond: bool = False, n: int = 1, seed: int = 0, noise=None,
                 chunk_size: Optional[int] = None,
                 mesh: Optional[Mesh] = None, member_axis: str = "sweep",
                 cuda_graph="auto"):
    """``model.sample`` of every member: the stacked 9-tuple, each with a
    leading member axis. ``data_train`` (the members' training sets, for
    their scalers), ``x`` and ``c`` carry a leading member axis; noise,
    chunks and ``cuda_graph`` as in ``_sample_members``. With ``mesh`` the
    members (a multiple of the ``member_axis`` size) are split over the
    axis, each rank's chunks graphed, and the outputs gathered on every
    rank."""
    return _sharded_sample(config, case, result, data_train, x, c,
                           mesh=mesh, member_axis=member_axis, noise=noise,
                           cond=cond, n=n, slots=tuple(range(9)), seed=seed,
                           chunk_size=chunk_size, cuda_graph=cuda_graph)


def sweep_predict_y(config: TrainConfig, case: Case, result, data_train, x,
                    c, cond: bool = False, n: int = 1, seed: int = 0,
                    noise=None, chunk_size: Optional[int] = None,
                    mesh: Optional[Mesh] = None, member_axis: str = "sweep",
                    cuda_graph="auto"):
    """The posterior-mean ŷ of every member, (M, n_test, nd_y): only the
    y slot is sampled (no decoder_x), its mean over n samples taken inside
    each chunk, so the (members x n x points x nd_y) samples never leave
    it. ``mesh`` and ``cuda_graph`` as in ``sweep_sample``."""
    (y,) = _sharded_sample(config, case, result, data_train, x, c,
                           mesh=mesh, member_axis=member_axis, noise=noise,
                           cond=cond, n=n, slots=(4,), seed=seed,
                           chunk_size=chunk_size, cuda_graph=cuda_graph,
                           mean=True)
    return y


def regressor_datasets(case: Case, generator, n_train_reg: int,
                       n_test_reg: int):
    """The probes' (train, test) datasets of one member, drawn in turn
    from its generator."""
    gt = case.gt_dist()
    return tuple(sample_response(case, generator, n, sample_dist=gt,
                                 device=generator.device)
                 for n in (n_train_reg, n_test_reg))


_LATENT_SPLITS = ("train", "test")


def sweep_disentanglement_latents(
    config: TrainConfig, case: Case, result, n_train_reg: int,
    n_test_reg: int, cond: bool = False, use_mean: bool = False,
    seed: int = 1, chunk_size: Optional[int] = None, noise=None,
    mesh: Optional[Mesh] = None, member_axis: str = "sweep",
    cuda_graph="auto",
):
    """Posterior latents of every member on fresh probe datasets.

    Per member, inside its chunk (as the JAX package's member function,
    dpivae_tpu/sweep/sweep.py:1391-1407): its training data replayed from
    its key's generator (for its scalers, as it trained), probe train/test
    datasets drawn from its own generator, seeded from (seed, member)
    (``regressor_datasets``), and the MC-mean latents (one sample, or
    ``config.n_mc_test`` with ``use_mean``) of both splits, the encoder's
    noise drawn from the same generator after the datasets, or taken from
    ``noise``, a pair of stacked mappings (train, test). Members run in
    chunks of ``chunk_size`` (default ``LATENTS_CHUNK_DEFAULT``; the last
    padded), each chunk one replay of a CUDA graph when ``cuda_graph``
    resolves so ("auto": on CUDA). With ``mesh`` each chunk's members are
    split over ``member_axis`` (``chunk_size`` must divide by its size;
    the members are padded to a multiple of it by repeating the last), and
    the latents are gathered on every rank, outside the graphs.

    Returns a dict of (M, ...) tensors: zx/zc/zy_{train,test} and the
    ground-truth factors z_{train,test}.
    """
    config = member_config(config)
    n = config.n_mc_test if use_mean else 1
    device = torch.device(result.device)
    n_members = result.n_members
    ids = np.arange(n_members)
    if mesh is not None:
        chunk_size = min(chunk_size or LATENTS_CHUNK_DEFAULT, n_members)
        if chunk_size % mesh.shape[member_axis]:
            raise ValueError("chunk_size must be a multiple of the mesh axis")
        share, n_padded = _member_share(mesh, member_axis, n_members)
        ids = _pad_members(ids, n_padded)[share]
        chunk_size //= mesh.shape[member_axis]
        if noise is not None:
            noise = tuple({k: _pad_members(v, n_padded)[share]
                           for k, v in split.items()} for split in noise)
    graphed = resolve_cuda_graph(cuda_graph, device)
    args = _params_args(result, ids, device)
    if noise is not None:
        args.update({f"noise_{split}_{k}": torch.as_tensor(
            v, dtype=torch.float32, device=device)
            for split, mapping in zip(_LATENT_SPLITS, noise)
            for k, v in sorted(mapping.items())})
    gens = [[key_gen, gen] for key_gen, gen in zip(
        _generators(result.keys[ids], device),
        member_generators(seed, ids, device))]
    draw = noise is None
    gt = case.gt_dist()
    template = make_template_model(config, case, device=device)
    sample_fn = torch.func.vmap(build_eval_sample_fn(
        config, case, cond, n, slots=(5, 6, 7), device=device))
    stack = lambda rows, k: torch.stack([r[k] for r in rows])

    def make_body(inputs, gens):
        def body():
            data_train, probes, eps = [], ([], []), ([], [])
            for key_gen, gen in zip(gens[0::2], gens[1::2]):
                data_train.append(sample_response(
                    case, key_gen, config.n_train, sample_dist=gt,
                    device=device)[:3])
                for rows, data in zip(probes, regressor_datasets(
                        case, gen, n_train_reg, n_test_reg)):
                    rows.append(data)
                if draw:
                    for e, rows in zip(eps, probes):
                        e.append(_observation_noise(
                            template, gen, n, rows[-1][0].shape[0], cond,
                            (5, 6, 7), device))
            data_train = tuple(stack(data_train, k) for k in range(3))
            out = []
            for split, rows, e in zip(_LATENT_SPLITS, probes, eps):
                zx, zc, zy = sample_fn(
                    _prefixed(inputs, "p:"), data_train, stack(rows, 0),
                    stack(rows, 1),
                    _stack_noise(e) if draw
                    else _prefixed(inputs, f"noise_{split}_"))
                out += [zx.mean(1), zc.mean(1), zy.mean(1), stack(rows, 3)]
            return tuple(out)
        return body

    sig = ("latents", config, case.fingerprint(), bool(cond), int(n),
           int(n_train_reg), int(n_test_reg))
    outs = _run_chunks(sig, args, gens, make_body, len(ids), chunk_size,
                       graphed)
    out = dict(zip((f"{b}_{split}" for split in _LATENT_SPLITS
                    for b in ("zx", "zc", "zy", "z")), outs))
    if mesh is not None:
        out = {k: _gather_members(mesh, member_axis, v, n_members)
               for k, v in out.items()}
    return out
