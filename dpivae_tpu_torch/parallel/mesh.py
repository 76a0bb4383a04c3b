"""Device meshes over ``torch.distributed`` and the data-parallel train
step (counterpart of dpivae_tpu/parallel/mesh.py).

The JAX package's mesh is single-controller: one process drives every
chip and XLA derives the collectives from sharding annotations. Here the
PyTorch idiom holds instead: one process (rank) per device, NCCL between
CUDA devices and gloo between CPU processes, and the collectives are
written out. A ``Mesh`` lays the ranks of the process group out on named
axes in row-major order and holds one process group per axis: the ranks
that differ only in that axis's coordinate.

Every rank holds the whole host data and draws the same global batch
from a generator seeded the same on every rank, then keeps its own
contiguous rows (``shard_batch``): that is the port's form of JAX's
replicated key and global draw before the sharding, and it is why a run
over N ranks draws what the one-rank run draws.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dpivae_tpu_torch.utils import DeviceLike, resolve_device

LAUNCH_COMMAND = ("python -m torch.distributed.run --standalone "
                  "--nproc_per_node {n} -m {module}")


def launch_command(n: int, module: str = "<module>") -> str:
    """The command that starts ``n`` ranks of ``module``, one per device."""
    return LAUNCH_COMMAND.format(n=int(n), module=module)


def launched_world_size() -> Optional[int]:
    """The world size of this job: the process group's when one is up,
    else the launcher's (``torch.distributed.run`` sets WORLD_SIZE), else
    None (a process started on its own)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if "WORLD_SIZE" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def launch_problem(n_devices: Optional[int], module: str) -> Optional[str]:
    """Why a program asked for ``n_devices`` ranks cannot run in this
    process (None if it can): more than one needs a launched job of that
    many, one per device."""
    if n_devices is not None and n_devices < 1:
        return f"--n_devices must be at least 1, not {n_devices}"
    if (n_devices or 1) > 1 and launched_world_size() != n_devices:
        return (f"--n_devices {n_devices} runs one process per device: "
                f"launch it with `{launch_command(n_devices, module)} "
                f"--n_devices {n_devices} ...`")
    return None


class Mesh:
    """The ranks of the process group on named axes.

    ``shape`` maps each axis name to its size (read ``mesh.shape[axis]``
    as in JAX), ``coords`` this rank's coordinate on each, ``groups`` the
    process group of each axis that holds this rank, and ``device`` this
    rank's device. Ranks are laid out row-major: on a ("sweep", "dp") mesh
    of shape (s, d), rank r sits at (r // d, r % d).
    """

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 device: torch.device, owns_group: bool):
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              (int(s) for s in shape)))
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.world_size = dist.get_world_size()
        self._owns_group = owns_group
        ranks = np.arange(self.world_size).reshape(tuple(shape))
        self.coords = {a: int(i) for a, i in zip(
            self.axis_names, np.unravel_index(self.rank, ranks.shape))}
        self.groups, self.members = {}, {}
        for k, axis in enumerate(self.axis_names):
            lines = np.moveaxis(ranks, k, -1).reshape(-1, ranks.shape[k])
            for line in lines:
                line = [int(r) for r in line]
                # Every rank creates every group, in the same order.
                group = (dist.group.WORLD if len(self.axis_names) == 1
                         else dist.new_group(line))
                if self.rank in line:
                    self.groups[axis], self.members[axis] = group, line

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.backend} on {self.device})")

    def rows(self, axis: str, n: int) -> slice:
        """This rank's contiguous share of ``n`` rows split over ``axis``."""
        size = self.shape[axis]
        if n % size:
            raise ValueError(f"{n} rows do not split evenly over the "
                             f"{axis!r} mesh axis ({size})")
        per = n // size
        start = self.coords[axis] * per
        return slice(start, start + per)

    def barrier(self) -> None:
        dist.barrier()

    def close(self) -> None:
        """Destroy the process group if ``make_mesh`` started it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False


def _mesh_device(device: DeviceLike) -> torch.device:
    """None means this rank's CUDA device, cuda:LOCAL_RANK."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        torch.cuda.set_device(device)
    return device


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _mesh_shape(n: int, axes, shape):
    if shape is None:
        shape = (n,) if len(axes) == 1 else None
    if shape is None:
        raise ValueError("shape required for multi-axis meshes")
    if int(np.prod(shape)) != n:
        raise ValueError(f"shape {tuple(shape)} does not cover {n} devices")
    return tuple(int(s) for s in shape)


def _join_group(n: int, device: torch.device) -> bool:
    """Make sure a process group of ``n`` ranks with the device's backend
    is up; returns whether this call started it."""
    backend = _backend(device)
    world = launched_world_size()
    if world is not None and world != n:
        raise ValueError(
            f"a mesh of {n} devices needs a job of {n} ranks, one per "
            f"device; this one has {world}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(
                f"the process group runs {dist.get_backend()}, and a mesh on "
                f"{device.type} needs {backend}")
        return False
    if world is not None:  # launched: the launcher's environment
        dist.init_process_group(backend, init_method="env://")
        return True
    if n != 1:
        raise RuntimeError(
            f"a mesh of {n} devices runs one process per device, and this "
            f"process was started on its own: launch it with "
            f"`{launch_command(n)} ...`")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def make_mesh(n_devices: Optional[int] = None, axes: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None,
              device: DeviceLike = None) -> Mesh:
    """A mesh over the ranks of this job, one device per rank.

    With one axis the mesh is 1-D over ``n_devices`` ranks (default: the
    job's world size, 1 for a process started on its own); pass ``shape``
    to factorize (axes=("sweep", "dp"), shape=(2, 4)). ``device=None``
    means this rank's CUDA device (cuda:LOCAL_RANK, made current) and
    NCCL; ``device="cpu"`` means gloo.

    Where a process group is up (started by ``torch.multiprocessing.spawn``
    workers or an earlier mesh) or the job was launched by
    ``torch.distributed.run``, its world size must be ``n_devices``; a
    launched job's group is started here from the launcher's environment.
    A process started on its own gets a one-rank group over a
    ``HashStore`` for ``n_devices=1`` and an error naming the launch
    command for more.

    The JAX package refuses multiple processes here (its programs take
    whole host arrays, wrong under multi-controller JAX). The port needs
    no such guard: every rank holds the whole host arrays and takes its
    own rows or members itself, which is right across processes.
    """
    device = _mesh_device(device)
    axes = tuple(axes)
    n = (int(np.prod(shape)) if n_devices is None and shape is not None
         else n_devices or launched_world_size() or 1)
    shape = _mesh_shape(int(n), axes, shape)
    owns = _join_group(int(n), device)
    return Mesh(axes, shape, device, owns)


def make_global_mesh(axes: Sequence[str] = ("dp",),
                     shape: Optional[Sequence[int]] = None,
                     device: DeviceLike = None) -> Mesh:
    """``make_mesh`` over every rank of the job, with no ``n_devices``: a
    subset of a job's ranks would strand the others."""
    return make_mesh(None, axes, shape, device)


# ----------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, torch.nn.Module):
        return list(tree.state_dict().values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _coalesced_(tensors, collective) -> None:
    """Run ``collective`` on one flat buffer per dtype of ``tensors`` and
    copy the result back into them, in place. Under a CUDA graph's capture
    (a training block, ``train/graph.py``) the flat buffer is allocated in
    the graph's memory pool, at the same address on every replay, and the
    concatenation, the collective and the copies back are all issued from
    the capturing stream, so the graph records them in order."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            collective(flat)
            offset = 0
            for t in group:
                t.detach().copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce_sum_(tensors, group) -> None:
    """Sum ``tensors`` over ``group``, in place, in one collective per
    dtype. It may be captured into a CUDA graph (``_coalesced_``). In a
    data-parallel training block it sums each step's gradients and log
    components and each validation's components, so every rank reads the
    same all-reduced validation loss: every rank's early stop agrees, and
    every rank ends at the same block. A rank that ended earlier would
    leave the others waiting in their next all-reduce."""
    _coalesced_(tensors, lambda flat: dist.all_reduce(flat, group=group))


def all_gather_rows(tensor: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``size`` ranks' tensors of ``group`` joined on the leading axis,
    in rank order (every rank's has the same shape)."""
    is_bool = tensor.dtype == torch.bool
    local = (tensor.to(torch.uint8) if is_bool else tensor).contiguous()
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local, group=group)
    out = torch.cat(parts)
    return out.bool() if is_bool else out


def feed_process_local(mesh: Mesh, local_rows, axis: str = "dp"):
    """The global tensor from each rank's contiguous ``local_rows`` along
    ``axis``, in rank order: ``torch.cat`` of the ranks' shards, on every
    rank (as the JAX package's equals a ``device_put`` in one process)."""
    local = torch.as_tensor(local_rows, device=mesh.device)
    return all_gather_rows(local, mesh.groups[axis], mesh.shape[axis])


def shard_batch(mesh: Mesh, batch, axis: str = "dp"):
    """This rank's contiguous rows of each tensor's leading axis, for a
    tensor or a tuple, list or dict of them."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, a, axis) for a in batch)
    return batch[mesh.rows(axis, batch.shape[0])]


def replicated(mesh: Mesh, tree, axis: Optional[str] = None):
    """Broadcast every tensor of ``tree`` (a tensor, a module's state, or
    a tuple, list or dict of them) from the first rank of ``axis``'s group
    (of the whole job when ``axis`` is None), in place, so that every
    replica starts equal. Returns ``tree``."""
    group = dist.group.WORLD if axis is None else mesh.groups[axis]
    src = 0 if axis is None else mesh.members[axis][0]
    _coalesced_(_leaves(tree),
                lambda flat: dist.broadcast(flat, src=src, group=group))
    return tree


# ----------------------------------------------------------------------
# The data-parallel train step
# ----------------------------------------------------------------------

def sharded_train_step(config, model, case, mesh: Mesh, dp_axis: str = "dp"):
    """A data-parallel train step over ``mesh``'s ``dp_axis``.

    Returns (step_fn, init_fn, place):
        step_fn(params, opt_state, generator | noise, batch, grl_alpha,
            betas=(1, 1, 1)) -> (params, opt_state, loss): ``batch`` is this
            rank's rows (from ``place``); the encoder normals are the
            global batch's, drawn from ``generator`` or given as
            ``noise={"z": (n_mc_train, n_batch, nz)}``, of which this rank
            keeps its rows. The loss over this rank's rows is divided by
            the global ``n_batch x (nd_x + nd_y + nd_c)``; its gradients
            and value are summed over ``dp_axis`` in one collective, then
            clipped (``clip_gradients``) and applied by the grouped Adam.
            ``loss`` is the global loss.
        init_fn(params) -> opt_state, the grouped Adam over ``params``.
        place(params, batch) -> (params broadcast from the axis's first
            rank, this rank's rows of ``batch``).
    """
    # Imported here: dpivae_tpu_torch.train imports this module.
    from dpivae_tpu_torch.train.optim import (
        clip_grad_global_norm_,
        make_optimizer,
    )
    from dpivae_tpu_torch.train.train import encoder_noise

    denom = config.n_batch * (case.nd_x + case.nd_y + case.nd_c)
    group = mesh.groups[dp_axis]

    def step_fn(params, opt_state, noise, batch, grl_alpha,
                betas=(1.0, 1.0, 1.0)):
        x, c, y = batch[:3]
        n_rows = x.shape[0] * mesh.shape[dp_axis]
        if isinstance(noise, torch.Generator):
            eps = encoder_noise(model, noise, config.n_mc_train, n_rows,
                                x.device)
        else:
            eps = torch.as_tensor(noise["z"], dtype=torch.float32,
                                  device=x.device)
        eps = eps[:, mesh.rows(dp_axis, n_rows)]
        bx, bc, by = betas
        opt_state.zero_grad(set_to_none=True)
        loss, *_ = model.loss(
            params, x, c, y, n=config.n_mc_train, grl_alpha=grl_alpha,
            beta_x=bx, beta_c=bc, beta_y=by, alpha_x=config.alpha_x,
            alpha_c=config.alpha_c, alpha_y=config.alpha_y,
            noise={"z": eps})
        value = torch.sum(loss) / denom
        value.backward()
        total = value.detach().reshape(1).clone()
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        all_reduce_sum_(grads + [total], group)
        if config.clip_gradients:
            clip_grad_global_norm_(params.parameters(), config.max_grad_norm)
        opt_state.step()
        return params, opt_state, total[0]

    def init_fn(params):
        return make_optimizer(config, params)

    def place(params, batch):
        return (replicated(mesh, params, dp_axis),
                shard_batch(mesh, tuple(batch), dp_axis))

    return step_fn, init_fn, place

