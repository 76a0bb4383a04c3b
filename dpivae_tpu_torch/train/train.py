"""Training loop (counterpart of dpivae_tpu/train/train.py:49-113,161-477,
526-596).

The JAX package compiles the whole training into one program, a scan over
validation blocks. Here one block is one program: ``Trainer.block_body``
(and ``MemberTrainer.block_body`` for the members of a sweep) is JAX's
``block`` at the block index held in the device tensor ``block_t``. It
runs the block's first train step, the validation of ``n_val`` points x
``n_mc_val`` samples under ``no_grad`` with the early-stop update on
device tensors (``utils/early_stopping.py``), a device copy of the params
and of Adam's state (JAX's ``mid``), then the other ``val_freq - 1``
steps, each masked by ``step < n_iter`` when ``n_iter`` is not a multiple
of ``val_freq`` (JAX's ``masked_train_step``: one program serves the
partial last block; the schedule index is clamped past ``n_iter``). Then
JAX's ``pick``, with ``torch.where`` over every param and every Adam state
tensor: a stop that latched at this block's validation keeps the state
right after its first step (the reference's ``break``), a stop before the
block keeps the block's entry state. The block writes its train rows and
its validation row in place into the log tensors, NaN where not active,
and keeps the stop block's index in a device tensor, from which the
active masks and the stop iteration are formed at the end.

The loop (``_run_blocks``) runs the first block eagerly and, on CUDA,
captures ``block_body`` once as a CUDA graph and replays it for every
later block (``cuda_graph="auto"``, ``train/graph.py``): one launch per
block. ``cuda_graph=False`` and the CPU run the same body eagerly. The
host reads one bool per block, the all-stopped flag, one block behind:
block b's flag is copied to pinned memory without blocking, and the host
waits for it only after it has launched block b+1. A stop found at block
b therefore ends the loop after block b+1, whose ``pick`` keeps the
stopped state. The lag is fixed, so a run does not depend on timing, and
the generators end in the same state graphed or eager: they have drawn
for every step of the stop block and of the block after it. The params
and logs are those of a loop that breaks at the stop.

``Trainer`` holds one run's state and exposes the single train step, with
a seam for tests: explicit ``batch_idx`` and ``noise`` in place of the
generator (``step_body`` / ``validate_body`` at the index in ``step_t``).
``MemberTrainer`` and ``build_member_train_fn`` train M runs at once (the
sweeps' engine, the counterpart of ``train_fn`` under ``jax.vmap`` with
per-run λ and ``hyper`` inputs), with the same block, the early stop per
member.

With a ``mesh`` (``parallel.make_mesh``) both are data-parallel over its
``dp_axis`` (counterpart of the JAX package's ``mesh=`` branch): every
rank holds the whole data and draws the global batch rows and encoder
normals from a generator in lockstep with the other ranks', keeps its
contiguous rows of the batch and of the validation set, and sums the
gradients and the log components over the axis in one collective per
step, before the clip. Each component is a per-datum sum over a global
divisor, so the sum of the ranks' is the global row, and the early stop
reads the same number on every rank: every rank's flag agrees and every
rank ends at the same block. The block graph is captured with its NCCL
all-reduces (``train/graph.py``), so a mesh replays it too.
``use_pallas="auto"`` resolves on the global training shape, as in the
JAX package.

``train_model(progress=...)`` narrates one line per validation block on
stderr (``make_progress_printer``), reading the block's rows on the host.

While ``utils.spans`` records, a training call is one ``job`` span, with
``train.setup`` (the trainer's construction), one ``train.block`` span per
block of the loop and ``train.flag_wait`` (the host's wait for a flag)
under it; ``train/graph.py`` adds the capture and the replays.

Not ported: scan unrolling and the executable cache.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpivae_tpu_torch.cases import Case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.models.vae import DPIVAEParams, bind_params
from dpivae_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum_,
    replicated,
)
from dpivae_tpu_torch.train.graph import (
    Graphed,
    SideStream,
    resolve_cuda_graph,
)
from dpivae_tpu_torch.train.optim import (
    MemberAdam,
    adam_state_tensors,
    clip_grad_global_norm_,
    make_optimizer,
)
from dpivae_tpu_torch.train.setup import make_template_model, setup_model
from dpivae_tpu_torch.utils import (
    DeviceLike,
    draw_normals,
    rand,
    resolve_device,
    spans,
)
from dpivae_tpu_torch.utils.annealing import make_schedule
from dpivae_tpu_torch.utils.early_stopping import (
    early_stop_init,
    early_stop_update,
)
from dpivae_tpu_torch.utils.transforms import StandardScaler

TRAIN_COLUMNS = (
    "ELBO", "KLx", "KLc", "KLy", "Rx", "Rc", "Ry", "reg",
    "lambda_x", "beta_x", "beta_c", "beta_y", "sigma_x",
)
VAL_COLUMNS = (
    "ELBO_val", "KLx_val", "KLc_val", "KLy_val",
    "Rx_val", "Rc_val", "Ry_val", "reg_val",
)


class TrainLogs(NamedTuple):
    """Metric logs, device tensors.

    train: (n_iter, 13) rows in TRAIN_COLUMNS order.
    val: (n_blocks, 8) rows in VAL_COLUMNS order.
    train_active / val_active: bool masks, False past an early stop; the
    rows they mark False were never run and hold NaN.
    val_iters: the iteration of each validation.
    """

    train: torch.Tensor
    val: torch.Tensor
    train_active: torch.Tensor
    val_active: torch.Tensor
    val_iters: torch.Tensor

    def scalars(self, name: str):
        """(iters, values) of a named series, active rows only, as numpy."""
        if name in TRAIN_COLUMNS:
            mask = self.train_active.cpu().numpy()
            vals = self.train[:, TRAIN_COLUMNS.index(name)].cpu().numpy()
            iters = np.arange(self.train.shape[0])
        elif name in VAL_COLUMNS:
            mask = self.val_active.cpu().numpy()
            vals = self.val[:, VAL_COLUMNS.index(name)].cpu().numpy()
            iters = self.val_iters.cpu().numpy()
        else:
            raise KeyError(name)
        return iters[mask], vals[mask]

    @property
    def stop_iter(self) -> int:
        """Last active training iteration + 1 (n_iter if never stopped)."""
        return int(self.train_active.sum())


def _sample_batch(generator: torch.Generator, n_train: int, n_batch: int,
                  device: torch.device) -> torch.Tensor:
    """Indices of a uniform batch without replacement: the top n_batch of
    n_train iid uniforms, drawn from ``generator``."""
    return torch.topk(rand((n_train,), generator, device), n_batch).indices


def make_progress_printer(n_iter: int, val_freq: int):
    """The narration callback (counterpart of
    dpivae_tpu/train/train.py:135-158): ``cb(it, row, val_row, counter,
    active)`` prints the block's first train row (TRAIN_COLUMNS order),
    its validation row (VAL_COLUMNS order) and the early-stop counter as
    one line on stderr, ending it only at the last block; nothing when not
    ``active``."""

    def cb(it, row, val_row, counter, active):
        if not bool(active):
            return
        it = int(it)
        f = lambda v: f"{float(v):.4g}"
        line = (
            f"iter {it}/{n_iter} "
            f"ELBO_loss={f(row[0])} ELBO_val={f(val_row[0])} "
            f"KL_x={f(row[1])} Rx={f(row[4])} Rc={f(row[5])} Ry={f(row[6])} "
            f"Rx_val={f(val_row[4])} Rc_val={f(val_row[5])} "
            f"Ry_val={f(val_row[6])} reg={f(row[7])} "
            f"lambda_x_i={f(row[8])} beta_x={f(row[9])} beta_c={f(row[10])} "
            f"beta_y={f(row[11])} sigma_x={f(row[12])} counter={int(counter)}"
        )
        last = it + val_freq >= n_iter
        print("\r" + line, end="\n" if last else "", file=sys.stderr,
              flush=True)

    return cb


def resolve_progress(progress, config: TrainConfig, device: torch.device,
                     mesh: Optional[Mesh]):
    """``train_model``'s ``progress`` as the JAX package resolves it
    (dpivae_tpu/train/train.py:552-558): "auto" narrates only on the CPU,
    at ``n_iter`` >= 5000 and without a mesh; anything else is kept."""
    if progress == "auto":
        return (mesh is None and device.type == "cpu"
                and config.n_iter >= 5000)
    return progress


class _DataShard(NamedTuple):
    """This rank's share of a data-parallel step: the process group of the
    dp axis and its rows of the global batch and of the validation set."""

    group: object
    train: slice
    val: slice


def _data_shard(config: TrainConfig, mesh: Optional[Mesh],
                dp_axis: str) -> Optional[_DataShard]:
    if mesh is None:
        return None
    n_dp = mesh.shape[dp_axis]
    if config.n_batch % n_dp or config.n_val % n_dp:
        raise ValueError(
            f"n_batch ({config.n_batch}) and n_val ({config.n_val}) "
            f"must be divisible by the '{dp_axis}' mesh axis ({n_dp})")
    return _DataShard(mesh.groups[dp_axis],
                      mesh.rows(dp_axis, config.n_batch),
                      mesh.rows(dp_axis, config.n_val))


class _Blocks:
    """What ``Trainer`` and ``MemberTrainer`` share of a validation block:
    the block index ``block_t``, the early-stop state ``es``, the log
    tensors the block writes (``train_log`` of ``n_blocks * val_freq``
    rows, the partial last block's dead rows past ``n_iter`` included,
    and ``val_log``), and ``stop_block``, the block whose validation
    latched the stop (``n_blocks`` while none has). ``lead`` is () for a
    run and (M,) for members."""

    def _init_blocks(self, lead):
        cfg, device = self.config, self.device
        n_iter, vf = cfg.n_iter, cfg.val_freq
        self.n_blocks = n_blocks = -(-n_iter // vf)
        self._partial = n_iter % vf != 0
        self._rows = torch.arange(n_blocks * vf, device=device).reshape(
            n_blocks, vf)
        self.block_t = torch.zeros(1, dtype=torch.long, device=device)
        self.es = early_stop_init(lead, device)
        nan = lambda *shape: torch.full((*lead, *shape), float("nan"),
                                        device=device)
        self.train_log = nan(n_blocks * vf, len(TRAIN_COLUMNS))
        self.val_log = nan(n_blocks, len(VAL_COLUMNS))
        self.stop_block = torch.full(lead, n_blocks, dtype=torch.long,
                                     device=device)

    def _block_steps(self):
        """(the schedule index of each of the block's steps, clamped to
        ``n_iter - 1``; whether each is a step of the run; its log row)."""
        rows = self._rows.index_select(0, self.block_t)[0]
        return (rows.clamp(max=self.config.n_iter - 1),
                rows < self.config.n_iter, rows)

    def _early_stop(self, val_loss: torch.Tensor) -> None:
        new = early_stop_update(self.es, val_loss, self.config.patience,
                                self.config.min_delta)
        for now, value in zip(self.es, new):
            now.copy_(value)

    def _log_block(self, rows, val_row, entry_stopped, live, log_rows):
        """Writes the block's train rows (a list of ``val_freq`` rows) and
        its validation row into the logs, NaN where not active: the first
        step and the validation when the run was live at the block's
        entry, the later steps while it is live after the validation and
        the step is one of the run's. Notes a stop latched here."""
        first = ~entry_stopped
        rest = (~self.es.stopped)[..., None] & live[1:]
        active = torch.cat([first[..., None], rest], dim=-1)
        rows = torch.where(active[..., None], torch.stack(rows, dim=-2),
                           float("nan"))
        self.train_log.index_copy_(rows.dim() - 2, log_rows, rows)
        val_row = torch.where(first[..., None], val_row, float("nan"))
        self.val_log.index_copy_(val_row.dim() - 1, self.block_t,
                                 val_row.unsqueeze(-2))
        torch.where(self.es.stopped & first, self.block_t[0],
                    self.stop_block, out=self.stop_block)

    def logs(self) -> TrainLogs:
        """The run's ``TrainLogs``, from the written rows and
        ``stop_block``."""
        n_iter, vf, device = self.config.n_iter, self.config.val_freq, \
            self.device
        stop = self.stop_block[..., None]
        stop_iter = torch.where(stop < self.n_blocks, stop * vf + 1, n_iter)
        blocks = torch.arange(self.n_blocks, device=device)
        val_iters = blocks * vf
        return TrainLogs(
            train=self.train_log[..., :n_iter, :].contiguous(),
            val=self.val_log,
            train_active=torch.arange(n_iter, device=device) < stop_iter,
            val_active=blocks <= stop,
            val_iters=val_iters.expand(*self.stop_block.shape,
                                       -1).contiguous(),
        )


class Trainer(_Blocks):
    """One training run: the model with scalers fitted on ``data_train``,
    the grouped Adam over ``params`` (updated in place), the data on the
    params' device, and the annealing schedules evaluated for every step.
    With ``mesh``, data-parallel over its ``dp_axis`` (module docstring):
    ``step``'s and ``validate``'s explicit ``batch_idx`` and ``noise`` are
    then the global batch's, of which this rank keeps its rows.

    ``step(i)`` and ``validate(i)`` write ``i`` into the device tensor
    ``step_t`` and run ``step_body`` / ``validate_body``, which read the
    schedule row through it and no host value. ``block_body`` runs one
    validation block (module docstring) built of those two bodies at the
    block index in ``block_t``: the body a CUDA graph captures
    (``build_train_fn``)."""

    def __init__(self, config: TrainConfig, case: Case, params: DPIVAEParams,
                 data_train, data_val, lambda_g0: float,
                 mesh: Optional[Mesh] = None, dp_axis: str = "dp"):
        self.config, self.params = config, params
        self.device = device = params.log_sigma_x.device
        self.shard = _data_shard(config, mesh, dp_axis)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.data_train = tuple(as_t(a) for a in data_train[:3])
        self.data_val = tuple(as_t(a) for a in data_val[:3])
        if self.shard is not None:
            self.data_val = tuple(a[self.shard.val] for a in self.data_val)
        self.model = setup_model(config, case, self.data_train, device=device)
        self.optimizer = make_optimizer(config, params)

        def divisors(n_points):
            # ELBO normalised per datum and dimension, the rest per datum
            denom = n_points * (case.nd_x + case.nd_y + case.nd_c)
            return torch.tensor([denom] + [n_points] * 7,
                                dtype=torch.float32, device=device)

        self._div_train = divisors(config.n_batch)
        self._div_val = divisors(config.n_val)

        scales = (lambda_g0, config.beta_x0, config.beta_c0, config.beta_y0)
        rows = [[] for _ in range(config.n_iter)]
        for which, scale in zip(("lambda", "beta_x", "beta_c", "beta_y"),
                                scales):
            sched = make_schedule(config.annealing(which), config.n_iter)
            const = getattr(sched, "constant_value", None)
            for step, row in enumerate(rows):
                row.append(scale * (const if const is not None
                                    else float(sched(step))))
        self.schedule = torch.tensor(rows, dtype=torch.float32).reshape(-1, 4)
        self._schedule_dev = self.schedule.to(device)
        self.step_t = torch.zeros(1, dtype=torch.long, device=device)
        self._init_blocks(())
        # What a step changes, and the block's copies of it: at its entry,
        # after its validation (JAX's mid), and before each step of a
        # partial block.
        self._state = adam_state_tensors(self.optimizer)
        blank = lambda: [torch.empty_like(t) for t in self._state]
        self._entry, self._mid = blank(), blank()
        self._prev = blank() if self._partial else None

    def _schedule_row(self) -> torch.Tensor:
        """The (4,) schedule row of the step in ``step_t``, on the device."""
        return self._schedule_dev.index_select(0, self.step_t)[0]

    def _normalized_loss(self, data, n_mc, sched, divisors, generator,
                         noise):
        """(ELBO / divisor with its graph, the 8 normalised components),
        with the loss weights of the (4,) schedule row ``sched``."""
        lam, bx, bc, by = sched
        cfg = self.config
        out = self.model.loss(
            self.params, *data, n=n_mc, beta_x=bx, beta_c=bc, beta_y=by,
            alpha_x=cfg.alpha_x, alpha_c=cfg.alpha_c, alpha_y=cfg.alpha_y,
            grl_alpha=lam, generator=generator, noise=noise,
        )
        comps = torch.sum(torch.stack(out), dim=1) / divisors
        return comps[0], comps.detach()

    def step(self, step_idx: int, *, generator=None, batch_idx=None,
             noise=None) -> torch.Tensor:
        """One optimizer step on a batch drawn from ``generator`` (or the
        rows ``batch_idx``, with the encoder noise ``noise``). Returns the
        step's log row in TRAIN_COLUMNS order, on the device."""
        self.step_t.fill_(step_idx)
        return self.step_body(generator, batch_idx, noise)

    def step_body(self, generator=None, batch_idx=None,
                  noise=None) -> torch.Tensor:
        """``step`` at the index in ``step_t``."""
        cfg = self.config
        sched = self._schedule_row()
        if batch_idx is None:
            batch_idx = _sample_batch(generator, cfg.n_train, cfg.n_batch,
                                      self.device)
        if self.shard is not None:
            rows = self.shard.train
            batch_idx = torch.as_tensor(batch_idx, device=self.device)[rows]
            noise = self._local_noise(noise, generator, cfg.n_mc_train,
                                      cfg.n_batch, rows)
        batch = tuple(a[batch_idx] for a in self.data_train)
        self.optimizer.zero_grad(set_to_none=True)
        scalar, comps = self._normalized_loss(
            batch, cfg.n_mc_train, sched, self._div_train, generator, noise)
        scalar.backward()
        if self.shard is not None:
            grads = [p.grad for p in self.params.parameters()
                     if p.grad is not None]
            all_reduce_sum_(grads + [comps], self.shard.group)
        if cfg.clip_gradients:
            clip_grad_global_norm_(self.params.parameters(), cfg.max_grad_norm)
        self.optimizer.step()
        sigma_x = torch.exp(self.params.log_sigma_x.detach()).reshape(1)
        return torch.cat([comps, sched, sigma_x])

    def validate(self, step_idx: int, *, generator=None,
                 noise=None) -> torch.Tensor:
        """The validation components in VAL_COLUMNS order, on the device."""
        self.step_t.fill_(step_idx)
        return self.validate_body(generator, noise)

    def validate_body(self, generator=None, noise=None) -> torch.Tensor:
        """``validate`` at the index in ``step_t``."""
        cfg = self.config
        if self.shard is not None:
            noise = self._local_noise(noise, generator, cfg.n_mc_val,
                                      cfg.n_val, self.shard.val)
        with torch.no_grad():
            _, comps = self._normalized_loss(
                self.data_val, cfg.n_mc_val, self._schedule_row(),
                self._div_val, generator, noise)
        if self.shard is not None:
            all_reduce_sum_([comps], self.shard.group)
        return comps

    def block_body(self, generator=None) -> torch.Tensor:
        """One validation block (module docstring) at the index in
        ``block_t``, drawing from ``generator`` (JAX's ``block``,
        dpivae_tpu/train/train.py:398-441); returns the 0-dim bool device
        tensor ``es.stopped`` after it."""
        steps, live, log_rows = self._block_steps()
        state = self._state
        with torch.no_grad():
            torch._foreach_copy_(self._entry, state)
            entry_stopped = self.es.stopped.clone()
        self.step_t.copy_(steps[:1])
        rows = [self.step_body(generator)]
        val_row = self.validate_body(generator)
        with torch.no_grad():
            self._early_stop(val_row[0])
            stopped_here = self.es.stopped & ~entry_stopped
            torch._foreach_copy_(self._mid, state)
        for j in range(1, self.config.val_freq):
            self.step_t.copy_(steps[j:j + 1])
            if self._partial:
                with torch.no_grad():
                    torch._foreach_copy_(self._prev, state)
            rows.append(self.step_body(generator))
            if self._partial:
                with torch.no_grad():
                    for now, then in zip(state, self._prev):
                        torch.where(live[j], now, then, out=now)
        with torch.no_grad():
            for now, mid, entry in zip(state, self._mid, self._entry):
                torch.where(stopped_here, mid, now, out=now)
                torch.where(entry_stopped, entry, now, out=now)
        self._log_block(rows, val_row, entry_stopped, live, log_rows)
        return self.es.stopped

    def _local_noise(self, noise, generator, n_mc: int, n_rows: int,
                     rows: slice) -> dict:
        """This rank's rows of the global encoder normals: ``noise``'s, or
        drawn from ``generator`` as the loss draws them."""
        eps = (encoder_noise(self.model, generator, n_mc, n_rows, self.device)
               if noise is None else torch.as_tensor(
                   noise["z"], dtype=torch.float32, device=self.device))
        return {"z": eps[:, rows]}


class _LaggedFlag:
    """A block's all-stopped flag, read on the host one block behind:
    ``record(b, flag)`` copies block b's flag into pinned host memory
    without blocking and records an event after the copy; ``read(b)``
    waits on that event, which the loop calls only after it has launched
    block b+1. Two slots, so block b+1's copy does not overwrite the one
    being read. On the CPU the copy is done when ``record`` returns."""

    def __init__(self, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(2, dtype=torch.bool, pin_memory=cuda)
        self.events = [torch.cuda.Event() for _ in range(2)] if cuda else None

    def record(self, block: int, flag: torch.Tensor) -> None:
        self.host[block % 2].copy_(flag.all(), non_blocking=True)
        if self.events is not None:
            self.events[block % 2].record()

    def read(self, block: int) -> bool:
        with spans.span("train.flag_wait"):
            if self.events is not None:
                self.events[block % 2].synchronize()
            return bool(self.host[block % 2])


def _run_blocks(run, body, generators, graphed: bool, after_block=None):
    """The loop of both train functions over ``run``'s blocks (a
    ``Trainer`` or a ``MemberTrainer``): block 0 runs ``body`` eagerly,
    which is the warm-up a capture needs (lazy allocations, the kernels'
    first-launch attributes, the NCCL communicator of a mesh). When
    ``graphed``, ``body`` is then captured once on the loop's side stream
    (drawing from ``generators``) and replayed for every later block;
    else it runs eagerly for each. Ends one block after the block whose
    flag says every run has stopped (``_LaggedFlag``), or after the last.
    ``after_block(b)`` runs on the host after block b is launched."""
    device = run.device
    cuda = device.type == "cuda"
    flag = _LaggedFlag(device)
    call = body
    with (SideStream(device) if graphed
          else contextlib.nullcontext()) as stream:
        for block in range(run.n_blocks):
            replayed = graphed and block > 0
            with spans.span("train.block", cuda and not replayed) as sp:
                if sp is not None:
                    sp.set(b=block, graphed=replayed)
                if graphed and block == 1:
                    call = Graphed(body, generators, stream).replay
                run.block_t.fill_(block)
                flag.record(block, call())
                if after_block is not None:
                    after_block(block)
                if block > 0 and flag.read(block - 1):
                    break


def build_train_fn(config: TrainConfig, case: Case,
                   mesh: Optional[Mesh] = None, dp_axis: str = "dp",
                   progress=False, cuda_graph="auto"):
    """Returns ``train_fn(params, generator, data_train, data_val,
    lambda_g0) -> (params, TrainLogs)``.

    ``train_fn`` trains a copy of ``params`` on their device, drawing
    batches and noise from ``generator``; ``data_train``/``data_val`` are
    (x, c, y[, ...]) arrays or tensors, and the input scalers are fitted on
    ``data_train``. ``lambda_g0`` is the GRL strength. With ``mesh`` the
    run is data-parallel over ``dp_axis`` (``n_batch`` and ``n_val`` must
    divide by its size): every rank passes the whole data and a generator
    seeded as the others', and the params are broadcast from the axis's
    first rank before the first step. ``progress``: True prints
    ``make_progress_printer``'s line per validation block; a callable gets
    ``(iter, train_row, val_row, es_counter, active)``, the rows as numpy,
    read on the host after each block (not with a mesh); ``active`` is
    False for the block after a stop, which the printer does not narrate.
    ``cuda_graph`` (``train.graph.resolve_cuda_graph``): "auto" replays a
    CUDA graph of the validation block after an eager first block on CUDA,
    with or without a mesh (module docstring), False runs every block
    eagerly, True insists on the graph (and raises on the CPU);
    ``generator`` must then be a CUDA generator. The loop ends one block
    after the stop (module docstring).
    """
    if progress and mesh is not None:
        raise ValueError(
            "progress narration is not supported with mesh= (JAX rejects "
            "ordered debug callbacks in multi-device programs); pass "
            "progress=False or drop the mesh")
    if _data_shard(config, mesh, dp_axis) is not None:
        resolve_cuda_graph(cuda_graph, None, mesh)
    vf = config.val_freq
    progress_cb = (make_progress_printer(config.n_iter, vf)
                   if progress is True else (progress or None))

    def train_fn(params, generator, data_train, data_val, lambda_g0):
        params = copy.deepcopy(params)
        graphed = resolve_cuda_graph(cuda_graph, params.log_sigma_x.device)
        if mesh is not None:
            replicated(mesh, params, dp_axis)
        with spans.span("train.setup"):
            run = Trainer(config, case, params, data_train, data_val,
                          lambda_g0, mesh, dp_axis)
        report = None
        if progress_cb is not None:
            def report(block):
                start = block * vf
                progress_cb(start, run.train_log[start].cpu().numpy(),
                            run.val_log[block].cpu().numpy(),
                            int(run.es.counter),
                            int(run.stop_block) >= block)

        _run_blocks(run, lambda: run.block_body(generator), [generator],
                    graphed, report)
        return params, run.logs()

    return train_fn


def train_model(config: TrainConfig, model, case: Case, data_train, data_val,
                params: Optional[DPIVAEParams] = None,
                generator: Optional[torch.Generator] = None,
                device: DeviceLike = None, mesh: Optional[Mesh] = None,
                dp_axis: str = "dp", progress="auto", cuda_graph="auto"):
    """Train a DPIVAE on ``device`` (None means CUDA).

    ``model`` (from ``setup_model``) initializes the params when none are
    given; ``params`` are not modified. Without a generator, one on
    ``device`` is seeded with ``config.seed`` when ``config.use_seed``, else
    at random (with a mesh, rank 0's random seed on every rank). With
    ``mesh`` (its device of ``device``'s type) the run is data-parallel
    over ``dp_axis`` (``build_train_fn``); every rank calls this with the
    same arguments and gets the same result. ``progress`` narrates each
    validation block (``build_train_fn``); "auto" (``resolve_progress``)
    only on the CPU at ``n_iter`` >= 5000 without a mesh. ``cuda_graph``
    (``build_train_fn``): "auto" replays a CUDA graph per validation block
    on CUDA, with a mesh too. Returns (trained params, logs).
    """
    with spans.job("train_model") as job:
        if job is not None:
            job.set(members=1, n_iter=config.n_iter)
        device = resolve_device(device)
        if mesh is not None:
            if mesh.device.type != device.type:
                raise ValueError(f"the mesh is on {mesh.device}, training "
                                 f"on {device}")
            device = mesh.device
        progress = resolve_progress(progress, config, device, mesh)
        if generator is None:
            generator = torch.Generator(device=device)
            if config.use_seed:
                generator.manual_seed(config.seed)
            elif mesh is None:
                generator.seed()
            else:
                seed = torch.tensor([torch.Generator().seed() % 2**62],
                                    device=device)
                generator.manual_seed(int(replicated(mesh, seed)))
        if params is None:
            params = model.init(generator, device=device)
        if params.log_sigma_x.device.type != device.type:
            raise ValueError(f"params are on {params.log_sigma_x.device}, "
                             f"training on {device}")
        train_fn = build_train_fn(config, case, mesh, dp_axis, progress,
                                  cuda_graph)
        return train_fn(params, generator, data_train, data_val,
                        config.lambda_g0)


# ----------------------------------------------------------------------
# Member-batched training: the counterpart of build_train_fn's train_fn
# under jax.vmap (dpivae_tpu/sweep/sweep.py:430-467), with the per-run
# lambda_g0 and ``hyper`` inputs (dpivae_tpu/train/train.py:125-132,
# 461-475).
# ----------------------------------------------------------------------

# Config fields that may differ between the members of one batched
# training: they enter the step only as values (loss weights, optimizer
# scales), so the members still share one program.
TRACEABLE_HYPER_FIELDS = frozenset({
    "lr_e", "lr_ex", "lr_ec", "lr_ey", "lr_p",
    "lr_dx", "lr_dc", "lr_dy", "lr_sigma",
    "wd_e", "wd_p", "wd_dx", "wd_dc", "wd_dy", "wd_sigma",
    "max_grad_norm",
    "beta_x0", "beta_c0", "beta_y0",
    "alpha_x", "alpha_c", "alpha_y",
})


def member_config(config: TrainConfig) -> TrainConfig:
    """The config a batched training runs: ``use_pallas="auto"`` resolved
    to the plain path and ``mc_chunk="auto"`` to None, as the JAX package
    resolves them for its sweeps (dpivae_tpu/sweep/sweep.py:415-420; the
    member-folded mc_chunk threshold there is a TPU VMEM cliff). An
    explicit ``use_pallas=True`` is kept: the members then run through the
    member-batched kernels."""
    if config.use_pallas == "auto":
        config = config.replace(use_pallas=False)
    if config.mc_chunk == "auto":
        config = config.replace(mc_chunk=None)
    return config


def member_generators(seed: int, ids, device: DeviceLike = None):
    """One ``torch.Generator`` on ``device`` per member, seeded from the
    sweep ``seed`` and the member's id (its index, or its run index where
    members share seeds): each draws its member's data, init and training
    noise, so a member's result depends neither on the chunk it runs in
    nor on the members beside it."""
    device = resolve_device(device)
    gens = []
    for i in ids:
        state = np.random.SeedSequence([int(seed), int(i)]).generate_state(
            2, dtype=np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed(int(state[0]) << 31 | int(state[1]) >> 1)
        gens.append(g)
    return gens


def encoder_noise(model, generator: torch.Generator, n: int, batch: int,
                  device: torch.device) -> torch.Tensor:
    """The (n, batch, nz) encoder normals ``DPIVAE.encode`` draws from
    ``generator`` for ``n`` samples of ``batch`` points, drawn the same way
    (``DPIVAE.noise_draws``), so that ``noise={"z": ...}`` reproduces
    them."""
    return draw_normals(model.noise_draws(observations=False), generator,
                        (n, batch), device)["z"]


def stack_params(params) -> dict:
    """Member params (a sequence of ``DPIVAEParams``) as one state dict of
    (M, ...) tensors, detached."""
    states = [p.state_dict() for p in params]
    return {k: torch.stack([s[k].detach() for s in states])
            for k in states[0]}


class MemberTrainer(_Blocks):
    """M runs trained at once, each with its own data, params, λ and
    (optionally) hyperparameters: the single-run ``Trainer`` under
    ``torch.func.vmap``. The model code stays single-member: each step is
    ``vmap(grad(...))`` of the single-run loss through ``functional_call``
    on the members' stacked params, and the fused-MLP kernels' vmap rules
    launch once for all members. Batch rows and encoder noise are drawn
    outside vmap, from one generator per member, and passed in through the
    loss's ``noise`` seam. ``MemberAdam`` updates the stacked params.

    Args:
        params: state dict of (M, ...) tensors (``stack_params``); copied.
        data_train, data_val: (x, c, y[, ...]) with a leading member axis;
            each member's input scalers are fitted on its own training
            data, as JAX refits them in the trace.
        lambdas: (M,) GRL strengths.
        hyper: config field (``TRACEABLE_HYPER_FIELDS``) -> (M,) values.
        mesh, dp_axis: data parallelism over the mesh's ``dp_axis``, as in
            ``Trainer``: each member's global batch and normals are drawn
            from its generator and this rank keeps its rows; the (M, ...)
            gradients and (M, 8) components are summed over the axis
            outside ``vmap``, before the per-member clip.

    As in ``Trainer``, ``grads``/``step``/``validate`` write the step index
    into ``step_t``, and ``step_body``/``validate_body`` read it;
    ``block_body`` runs a validation block of every member at the index
    in ``block_t``, the early stop per member: the body a CUDA graph
    captures, drawing from the members' generators.
    """

    def __init__(self, config: TrainConfig, case: Case, params: dict,
                 data_train, data_val, lambdas, hyper=None,
                 mesh: Optional[Mesh] = None, dp_axis: str = "dp"):
        hyper = dict(hyper or {})
        bad = set(hyper) - TRACEABLE_HYPER_FIELDS
        if bad:
            raise ValueError(f"{sorted(bad)} cannot differ between members; "
                             f"allowed: {sorted(TRACEABLE_HYPER_FIELDS)}")
        self.config = config = member_config(config)
        first = next(iter(params.values()))
        self.device = device = first.device
        self.n_members = m = first.shape[0]
        self.shard = _data_shard(config, mesh, dp_axis)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.data_train = tuple(as_t(a) for a in data_train[:3])
        self.data_val = tuple(as_t(a) for a in data_val[:3])
        for a in (*self.data_train, *self.data_val):
            if a.shape[0] != m:
                raise ValueError(f"data has {a.shape[0]} members, params {m}")
        if self.shard is not None:
            self.data_val = tuple(a[:, self.shard.val] for a in self.data_val)
        self.template = make_template_model(config, case, device=device)
        self.scalers = tuple(
            (torch.mean(a, dim=1, keepdim=True),
             torch.std(a, dim=1, keepdim=True, correction=0))
            for a in self.data_train)
        self.optimizer = MemberAdam(config, params, hyper)
        self.params = self.optimizer.params
        self._bound = bind_params(self.template)

        def per_member(field):
            if field in hyper:
                return as_t(hyper[field]).reshape(m)
            return torch.full((m,), float(getattr(config, field)),
                              device=device)

        self.alphas = torch.stack([per_member(f"alpha_{b}") for b in "xcy"],
                                  dim=1)
        scales = torch.stack(
            [as_t(lambdas).reshape(m)] + [per_member(f"beta_{b}0")
                                          for b in "xcy"], dim=1)
        shape = np.ones((config.n_iter, 4))
        for col, which in enumerate(("lambda", "beta_x", "beta_c", "beta_y")):
            sched = make_schedule(config.annealing(which), config.n_iter)
            if getattr(sched, "constant_value", None) is None:
                shape[:, col] = [float(sched(s)) for s in range(config.n_iter)]
            else:
                shape[:, col] = sched.constant_value
        # (M, n_iter, 4): scale x schedule in float64, then f32, as the
        # single run forms each row.
        self.schedule = (scales.double().cpu()[:, None, :]
                         * torch.from_numpy(shape)[None]).float().to(device)
        self.step_t = torch.zeros(1, dtype=torch.long, device=device)
        self._members = torch.arange(m, device=device)[:, None]
        self._init_blocks((m,))

        def divisors(n_points):
            denom = n_points * (case.nd_x + case.nd_y + case.nd_c)
            return torch.tensor([denom] + [n_points] * 7,
                                dtype=torch.float32, device=device)

        self._div_train = divisors(config.n_batch)
        self._div_val = divisors(config.n_val)
        self._grad_fn = torch.func.vmap(torch.func.grad(functools.partial(
            self._member_loss, divisors=self._div_train), has_aux=True))
        self._value_fn = torch.func.vmap(functools.partial(
            self._member_comps, divisors=self._div_val))

    # -- one member, under vmap ----------------------------------------
    def _member_comps(self, p, x, c, y, eps, scalers, sched, alphas, *,
                      divisors):
        """The normalised loss components (8,) of one member."""
        model = dataclasses.replace(
            self.template, **{name: StandardScaler(*s) for name, s in zip(
                ("transform_x", "transform_c", "transform_y"), scalers)})
        out = self._bound(model, "loss", p, x, c, y, n=eps.shape[0],
                          beta_x=sched[1], beta_c=sched[2], beta_y=sched[3],
                          alpha_x=alphas[0], alpha_c=alphas[1],
                          alpha_y=alphas[2], grl_alpha=sched[0],
                          noise={"z": eps})
        return torch.sum(torch.stack(out), dim=1) / divisors

    def _member_loss(self, p, *args, divisors):
        comps = self._member_comps(p, *args, divisors=divisors)
        return comps[0], comps.detach()

    # -- the batched step ----------------------------------------------
    def _draw_batch(self, generators):
        cfg = self.config
        u = torch.stack([rand((cfg.n_train,), g, self.device)
                         for g in generators])
        return torch.topk(u, cfg.n_batch, dim=1).indices

    def _draw_noise(self, generators, n, batch):
        return torch.stack([encoder_noise(self.template, g, n, batch,
                                          self.device) for g in generators])

    def _schedule_rows(self) -> torch.Tensor:
        """The (M, 4) schedule rows of the step in ``step_t``."""
        return self.schedule.index_select(1, self.step_t)[:, 0]

    def grads(self, step_idx: int, *, generators=None, batch_idx=None,
              noise=None):
        """(comps (M, 8), gradients {name: (M, ...)}) of one step's
        normalised loss, on a batch drawn from ``generators`` (one per
        member) or the (M, n_batch) rows ``batch_idx`` with the encoder
        normals ``noise={"z": (M, n, n_batch, nz)}``."""
        self.step_t.fill_(step_idx)
        return self._grads(self._schedule_rows(), generators, batch_idx,
                           noise)

    def _grads(self, sched, generators, batch_idx, noise):
        cfg = self.config
        if batch_idx is None:
            batch_idx = self._draw_batch(generators)
        eps = (self._draw_noise(generators, cfg.n_mc_train, cfg.n_batch)
               if noise is None else noise["z"])
        batch_idx = torch.as_tensor(batch_idx, device=self.device)
        eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        if self.shard is not None:
            batch_idx = batch_idx[:, self.shard.train]
            eps = eps[:, :, self.shard.train]
        batch = tuple(a[self._members, batch_idx] for a in self.data_train)
        grads, comps = self._grad_fn(self.params, *batch, eps, self.scalers,
                                     sched, self.alphas)
        if self.shard is not None:
            all_reduce_sum_(list(grads.values()) + [comps], self.shard.group)
        return comps, grads

    def step(self, step_idx: int, *, generators=None, batch_idx=None,
             noise=None) -> torch.Tensor:
        """One optimizer step of every member; returns the (M, 13) log
        rows in TRAIN_COLUMNS order, on the device."""
        self.step_t.fill_(step_idx)
        return self.step_body(generators, batch_idx, noise)

    def step_body(self, generators=None, batch_idx=None,
                  noise=None) -> torch.Tensor:
        """``step`` at the index in ``step_t``."""
        sched = self._schedule_rows()
        comps, grads = self._grads(sched, generators, batch_idx, noise)
        self.optimizer.step(grads)
        sigma_x = torch.exp(self.params["log_sigma_x"]).reshape(-1, 1)
        return torch.cat([comps, sched, sigma_x], dim=1)

    def validate(self, step_idx: int, *, generators=None,
                 noise=None) -> torch.Tensor:
        """The (M, 8) validation components in VAL_COLUMNS order."""
        self.step_t.fill_(step_idx)
        return self.validate_body(generators, noise)

    def validate_body(self, generators=None, noise=None) -> torch.Tensor:
        """``validate`` at the index in ``step_t``."""
        cfg = self.config
        eps = torch.as_tensor(
            self._draw_noise(generators, cfg.n_mc_val, cfg.n_val)
            if noise is None else noise["z"], dtype=torch.float32,
            device=self.device)
        if self.shard is not None:
            eps = eps[:, :, self.shard.val]
        with torch.no_grad():
            comps = self._value_fn(
                self.params, *self.data_val, eps, self.scalers,
                self._schedule_rows(), self.alphas)
        if self.shard is not None:
            all_reduce_sum_([comps], self.shard.group)
        return comps


    def block_body(self, generators=None) -> torch.Tensor:
        """``Trainer.block_body`` over the members, the entry, mid and
        pre-step states kept and put back per member by
        ``MemberAdam.state`` / ``restore`` on device masks (JAX's
        ``block`` under ``jax.vmap``); returns the (M,) bool device tensor
        ``es.stopped`` after it."""
        steps, live, log_rows = self._block_steps()
        opt = self.optimizer
        entry = opt.state()
        entry_stopped = self.es.stopped.clone()
        self.step_t.copy_(steps[:1])
        rows = [self.step_body(generators)]
        val_row = self.validate_body(generators)
        self._early_stop(val_row[:, 0])
        stopped_here = self.es.stopped & ~entry_stopped
        mid = opt.state()
        for j in range(1, self.config.val_freq):
            self.step_t.copy_(steps[j:j + 1])
            prev = opt.state() if self._partial else None
            rows.append(self.step_body(generators))
            if prev is not None:
                opt.restore((~live[j]).expand(self.n_members), prev)
        opt.restore(stopped_here, mid)
        opt.restore(entry_stopped, entry)
        self._log_block(rows, val_row, entry_stopped, live, log_rows)
        return self.es.stopped


def build_member_train_fn(config: TrainConfig, case: Case,
                          mesh: Optional[Mesh] = None, dp_axis: str = "dp",
                          cuda_graph="auto"):
    """Returns ``train_fn(params, generators, data_train, data_val,
    lambdas, hyper=None) -> (params, TrainLogs)`` for M members at once:
    ``build_train_fn``'s loop over a ``MemberTrainer``, with logs of shape
    (M, n_iter, 13) and (M, n_blocks, 8) and params a state dict of (M,
    ...) tensors.

    Early stopping is per member, at block granularity as in the JAX
    package (dpivae_tpu/train/train.py:398-441): a member whose stop
    latches at a block's validation keeps its state right after that
    block's first step (the single run's break point), and a member
    stopped before a block keeps its state through it, both put back on
    the device inside the block (``MemberTrainer.block_body``); their rows
    past the stop are NaN and inactive. The loop ends one block after the
    block at which every member has stopped (``_run_blocks``), and reads
    nothing per member. With ``mesh``, each member's steps are
    data-parallel over ``dp_axis`` (``MemberTrainer``). ``cuda_graph`` as
    in ``build_train_fn``: the block graph draws from the M
    ``generators``, which must then be CUDA ones.
    """
    config = member_config(config)
    if _data_shard(config, mesh, dp_axis) is not None:
        resolve_cuda_graph(cuda_graph, None, mesh)

    def train_fn(params, generators, data_train, data_val, lambdas,
                 hyper=None):
        with spans.span("train.setup"):
            run = MemberTrainer(config, case, params, data_train, data_val,
                                lambdas, hyper, mesh, dp_axis)
        if len(generators) != run.n_members:
            raise ValueError(f"{len(generators)} generators for "
                             f"{run.n_members} members")
        graphed = resolve_cuda_graph(cuda_graph, run.device)
        _run_blocks(run, lambda: run.block_body(generators), generators,
                    graphed)
        params_out = {k: v.detach().clone() for k, v in run.params.items()}
        return params_out, run.logs()

    return train_fn
