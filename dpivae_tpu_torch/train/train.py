"""Training loop (counterpart of dpivae_tpu/train/train.py:49-113,161-477,
526-596).

The JAX package compiles the whole training into one program (a scan over
validation blocks). Here the same loop runs from Python, in the same
order: each block of ``val_freq`` iterations runs one train step, one
validation of ``n_val`` points x ``n_mc_val`` samples under ``no_grad``,
the early-stop update, then the other ``val_freq - 1`` steps. A stop that
latches at a block's validation ends the run there, so the params returned
are those right after that block's first step (the reference's ``break``);
a partial last block stops at ``n_iter``.

Logs live in device tensors filled in place. The one host read per block
is the validation loss the early-stop decision needs, so no step waits on
the device by itself.

``Trainer`` holds one run's state and exposes the single train step, with
a seam for tests: explicit ``batch_idx`` and ``noise`` in place of the
generator. ``MemberTrainer`` and ``build_member_train_fn`` train M runs at
once (the sweeps' engine, the counterpart of ``train_fn`` under
``jax.vmap`` with per-run λ and ``hyper`` inputs), with the same loop and
seam.

With a ``mesh`` (``parallel.make_mesh``) both are data-parallel over its
``dp_axis`` (counterpart of the JAX package's ``mesh=`` branch): every
rank holds the whole data and draws the global batch rows and encoder
normals from a generator in lockstep with the other ranks', keeps its
contiguous rows of the batch and of the validation set, and sums the
gradients and the log components over the axis in one collective per
step, before the clip. Each component is a per-datum sum over a global
divisor, so the sum of the ranks' is the global row, and the early stop
reads the same number on every rank. ``use_pallas="auto"`` resolves on
the global training shape, as in the JAX package.

``train_model(progress=...)`` narrates one line per validation block on
stderr (``make_progress_printer``), at the block's host read.

On CUDA the loop is graphed (``cuda_graph="auto"``, ``train/graph.py``):
the first block runs eagerly on a side stream (the real step 0,
validation 0 and steps 1..vf-1, which also warms every lazy allocation and
kernel attribute), then one train step and one validation pass are each
captured into a CUDA graph and replayed in the loop's order, the step
index written into a device tensor before each replay. A step replays
forward, backward (with the fused-MLP kernels and ``remat_decode``'s
recompute), clip and Adam in one launch; the members of a batched training
replay ``vmap(grad(...))`` and ``MemberAdam`` the same way, and their
early-stop freeze (``MemberAdam.state``/``restore``) stays outside the
graphs, in place on the buffers the graphs read. The graphed loop gives
the eager loop's results (``cuda_graph=False``). With a ``mesh`` the loop
stays eager: its NCCL collectives are not captured.

Not ported: scan unrolling, the executable cache, and the early-stop
decision on the device (a whole block in one graph, as JAX's ``pick``
does); the loop reads the validation loss once per block.
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
    clip_grad_global_norm_,
    make_optimizer,
)
from dpivae_tpu_torch.train.setup import make_template_model, setup_model
from dpivae_tpu_torch.utils import (
    DeviceLike,
    draw_normals,
    rand,
    resolve_device,
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


class Trainer:
    """One training run: the model with scalers fitted on ``data_train``,
    the grouped Adam over ``params`` (updated in place), the data on the
    params' device, and the annealing schedules evaluated for every step.
    With ``mesh``, data-parallel over its ``dp_axis`` (module docstring):
    ``step``'s and ``validate``'s explicit ``batch_idx`` and ``noise`` are
    then the global batch's, of which this rank keeps its rows.

    ``step(i)`` and ``validate(i)`` write ``i`` into the device tensor
    ``step_t`` and run ``step_body`` / ``validate_body``, which read the
    schedule row through it and no host value: those are the bodies a CUDA
    graph captures (``build_train_fn``)."""

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

    def _local_noise(self, noise, generator, n_mc: int, n_rows: int,
                     rows: slice) -> dict:
        """This rank's rows of the global encoder normals: ``noise``'s, or
        drawn from ``generator`` as the loss draws them."""
        eps = (encoder_noise(self.model, generator, n_mc, n_rows, self.device)
               if noise is None else torch.as_tensor(
                   noise["z"], dtype=torch.float32, device=self.device))
        return {"z": eps[:, rows]}


def _graphed_calls(run, generators, stream, step_body, validate_body):
    """``(step(i), validate(i))`` for the loop, each writing ``i`` into
    ``run.step_t`` and replaying a CUDA graph of ``step_body`` /
    ``validate_body`` (``train/graph.py``), captured here on ``stream``,
    each on its own memory pool (the two replay interleaved). Both
    bodies must have run eagerly on ``stream`` before."""

    def replayer(graph):
        def call(i):
            run.step_t.fill_(i)
            return graph.replay()
        return call

    return tuple(replayer(Graphed(body, generators, stream))
                 for body in (step_body, validate_body))


def _loop_stream(graphed: bool, device: torch.device):
    """The context a loop runs in: a ``SideStream`` when it is graphed,
    else nothing."""
    return SideStream(device) if graphed else contextlib.nullcontext()


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
    at the block's host read (not with a mesh). ``cuda_graph``
    (``train.graph.resolve_cuda_graph``): "auto" replays CUDA graphs of
    the step and the validation after an eager first block on CUDA
    without a mesh (module docstring), False runs every step eagerly,
    True insists on graphs (and raises on the CPU or with a mesh);
    ``generator`` must then be a CUDA generator.
    """
    if mesh is not None:
        resolve_cuda_graph(cuda_graph, None, mesh)
    if progress and mesh is not None:
        raise ValueError(
            "progress narration is not supported with mesh= (JAX rejects "
            "ordered debug callbacks in multi-device programs); pass "
            "progress=False or drop the mesh")
    _data_shard(config, mesh, dp_axis)
    n_iter, vf = config.n_iter, config.val_freq
    n_blocks = -(-n_iter // vf)
    progress_cb = (make_progress_printer(n_iter, vf) if progress is True
                   else (progress or None))

    def train_fn(params, generator, data_train, data_val, lambda_g0):
        params = copy.deepcopy(params)
        device = params.log_sigma_x.device
        graphed = resolve_cuda_graph(cuda_graph, device, mesh)
        if mesh is not None:
            replicated(mesh, params, dp_axis)
        run = Trainer(config, case, params, data_train, data_val, lambda_g0,
                      mesh, dp_axis)
        nan = lambda *shape: torch.full(shape, float("nan"), device=device)
        train, val = nan(n_iter, len(TRAIN_COLUMNS)), nan(n_blocks,
                                                          len(VAL_COLUMNS))
        es = early_stop_init()
        stop_iter, live_blocks = n_iter, n_blocks
        step = lambda i: run.step(i, generator=generator)
        validate = lambda i: run.validate(i, generator=generator)
        with _loop_stream(graphed, device) as stream:
            for block in range(n_blocks):
                if graphed and block == 1:
                    step, validate = _graphed_calls(
                        run, [generator], stream,
                        lambda: run.step_body(generator),
                        lambda: run.validate_body(generator))
                start = block * vf
                train[start] = step(start)
                val[block] = validate(start)
                es = early_stop_update(es, float(val[block, 0]),
                                       config.patience, config.min_delta)
                if progress_cb is not None:
                    progress_cb(start, train[start].cpu().numpy(),
                                val[block].cpu().numpy(), es.counter, True)
                if es.stopped:
                    stop_iter, live_blocks = start + 1, block + 1
                    break
                for i in range(start + 1, min(start + vf, n_iter)):
                    train[i] = step(i)
        steps = torch.arange(n_iter, device=device)
        blocks = torch.arange(n_blocks, device=device)
        return params, TrainLogs(
            train=train, val=val, train_active=steps < stop_iter,
            val_active=blocks < live_blocks, val_iters=blocks * vf,
        )

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
    (``build_train_fn``): "auto" replays CUDA graphs on CUDA without a
    mesh. Returns (trained params, logs).
    """
    device = resolve_device(device)
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh is on {mesh.device}, training on "
                             f"{device}")
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
        raise ValueError(
            f"params are on {params.log_sigma_x.device}, training on {device}"
        )
    train_fn = build_train_fn(config, case, mesh, dp_axis, progress,
                              cuda_graph)
    return train_fn(params, generator, data_train, data_val, config.lambda_g0)


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


class MemberTrainer:
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
    into ``step_t``, and ``step_body``/``validate_body`` read it: the
    bodies a CUDA graph captures, drawing from the members' generators.
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
    stopped before a block keeps its state through it, both restored with
    ``torch.where`` on params and Adam moments; their rows past the stop
    are NaN and inactive. The (M,) validation losses are read once per
    block, and the loop ends early only when every member has stopped.
    With ``mesh``, each member's steps are data-parallel over ``dp_axis``
    (``MemberTrainer``). ``cuda_graph`` as in ``build_train_fn``: the
    graphs draw from the M ``generators``, which must then be CUDA ones.
    """
    if mesh is not None:
        resolve_cuda_graph(cuda_graph, None, mesh)
    config = member_config(config)
    _data_shard(config, mesh, dp_axis)
    n_iter, vf = config.n_iter, config.val_freq
    n_blocks = -(-n_iter // vf)

    def train_fn(params, generators, data_train, data_val, lambdas,
                 hyper=None):
        run = MemberTrainer(config, case, params, data_train, data_val,
                            lambdas, hyper, mesh, dp_axis)
        m, device = run.n_members, run.device
        if len(generators) != m:
            raise ValueError(f"{len(generators)} generators for {m} members")
        graphed = resolve_cuda_graph(cuda_graph, device, mesh)
        nan = lambda *shape: torch.full(shape, float("nan"), device=device)
        train = nan(m, n_iter, len(TRAIN_COLUMNS))
        val = nan(m, n_blocks, len(VAL_COLUMNS))
        es = [early_stop_init() for _ in range(m)]
        stop_iter = np.full(m, n_iter)
        live_blocks = np.full(m, n_blocks)
        step = lambda i: run.step(i, generators=generators)
        validate = lambda i: run.validate(i, generators=generators)
        with _loop_stream(graphed, device) as stream:
            for block in range(n_blocks):
                entry_stopped = np.array([s.stopped for s in es])
                if entry_stopped.all():
                    break
                if graphed and block == 1:
                    step, validate = _graphed_calls(
                        run, generators, stream,
                        lambda: run.step_body(generators),
                        lambda: run.validate_body(generators))
                entry = run.optimizer.state() if entry_stopped.any() else None
                start = block * vf
                train[:, start] = step(start)
                val[:, block] = validate(start)
                losses = val[:, block, 0].cpu().numpy()
                es = [early_stop_update(s, v, config.patience,
                                        config.min_delta)
                      for s, v in zip(es, losses)]
                stopped_here = (np.array([s.stopped for s in es])
                                & ~entry_stopped)
                mid = run.optimizer.state() if stopped_here.any() else None
                for i in range(start + 1, min(start + vf, n_iter)):
                    train[:, i] = step(i)
                if mid is not None:
                    run.optimizer.restore(torch.from_numpy(stopped_here), mid)
                    stop_iter[stopped_here] = start + 1
                    live_blocks[stopped_here] = block + 1
                if entry is not None:
                    run.optimizer.restore(torch.from_numpy(entry_stopped),
                                          entry)
        steps = torch.arange(n_iter, device=device)
        blocks = torch.arange(n_blocks, device=device)
        train_active = steps[None] < torch.as_tensor(stop_iter,
                                                     device=device)[:, None]
        val_active = blocks[None] < torch.as_tensor(live_blocks,
                                                    device=device)[:, None]
        train[~train_active] = float("nan")
        val[~val_active] = float("nan")
        params_out = {k: v.detach().clone() for k, v in run.params.items()}
        return params_out, TrainLogs(
            train=train, val=val, train_active=train_active,
            val_active=val_active,
            val_iters=(blocks * vf)[None].expand(m, -1).clone(),
        )

    return train_fn
