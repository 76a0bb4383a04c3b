"""Training loop (counterpart of dpivae_tpu/train/train.py:49-113,161-477,
526-596).

The JAX package compiles the whole training into one program (a scan over
validation blocks). Here the same loop runs eagerly, in the same order:
each block of ``val_freq`` iterations runs one train step, one validation
of ``n_val`` points x ``n_mc_val`` samples under ``no_grad``, the
early-stop update, then the other ``val_freq - 1`` steps. A stop that
latches at a block's validation ends the run there, so the params returned
are those right after that block's first step (the reference's ``break``);
a partial last block stops at ``n_iter``.

Logs live in device tensors filled in place. The one host read per block
is the validation loss the early-stop decision needs, so no step waits on
the device by itself.

``Trainer`` holds one run's state and exposes the single train step, with
a seam for tests: explicit ``batch_idx`` and ``noise`` in place of the
generator. Not ported: data parallelism over a mesh, per-run
hyperparameter overrides, progress narration, scan unrolling, the
executable cache and a CUDA-graph or compiled step loop (ROADMAP.md,
queue 1, item 5).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from dpivae_tpu_torch.cases import Case
from dpivae_tpu_torch.config import TrainConfig
from dpivae_tpu_torch.models.vae import DPIVAEParams
from dpivae_tpu_torch.train.optim import clip_grad_global_norm_, make_optimizer
from dpivae_tpu_torch.train.setup import setup_model
from dpivae_tpu_torch.utils import DeviceLike, rand, resolve_device
from dpivae_tpu_torch.utils.annealing import make_schedule
from dpivae_tpu_torch.utils.early_stopping import (
    early_stop_init,
    early_stop_update,
)

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


class Trainer:
    """One training run: the model with scalers fitted on ``data_train``,
    the grouped Adam over ``params`` (updated in place), the data on the
    params' device, and the annealing schedules evaluated for every step."""

    def __init__(self, config: TrainConfig, case: Case, params: DPIVAEParams,
                 data_train, data_val, lambda_g0: float):
        self.config, self.params = config, params
        self.device = device = params.log_sigma_x.device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
        self.data_train = tuple(as_t(a) for a in data_train[:3])
        self.data_val = tuple(as_t(a) for a in data_val[:3])
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

    def _normalized_loss(self, data, n_mc, step_idx, divisors, generator,
                         noise):
        """(ELBO / divisor with its graph, the 8 normalised components)."""
        lam, bx, bc, by = self.schedule[step_idx].tolist()
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
        cfg = self.config
        if batch_idx is None:
            batch_idx = _sample_batch(generator, cfg.n_train, cfg.n_batch,
                                      self.device)
        batch = tuple(a[batch_idx] for a in self.data_train)
        self.optimizer.zero_grad(set_to_none=True)
        scalar, comps = self._normalized_loss(
            batch, cfg.n_mc_train, step_idx, self._div_train, generator, noise)
        scalar.backward()
        if cfg.clip_gradients:
            clip_grad_global_norm_(self.params.parameters(), cfg.max_grad_norm)
        self.optimizer.step()
        sigma_x = torch.exp(self.params.log_sigma_x.detach()).reshape(1)
        return torch.cat([comps, self._schedule_dev[step_idx], sigma_x])

    def validate(self, step_idx: int, *, generator=None,
                 noise=None) -> torch.Tensor:
        """The validation components in VAL_COLUMNS order, on the device."""
        with torch.no_grad():
            _, comps = self._normalized_loss(
                self.data_val, self.config.n_mc_val, step_idx, self._div_val,
                generator, noise)
        return comps


def build_train_fn(config: TrainConfig, case: Case):
    """Returns ``train_fn(params, generator, data_train, data_val,
    lambda_g0) -> (params, TrainLogs)``.

    ``train_fn`` trains a copy of ``params`` on their device, drawing
    batches and noise from ``generator``; ``data_train``/``data_val`` are
    (x, c, y[, ...]) arrays or tensors, and the input scalers are fitted on
    ``data_train``. ``lambda_g0`` is the GRL strength.
    """
    n_iter, vf = config.n_iter, config.val_freq
    n_blocks = -(-n_iter // vf)

    def train_fn(params, generator, data_train, data_val, lambda_g0):
        params = copy.deepcopy(params)
        run = Trainer(config, case, params, data_train, data_val, lambda_g0)
        device = params.log_sigma_x.device
        nan = lambda *shape: torch.full(shape, float("nan"), device=device)
        train, val = nan(n_iter, len(TRAIN_COLUMNS)), nan(n_blocks,
                                                          len(VAL_COLUMNS))
        es = early_stop_init()
        stop_iter, live_blocks = n_iter, n_blocks
        for block in range(n_blocks):
            start = block * vf
            train[start] = run.step(start, generator=generator)
            val[block] = run.validate(start, generator=generator)
            es = early_stop_update(es, float(val[block, 0]), config.patience,
                                   config.min_delta)
            if es.stopped:
                stop_iter, live_blocks = start + 1, block + 1
                break
            for i in range(start + 1, min(start + vf, n_iter)):
                train[i] = run.step(i, generator=generator)
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
                device: DeviceLike = None):
    """Train a DPIVAE on ``device`` (None means CUDA).

    ``model`` (from ``setup_model``) initializes the params when none are
    given; ``params`` are not modified. Without a generator, one on
    ``device`` is seeded with ``config.seed`` when ``config.use_seed``, else
    at random. Returns (trained params, logs).
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        if config.use_seed:
            generator.manual_seed(config.seed)
        else:
            generator.seed()
    if params is None:
        params = model.init(generator, device=device)
    if params.log_sigma_x.device.type != device.type:
        raise ValueError(
            f"params are on {params.log_sigma_x.device}, training on {device}"
        )
    train_fn = build_train_fn(config, case)
    return train_fn(params, generator, data_train, data_val, config.lambda_g0)
