"""Early stopping as a device-tensor state transition (counterpart of
dpivae_tpu/utils/early_stopping.py:31-58, line for line).

The state is three device tensors of shape () for a run or (M,) for the
members of a batched training, and ``early_stop_update`` is ``torch.where``
arithmetic on them: it reads no host value, so the stop decision runs
inside a training block's CUDA graph (``train/train.py``). Comparisons run
in float32, as in the JAX package, so a loss on the edge of
``best - min_delta`` decides the same way.

- improvement (val < best - min_delta): best <- val, counter <- 0
- val > best: counter += 1; stop when counter >= patience
- best - min_delta <= val <= best: no change (dead zone)
- once stopped, the state no longer changes
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EarlyStopState(NamedTuple):
    best: torch.Tensor  # float32, lowest validation loss seen
    counter: torch.Tensor  # int32, validations since the last improvement
    stopped: torch.Tensor  # bool, latched once set


def early_stop_init(shape=(), device=None) -> EarlyStopState:
    return EarlyStopState(
        best=torch.full(shape, float("inf"), dtype=torch.float32,
                        device=device),
        counter=torch.zeros(shape, dtype=torch.int32, device=device),
        stopped=torch.zeros(shape, dtype=torch.bool, device=device),
    )


def early_stop_update(state: EarlyStopState, val_loss: torch.Tensor,
                      patience: int, min_delta: float) -> EarlyStopState:
    val_loss = val_loss.to(torch.float32)
    # min_delta as the float32 JAX's weak-typed subtraction rounds it to
    improved = val_loss < state.best - float(np.float32(min_delta))
    worse = val_loss > state.best

    new_best = torch.where(improved, val_loss, state.best)
    new_counter = torch.where(
        improved, torch.zeros_like(state.counter),
        torch.where(worse, state.counter + 1, state.counter))
    # The stop is checked only in the worse-than-best branch: without that
    # gate patience=0 would stop on an improving validation.
    newly_stopped = worse & (new_counter >= patience)
    return EarlyStopState(
        best=torch.where(state.stopped, state.best, new_best),
        counter=torch.where(state.stopped, state.counter, new_counter),
        stopped=state.stopped | newly_stopped,
    )
