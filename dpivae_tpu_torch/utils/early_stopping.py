"""Early stopping as a state transition (counterpart of
dpivae_tpu/utils/early_stopping.py:31-58).

The train loop reads each validation loss on the host once per block and
applies ``early_stop_update``. Comparisons run in float32, as in the JAX
package, so a loss on the edge of ``best - min_delta`` decides the same way.

- improvement (val < best - min_delta): best <- val, counter <- 0
- val > best: counter += 1; stop when counter >= patience
- best - min_delta <= val <= best: no change (dead zone)
- once stopped, the state no longer changes
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class EarlyStopState(NamedTuple):
    best: np.float32  # lowest validation loss seen
    counter: int  # validations since the last improvement
    stopped: bool  # latched once set


def early_stop_init() -> EarlyStopState:
    return EarlyStopState(best=np.float32(np.inf), counter=0, stopped=False)


def early_stop_update(state: EarlyStopState, val_loss, patience: int,
                      min_delta: float) -> EarlyStopState:
    if state.stopped:
        return state
    val_loss = np.float32(val_loss)
    if val_loss < state.best - np.float32(min_delta):
        return EarlyStopState(best=val_loss, counter=0, stopped=False)
    if val_loss > state.best:
        counter = state.counter + 1
        # The stop is checked only in the worse-than-best branch: without
        # that gate patience=0 would stop on an improving validation.
        return EarlyStopState(best=state.best, counter=counter,
                              stopped=counter >= patience)
    return state
