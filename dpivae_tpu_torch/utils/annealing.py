"""Annealing schedules as ``step -> weight`` functions (counterpart of
dpivae_tpu/utils/annealing.py:21-69).

Each factory returns a function of a Python step index. The constant and
cyclical schedules return floats; the sigmoid schedule returns a 0-d CPU
tensor from the port's ``Normal.cdf``. The train loop evaluates them on the
host, so they add no work on the device.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from dpivae_tpu_torch.config import AnnealingConfig
from dpivae_tpu_torch.utils.distributions import Normal

Schedule = Callable[[int], Union[float, torch.Tensor]]


def constant_schedule(value: float = 1.0) -> Schedule:
    def schedule(step):
        return float(value)

    # Marker letting consumers read the multiplier once instead of per step.
    schedule.constant_value = value
    return schedule


def cyclical_schedule(n_iter: int, n_cycles: int, R: float) -> Schedule:
    """Cyclical ramp (Fu et al. 2019): within each cycle of length
    n_iter/n_cycles the weight ramps linearly to 1.0 over the first
    fraction ``R`` of the cycle, then holds at 1.0."""
    cycle_len = n_iter / n_cycles

    def schedule(step):
        tau = (float(step) % cycle_len) / cycle_len
        return tau / R if tau <= R else 1.0

    return schedule


def sigmoid_schedule(n_iter: int, mu: float, cov: float) -> Schedule:
    """Normal-CDF ramp with midpoint mu*n_iter, spread mu*n_iter*cov."""
    mu_t = mu * n_iter
    dist = Normal(mu_t, mu_t * cov)

    def schedule(step):
        return dist.cdf(torch.tensor(float(step), dtype=torch.float32))

    return schedule


def make_schedule(cfg: AnnealingConfig, n_iter: int) -> Schedule:
    """Build a schedule from config."""
    t: Optional[str] = cfg.type
    if t is None or t in ("none", "None"):
        return constant_schedule(1.0)
    if t == "cyclical":
        return cyclical_schedule(n_iter, cfg.n_cycles, cfg.R)
    if t == "sigmoid":
        return sigmoid_schedule(n_iter, cfg.mu, cfg.cov)
    raise ValueError(f"Invalid type {t}")
