"""Synthetic data generation (counterpart of dpivae_tpu/utils/data.py:
32-73)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dpivae_tpu_torch.utils import DeviceLike, randn, resolve_device
from dpivae_tpu_torch.utils.priors import factor_indices


def sample_response(
    case,
    generator: torch.Generator,
    n: int,
    sample_dist=None,
    z: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample (x, c, y, z) for a case, on ``device`` (None means CUDA).

    Either draw ``n`` factor vectors from ``sample_dist`` or tile a given
    ``z`` n times along a new leading axis. All randomness comes from
    ``generator``, drawn on the generator's device.

    Returns:
        x: response (noisy surrogate output), (..., nd_x)
        c: covariates = z columns of type "c" + noise
        y: labels = z columns of type "y" + noise
        z: the sampled ground-truth factors
    """
    device = resolve_device(device)
    if sample_dist is None and z is None:
        raise ValueError("At least one of `sample_dist` and `z` must not be None")

    if z is None:
        z_sample = sample_dist.sample(generator, (n,)).to(device)
    else:
        z = torch.as_tensor(z, dtype=torch.float32, device=device)
        z_sample = z.expand(n, *z.shape)

    idx_c = factor_indices(case.factors, "c")
    idx_y = factor_indices(case.factors, "y")

    x_sample = case.full_model(z_sample)
    x_sample = x_sample + case.sigma_x * randn(x_sample.shape, generator, device)

    c_sample = z_sample[..., idx_c]
    c_sample = c_sample + case.sigma_c * randn(c_sample.shape, generator, device)

    y_sample = z_sample[..., idx_y]
    y_sample = y_sample + case.sigma_y * randn(y_sample.shape, generator, device)

    return x_sample, c_sample, y_sample, z_sample
