"""Synthetic data generation (counterpart of dpivae_tpu/utils/data.py:
20-73)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dpivae_tpu_torch.utils import DeviceLike, randn, resolve_device
from dpivae_tpu_torch.utils.priors import factor_indices


def test_train_split(n_train: int, n_test: int, data,
                     generator: Optional[torch.Generator] = None):
    """Split the arrays of ``data`` along their first axis into
    ``n_train`` and ``n_test`` rows: ``[a_train, a_test, b_train, b_test,
    ...]``, as scikit-learn's ``train_test_split`` (which the JAX package
    wraps) returns them. The rows are a random permutation drawn from
    ``generator`` (a CPU ``torch.Generator``; by default a fresh seed), not
    scikit-learn's shuffle, which the port does not import. Each part is
    of its input's type (numpy or tensor)."""
    n_train, n_test = int(n_train), int(n_test)
    n = len(data[0])
    if n_train + n_test > n:
        raise ValueError(f"n_train + n_test = {n_train + n_test} exceeds the "
                         f"{n} rows")
    if generator is None:
        generator = torch.Generator()
        generator.seed()
    order = torch.randperm(n, generator=generator)
    rows = (order[:n_train], order[n_train:n_train + n_test])
    out = []
    for a in data:
        if len(a) != n:
            raise ValueError("the arrays of data differ in length")
        for r in rows:
            out.append(a[r.to(a.device)] if isinstance(a, torch.Tensor)
                       else a[r.numpy()])
    return out


def _columns(a: torch.Tensor, idx) -> torch.Tensor:
    """The last-axis columns ``idx`` (a list of ints) of ``a``, taken with
    no index tensor: indexing with a Python list copies the list from the
    host, which a captured CUDA graph cannot hold (the sweeps' sampling
    draws its datasets inside one)."""
    if not idx:
        return a[..., :0]
    if list(idx) == list(range(idx[0], idx[-1] + 1)):
        return a[..., idx[0]:idx[-1] + 1]
    return torch.stack([a[..., i] for i in idx], dim=-1)


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

    c_sample = _columns(z_sample, idx_c)
    c_sample = c_sample + case.sigma_c * randn(c_sample.shape, generator, device)

    y_sample = _columns(z_sample, idx_y)
    y_sample = y_sample + case.sigma_y * randn(y_sample.shape, generator, device)

    return x_sample, c_sample, y_sample, z_sample
