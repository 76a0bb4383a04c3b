"""Gaussian encoder heads and reparameterized sampling (counterpart of
dpivae_tpu/models/encoders.py:20-43,127-206).

The numeric clamps (±50 loc, [-7, 3] log-sigma, ±20 tril) and the 1e-8
diagonal jitter are load-bearing for training stability and equal the JAX
package's. The Conv1d trunk (encoders.py:55-125) is not ported yet.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dpivae_tpu_torch.models.nn import MLP, linear
from dpivae_tpu_torch.ops.mvn import mvn_sample_with_log_prob

JITTER = 1e-8


def _trunk_apply(trunk: MLP, x: torch.Tensor) -> torch.Tensor:
    # The reference trunk applies ReLU after *every* linear, the last too.
    h = x
    for layer in trunk.layers:
        h = F.relu(layer(h))
    return h


class FactorizedNN(nn.Module):
    """Diagonal-covariance Gaussian head: ReLU trunk + loc and log-sigma
    heads. ``forward(x) -> (loc, diag scale_tril)``."""

    def __init__(self, n_latent: int, n_input: int, layers: Sequence[int],
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        sizes = [n_input, *layers]
        self.n_latent = n_latent
        self.trunk = MLP(sizes, generator, device)
        self.f_mean = linear(sizes[-1], n_latent, generator, device)
        self.f_sigma = linear(sizes[-1], n_latent, generator, device)

    def _heads(self, x: torch.Tensor):
        h = _trunk_apply(self.trunk, x)
        loc = torch.clamp(self.f_mean(h), -50.0, 50.0)
        sigma = torch.exp(torch.clamp(self.f_sigma(h), -7.0, 3.0))
        return h, loc, torch.diag_embed(sigma + JITTER)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, loc, diag = self._heads(x)
        return loc, diag


class FullCovNN(FactorizedNN):
    """Full-covariance Gaussian head: the factorized head plus a
    strictly-lower-tril head. ``forward(x) -> (loc, scale_tril)``."""

    def __init__(self, n_latent: int, n_input: int, layers: Sequence[int],
                 generator: torch.Generator, device: torch.device):
        super().__init__(n_latent, n_input, layers, generator, device)
        self.f_cov = linear(self.f_mean.in_features, n_latent * n_latent,
                            generator, device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.n_latent
        h, loc, diag = self._heads(x)
        L = torch.clamp(self.f_cov(h), -20.0, 20.0)
        L = torch.tril(L.reshape(*x.shape[:-1], n, n), diagonal=-1)
        return loc, L + diag


def gaussian_encoder_sample(
    loc: torch.Tensor,
    scale_tril: torch.Tensor,
    n: int,
    *,
    generator: Optional[torch.Generator] = None,
    eps: Optional[torch.Tensor] = None,
    output_transform=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw n reparameterized samples and log q, applying the optional
    output squash with its change-of-variables correction.

    Returns (z, log q - log|det J|), z of shape (n, ..., n_latent).
    """
    z, log_q = mvn_sample_with_log_prob(
        loc, scale_tril, n, generator=generator, eps=eps
    )
    if output_transform is not None:
        z, log_det = output_transform.forward(z)
        log_q = log_q - log_det
    return z, log_q
