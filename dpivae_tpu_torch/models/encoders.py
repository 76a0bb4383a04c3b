"""Gaussian encoder heads and reparameterized sampling (counterpart of
dpivae_tpu/models/encoders.py:20-206).

A head is a trunk, the dense ReLU stack (``FactorizedNN``, ``FullCovNN``)
or the Conv1d stack (``CNNEncoder``), then loc and log-sigma heads, and for
a full covariance a strictly-lower-tril head; ``gaussian_params`` turns the
heads' raw outputs into (loc, scale_tril). The numeric clamps (±50 loc,
[-7, 3] log-sigma, ±20 tril) and the 1e-8 diagonal jitter are load-bearing
for training stability and equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dpivae_tpu_torch.models.nn import MLP, Conv1dSame, linear
from dpivae_tpu_torch.ops.mvn import mvn_sample_with_log_prob

JITTER = 1e-8


class DenseTrunk(MLP):
    """The reference trunk: ReLU after *every* linear, the last too."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = F.relu(layer(h))
        return h


class CNNTrunk(nn.Module):
    """Conv/ReLU, Conv/ReLU, flatten, Linear/ReLU (counterpart of
    dpivae_tpu/models/encoders.py:81-91): the nd_x signal is a sequence of
    nd_x / ch_in positions of ch_in channels, flattened position-major
    (length, ch_out) as in the JAX package, so ``proj`` carries over."""

    def __init__(self, n_input: int, ch_in: int, ch_out: int, ch_latent: int,
                 kernel: int, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        if n_input % ch_in:
            raise ValueError(f"nd_x={n_input} not divisible by ch_in={ch_in}")
        self.ch_in = ch_in
        self.conv = nn.ModuleList([
            Conv1dSame(ch_in, ch_out, kernel, generator, device),
            Conv1dSame(ch_out, ch_out, kernel, generator, device),
        ])
        self.proj = linear(n_input // ch_in * ch_out, ch_latent, generator,
                           device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        h = x.reshape(-1, x.shape[-1] // self.ch_in, self.ch_in)
        for conv in self.conv:
            h = F.relu(conv(h))
        h = F.relu(self.proj(h.reshape(h.shape[0], -1)))
        return h.reshape(*lead, h.shape[-1])


class GaussianHead(nn.Module):
    """A trunk of output width ``width`` and the Gaussian heads.
    ``forward(x) -> (loc, scale_tril)``, the tril diagonal with
    ``full_cov=False``."""

    def __init__(self, n_latent: int, trunk: nn.Module, width: int,
                 full_cov: bool, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.n_latent = n_latent
        self.trunk = trunk
        self.f_mean = linear(width, n_latent, generator, device)
        self.f_sigma = linear(width, n_latent, generator, device)
        self.f_cov = (linear(width, n_latent * n_latent, generator, device)
                      if full_cov else None)

    def heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The heads' raw outputs (mean, log-sigma, tril or None), before
        ``gaussian_params``."""
        h = self.trunk(x)
        return (self.f_mean(h), self.f_sigma(h),
                None if self.f_cov is None else self.f_cov(h))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return gaussian_params(*self.heads(x))


def gaussian_params(mean: torch.Tensor, log_sigma: torch.Tensor,
                    cov: Optional[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loc, scale_tril) from a head's raw outputs: the clamps, the exp,
    the jitter and the strict-lower tril (the diagonal alone without
    ``cov``)."""
    loc = torch.clamp(mean, -50.0, 50.0)
    sigma = torch.exp(torch.clamp(log_sigma, -7.0, 3.0))
    diag = torch.diag_embed(sigma + JITTER)
    if cov is None:
        return loc, diag
    n = mean.shape[-1]
    L = torch.clamp(cov, -20.0, 20.0)
    L = torch.tril(L.reshape(*mean.shape[:-1], n, n), diagonal=-1)
    return loc, L + diag


class FactorizedNN(GaussianHead):
    """Diagonal-covariance head on a dense trunk."""

    def __init__(self, n_latent: int, n_input: int, layers: Sequence[int],
                 generator: torch.Generator, device: torch.device):
        sizes = [n_input, *layers]
        super().__init__(n_latent, DenseTrunk(sizes, generator, device),
                         sizes[-1], False, generator, device)


class FullCovNN(GaussianHead):
    """Full-covariance head on a dense trunk."""

    def __init__(self, n_latent: int, n_input: int, layers: Sequence[int],
                 generator: torch.Generator, device: torch.device):
        sizes = [n_input, *layers]
        super().__init__(n_latent, DenseTrunk(sizes, generator, device),
                         sizes[-1], True, generator, device)


class CNNEncoder(GaussianHead):
    """Full-covariance head on the Conv1d trunk (counterpart of
    dpivae_tpu/models/encoders.py:94-124): the heads and clamps of
    ``FullCovNN``."""

    def __init__(self, n_latent: int, n_input: int,
                 generator: torch.Generator, device: torch.device,
                 ch_in: int = 1, ch_out: int = 16, ch_latent: int = 64,
                 kernel: int = 3):
        trunk = CNNTrunk(n_input, ch_in, ch_out, ch_latent, kernel, generator,
                         device)
        super().__init__(n_latent, trunk, ch_latent, True, generator, device)


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
