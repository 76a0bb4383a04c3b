"""Linear/MLP building blocks (counterpart of dpivae_tpu/models/nn.py:25-68).

Layers are ``torch.nn.Linear`` (weight layout (out, in)); their init equals
torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
as in the JAX package, but drawn from an explicit ``torch.Generator``
rather than the global RNG.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dpivae_tpu_torch.utils import rand


def _uniform(shape, bound: float, generator: torch.Generator, device):
    return (2.0 * rand(shape, generator, device) - 1.0) * bound


def linear(fan_in: int, fan_out: int, generator: torch.Generator,
           device: torch.device) -> nn.Linear:
    """A torch-default initialized ``nn.Linear`` drawn from ``generator``."""
    # Built on the meta device, so nn.Linear's own init never touches the
    # global RNG; the values come from the generator only.
    layer = nn.Linear(fan_in, fan_out, device="meta").to_empty(device=device)
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        layer.weight.copy_(_uniform((fan_out, fan_in), bound, generator, device))
        layer.bias.copy_(_uniform((fan_out,), bound, generator, device))
    return layer


class MLP(nn.Module):
    """Stack of dense layers, ``sizes`` = [in, hidden..., out]; ReLU between
    layers, none after the last."""

    def __init__(self, sizes: Sequence[int], generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.layers = nn.ModuleList(
            linear(sizes[i], sizes[i + 1], generator, device)
            for i in range(len(sizes) - 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.layers[:-1]:
            h = F.relu(layer(h))
        return self.layers[-1](h)
