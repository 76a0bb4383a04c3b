"""Linear/MLP/Conv1d building blocks (counterpart of
dpivae_tpu/models/nn.py:25-68 and the JAX package's Conv1d,
dpivae_tpu/models/encoders.py:55-78).

Dense layers are ``torch.nn.Linear`` (weight layout (out, in)); their init
equals torch's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and
bias, as in the JAX package, but drawn from an explicit
``torch.Generator`` rather than the global RNG.
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


class Conv1dSame(nn.Module):
    """Stride-1 1-D convolution with XLA's "SAME" zero padding over
    (batch, length, channels), the JAX package's NWC layout
    (counterpart of dpivae_tpu/models/encoders.py:55-78). The weight is in
    ``nn.Conv1d``'s layout (ch_out, ch_in, kernel), initialized as torch's
    default, U(-b, b) with b = 1/sqrt(ch_in * kernel), weight then bias.

    It is one matrix product over the taps, each position reading its
    ``kernel`` neighbours' channels, not a cuDNN convolution: cuDNN runs
    f32 convolutions in TF32 while ``torch.backends.cudnn.allow_tf32`` is
    on, as it is by default, whereas a matrix product follows
    ``torch.backends.cuda.matmul`` (full f32 by default) like every other
    layer of this package. Staying in NWC, the output flattens in the JAX
    package's feature order.
    """

    def __init__(self, ch_in: int, ch_out: int, kernel: int,
                 generator: torch.Generator, device: torch.device):
        super().__init__()
        bound = 1.0 / math.sqrt(ch_in * kernel)
        self.weight = nn.Parameter(
            _uniform((ch_out, ch_in, kernel), bound, generator, device))
        self.bias = nn.Parameter(_uniform((ch_out,), bound, generator, device))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        ch_out, ch_in, kernel = self.weight.shape
        length = h.shape[1]
        low = (kernel - 1) // 2  # XLA's SAME split, stride 1
        padded = F.pad(h, (0, 0, low, kernel - 1 - low))
        taps = torch.cat([padded[:, j:j + length] for j in range(kernel)],
                         dim=-1)  # (batch, length, kernel * ch_in)
        w = self.weight.permute(0, 2, 1).reshape(ch_out, kernel * ch_in)
        return F.linear(taps, w, self.bias)
