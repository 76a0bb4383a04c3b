"""Decoders: Gaussian-head MLP decoder and the physics+NN additive fusion
(counterpart of dpivae_tpu/models/decoders.py:17-89)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dpivae_tpu_torch.models.nn import MLP, linear
from dpivae_tpu_torch.ops.fused_mlp import fused_mlp
from dpivae_tpu_torch.ops.gradrev import maybe_grad_reverse

# Hidden width of decoder_x's data-driven branch in the reference
# architecture; every default in this package reads it from here.
DECODER_X_HIDDEN = 128


class GaussianDecoder(MLP):
    """MLP whose output of width 2*n_output splits into (mean, log_sigma)."""

    def __init__(self, n_input: int, n_output: int, layers: Sequence[int],
                 generator: torch.Generator, device: torch.device):
        super().__init__([n_input, *layers, 2 * n_output], generator, device)
        self.n_output = n_output

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out = super().forward(z)
        return out[..., : self.n_output], out[..., self.n_output:]


class GradRevAdditiveDecoder(nn.Module):
    """The data-driven branch of the physics+NN additive fusion decoder,
    nz_d -> hidden -> n_output; the frozen physics beside it runs in
    ``DPIVAE.decode``, and the two predictions are summed by the caller."""

    def __init__(self, nz_d: int, n_output: int, generator: torch.Generator,
                 device: torch.device, hidden: int = DECODER_X_HIDDEN):
        super().__init__()
        self.fx0 = linear(nz_d, hidden, generator, device)
        self.fx1 = linear(hidden, n_output, generator, device)

    def forward(
        self,
        z_rev: torch.Tensor,
        grl_alpha: Optional[float] = None,
        use_pallas: bool = False,
    ) -> torch.Tensor:
        """xh_d, the data-driven prediction.

        Args:
            z_rev: data-driven latents (z_c || z_y), gradient-reversed when
                ``grl_alpha`` is not None.
            grl_alpha: GRL strength; None disables the adversarial branch.
            use_pallas: run the branch through ``fused_mlp`` (the CUDA
                kernel on the card) instead of two nn.Linear.
        """
        z_d = maybe_grad_reverse(z_rev, grl_alpha)
        if use_pallas:
            return fused_mlp(z_d, self.fx0.weight, self.fx0.bias,
                             self.fx1.weight, self.fx1.bias)
        return self.fx1(F.relu(self.fx0(z_d)))
