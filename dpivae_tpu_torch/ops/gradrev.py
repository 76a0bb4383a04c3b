"""Gradient-reversal layer (counterpart of dpivae_tpu/ops/gradrev.py:20-45).

Identity in the forward pass, ``-alpha * g`` in the backward pass, so
gradients from the data-driven decoder branch push information out of
(z_c, z_y) whenever the physics branch can explain it.
"""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # The cotangent keeps the primal's dtype; the scale happens in the
        # promoted dtype, as in the JAX package.
        return (-g * ctx.alpha).to(g.dtype), None


def grad_reverse(x: torch.Tensor, alpha) -> torch.Tensor:
    """Identity forward; backward multiplies the gradient by ``-alpha``."""
    return _GradReverse.apply(x, alpha)


def maybe_grad_reverse(x: torch.Tensor, alpha) -> torch.Tensor:
    """Apply the GRL unless ``alpha`` is None (disabled branch)."""
    if alpha is None:
        return x
    return grad_reverse(x, alpha)
