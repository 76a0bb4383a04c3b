"""Gradient-reversal layer (counterpart of dpivae_tpu/ops/gradrev.py:20-45).

Identity in the forward pass, ``-alpha * g`` in the backward pass, so
gradients from the data-driven decoder branch push information out of
(z_c, z_y) whenever the physics branch can explain it.

``alpha`` is a Python float (a single run) or a tensor, so that under
``torch.func.vmap`` each sweep member carries its own λ. The Function is
in ``setup_context`` form with a generated vmap rule, as ``torch.func``
requires; its body is plain tensor arithmetic.
"""

from __future__ import annotations

import torch


class _GradReverse(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, alpha):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, alpha = inputs
        if isinstance(alpha, torch.Tensor):
            ctx.save_for_backward(alpha)
            ctx.alpha = None
        else:
            ctx.alpha = alpha

    @staticmethod
    def backward(ctx, g):
        alpha = ctx.saved_tensors[0] if ctx.alpha is None else ctx.alpha
        # The cotangent keeps the primal's dtype; the scale happens in the
        # promoted dtype, as in the JAX package.
        return (-g * alpha).to(g.dtype), None


def grad_reverse(x: torch.Tensor, alpha) -> torch.Tensor:
    """Identity forward; backward multiplies the gradient by ``-alpha``."""
    return _GradReverse.apply(x, alpha)


def maybe_grad_reverse(x: torch.Tensor, alpha) -> torch.Tensor:
    """Apply the GRL unless ``alpha`` is None (disabled branch)."""
    if alpha is None:
        return x
    return grad_reverse(x, alpha)
