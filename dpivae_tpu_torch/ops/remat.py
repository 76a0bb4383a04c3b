"""Recompute in the backward, composable with ``torch.func`` (counterpart of
``jax.checkpoint`` as dpivae_tpu/models/vae.py:258-260 applies it to the
decode).

``recompute(fn, inputs, consts)`` returns ``fn(*inputs, *consts)`` (a
tuple of tensors) computed without keeping any activation: the forward
runs ``fn`` under ``torch.no_grad()`` and saves only its inputs, and the
backward runs ``fn`` again under ``torch.func.vjp`` and pulls the output
cotangents back to ``inputs``. ``consts`` take no gradient (a GRL
strength, which a sweep passes per member as a tensor).

``torch.utils.checkpoint`` does the same for plain autograd through
saved-tensor hooks, which ``torch.func.grad`` refuses. This is a
``torch.autograd.Function`` in ``setup_context`` form with a generated
vmap rule, the form that composes with ``vmap(grad(...))``: under
``vmap`` the forward and the recompute run batched, so the custom
Functions inside ``fn`` (the fused-MLP kernels' and the GRL's) take their
own vmap rules there, and a member-batched step launches the forward
kernel twice (the forward, then the recompute) and the hidden kernel once.
``fn`` must draw no random numbers: no RNG state is kept for the
recompute.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


class _Recompute(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, n_inputs, *tensors):
        with torch.no_grad():
            return tuple(fn(*tensors))

    @staticmethod
    def setup_context(ctx, inputs, output):
        fn, n_inputs, *tensors = inputs
        ctx.fn, ctx.n_inputs = fn, n_inputs
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        n = ctx.n_inputs
        consts = tensors[n:]
        _, pullback = torch.func.vjp(lambda *a: tuple(ctx.fn(*a, *consts)),
                                     *tensors[:n])
        return (None, None, *pullback(grads), *(None for _ in consts))


def recompute(fn: Callable[..., Sequence[torch.Tensor]],
              inputs: Sequence[torch.Tensor],
              consts: Sequence[torch.Tensor] = ()) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs, *consts)``, its activations recomputed in the
    backward instead of kept (module docstring)."""
    return _Recompute.apply(fn, len(inputs), *inputs, *consts)
