"""What ``remat_decode``'s recompute keeps alive (``ops/remat.py``).

On the CPU: the recompute's own activations are freed as its pullback
passes them, as plain autograd frees the activations it saved, under
autograd and under ``torch.func.vmap(grad)`` alike. A pullback that
retained its graph kept every recomputed activation alive until it
returned, so the recompute held at its deepest point what plain autograd
had already freed.

On the card (marker ``cuda``, skips without one): one single-run train
step at the JAX package's w1024_b1024_mc64 cell, in 8 MC chunks, peaks
lower with remat than without (``chip_smoke._remat_memory``).

    python -m pytest tests/test_torch_remat_memory.py --noconftest -q
"""

import weakref

import pytest
import torch

from dpivae_tpu_torch.ops.remat import recompute


def _layers(x, w1, w2, seen, refs):
    """x @ w1 -> tanh -> @ w2; when the gradient reaches the first
    product, ``seen`` records whether the tanh output was freed."""
    z1 = x @ w1
    h = torch.tanh(z1)
    refs.append(weakref.ref(h))
    if z1.requires_grad:
        z1.register_hook(lambda g: seen.append(refs[-1]() is None))
    return (h @ w2,)


@pytest.mark.parametrize("path", ["autograd", "recompute",
                                  "recompute_vmap_grad"])
def test_recomputed_activations_are_freed_during_the_backward(path):
    g = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(shape, generator=g)
                 for shape in ((64, 8), (8, 256), (256, 4)))
    seen, refs = [], []
    fn = lambda *a: _layers(*a, seen, refs)
    if path == "recompute_vmap_grad":
        loss = lambda x, w1, w2: recompute(fn, (x, w1, w2))[0].sum()
        grads = torch.func.vmap(torch.func.grad(loss, argnums=1),
                                in_dims=(0, None, None))(
            torch.stack([x, -x]), w1, w2)
        assert grads.shape == (2, 8, 256)
    else:
        w1.requires_grad_()
        run = fn if path == "autograd" else (
            lambda *a: recompute(fn, a))
        run(x, w1, w2)[0].sum().backward()
    assert seen == [True]


@pytest.mark.cuda
def test_remat_lowers_the_chunked_peak_at_the_jax_cell():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from dpivae_tpu_torch.ops import fused_mlp as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    chip_smoke._remat_memory(ops, failures, torch.cuda.get_device_name(0))
    assert failures == []
