"""scikit-learn's ``MLPRegressor`` fit, member-batched on one device
(counterpart of the ``MLPRegressor`` fits of dpivae_tpu/eval/evaluate.py:106
and :148).

``fit_mlp_sklearn`` fits M independent regressors at once, each as
``MLPRegressor`` fits it with its defaults (solver "adam", ReLU, batch_size
"auto", shuffle, no early stopping), in the dtype of its inputs
(sklearn/neural_network/_multilayer_perceptron.py and
_stochastic_optimizers.py, version 1.9):

- Init: per layer, weights and then intercepts uniform in
  ±sqrt(6 / (fan_in + fan_out)). With ``fan_in`` (the probes' zero-padded
  inputs), a member's first layer is drawn at its true width and its
  padded input rows start at zero; they stay zero, since their data
  gradient, their L2 gradient and so their Adam update are all zero.
- Epochs: a fresh order of the rows per member, without replacement, cut
  into batches of min(200, N) in order, the last one short.
- Gradient: that of 0.5 * sum((pred - y)^2) / n_b + 0.5 * alpha *
  sum(W^2) / n_b. The batch loss reported averages the squared error over
  the outputs as well, 0.5 * mean((pred - y)^2) + 0.5 * alpha * sum(W^2) /
  n_b; the two differ where there are several outputs, as in
  scikit-learn.
- Adam, t counted in minibatch steps: p -= lr * sqrt(1 - b2^t) / (1 -
  b1^t) * m / (sqrt(v) + eps).
- Stop: the epoch loss is sum(batch loss * n_b) / N. After each epoch the
  count of epochs without improvement goes up by one where loss > best -
  tol, else back to 0; best = min(best, loss); the member stops once the
  count exceeds n_iter_no_change, or at max_iter. A member that stopped
  stays frozen while the others train on; the host reads whether any
  member is still active every ``_BLOCK`` epochs. A member whose loss is
  not finite stops too (scikit-learn raises on its non-finite weights at
  the end of such a fit).

Each member draws its initial weights and its epoch orders from its own
``torch.Generator``, so its fit does not depend on the members beside it.
``init`` and ``orders`` replace the draws: the seam through which tests
replay scikit-learn's own draws from its ``random_state``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from dpivae_tpu_torch.train.train import member_generators

# Epochs between host reads of "any member still active", and the epochs
# whose row orders each member draws at once.
_BLOCK = 10
# MLPRegressor's defaults
_ALPHA = 1e-4
_LR = 1e-3
_BATCH = 200
_TOL = 1e-4
_N_ITER_NO_CHANGE = 10
_BETA_1, _BETA_2, _EPSILON = 0.9, 0.999, 1e-8


class MLPFit(NamedTuple):
    """A member-batched fit: test predictions (M, T, Q), the trained layers
    [(W (M, in, out), b (M, out)), ...], each member's epoch count
    (scikit-learn's ``n_iter_``, (M,) int64) and its loss curve (M, E),
    NaN past its own epochs."""

    pred: torch.Tensor
    layers: List[Tuple[torch.Tensor, torch.Tensor]]
    n_iter: torch.Tensor
    loss_curve: torch.Tensor


def _uniform(shape, bound: float, generator: torch.Generator, dtype, device):
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return ((2.0 * u - 1.0) * bound).to(device)


def _draw_init(sizes, fan_in, generators, dtype, device):
    """Each member's layers from its generator (module docstring)."""
    layers = []
    for layer, (d_in, d_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        ws, bs = [], []
        for m, g in enumerate(generators):
            f = int(fan_in[m]) if layer == 0 and fan_in is not None else d_in
            bound = math.sqrt(6.0 / (f + d_out))
            w = _uniform((f, d_out), bound, g, dtype, device)
            ws.append(torch.nn.functional.pad(w, (0, 0, 0, d_in - f)))
            bs.append(_uniform((d_out,), bound, g, dtype, device))
        layers.append((torch.stack(ws), torch.stack(bs)))
    return layers


def _draw_orders(generators, n_epochs: int, n_rows: int, device):
    """(M, n_epochs, N) row orders, each a uniform permutation: the
    argsort of float64 uniforms drawn from each member's generator."""
    keys = torch.stack([
        torch.rand((n_epochs, n_rows), generator=g, dtype=torch.float64,
                   device=g.device).to(device) for g in generators])
    return torch.argsort(keys, dim=-1)


def _forward(layers, x):
    """Every layer's activations: ReLU hidden layers, identity output."""
    acts = [x]
    for i, (w, b) in enumerate(layers):
        z = torch.bmm(acts[-1], w) + b[:, None, :]
        acts.append(torch.relu(z) if i < len(layers) - 1 else z)
    return acts


def _backprop(layers, xb, yb):
    """The batch loss per member (M,) and the gradients of every W and b,
    flattened per member in the order W0, b0, W1, b1, ... (M, P)."""
    n_b = xb.shape[1]
    acts = _forward(layers, xb)
    diff = acts[-1] - yb
    loss = 0.5 * torch.mean(torch.mean(diff * diff, dim=1), dim=1)
    l2 = sum(torch.sum(w * w, dim=(1, 2)) for w, _ in layers)
    loss = loss + (0.5 * _ALPHA) * l2 / n_b
    grads = [None] * (2 * len(layers))
    delta = diff
    for i in range(len(layers) - 1, -1, -1):
        w = layers[i][0]
        gw = torch.bmm(acts[i].transpose(1, 2), delta)
        grads[2 * i] = (gw + _ALPHA * w) / n_b
        grads[2 * i + 1] = torch.sum(delta, dim=1) / n_b
        if i:
            delta = torch.bmm(delta, w.transpose(1, 2))
            delta = torch.where(acts[i] == 0, torch.zeros_like(delta), delta)
    m = xb.shape[0]
    return loss, torch.cat([g.reshape(m, -1) for g in grads], dim=1)


@torch.no_grad()
def fit_mlp_sklearn(
    X_tr: torch.Tensor,
    Y_tr: torch.Tensor,
    X_te: torch.Tensor,
    hidden: Sequence[int] = (100,),
    max_iter: int = 200,
    *,
    generators: Optional[Sequence[torch.Generator]] = None,
    fan_in=None,
    init=None,
    orders=None,
) -> MLPFit:
    """M ``MLPRegressor(hidden_layer_sizes=hidden, max_iter=max_iter)``
    fits at once (module docstring), in the dtype of ``X_tr``.

    Shapes: X_tr (M, N, D), Y_tr (M, N, Q), X_te (M, T, D), on one device.
    ``generators``: one per member (default: ``member_generators(0,
    range(M))`` on the data's device). ``fan_in`` (M,): each member's true
    input width where the inputs are zero-padded to D. ``init`` replaces
    the initial layers [(W (M, in, out), b (M, out)), ...]; ``orders``
    replaces the epoch orders, (M, E, N) row indices with E at least the
    epochs the fit runs.
    """
    M, N, D = X_tr.shape
    dtype, device = X_tr.dtype, X_tr.device
    Y_tr = Y_tr.to(dtype)
    sizes = [D, *hidden, Y_tr.shape[-1]]
    if generators is None and (init is None or orders is None):
        generators = member_generators(0, range(M), device)
    if generators is not None and len(generators) != M:
        raise ValueError(f"{len(generators)} generators for {M} members")
    if init is None:
        init = _draw_init(sizes, fan_in, generators, dtype, device)
    if orders is not None:
        orders = torch.as_tensor(orders, device=device).long()

    # One flat buffer per member holds W0, b0, W1, b1, ...: the layers are
    # views of it, so Adam and the freezing of stopped members each take a
    # few whole-buffer ops.
    flat = torch.cat([torch.as_tensor(t, dtype=dtype, device=device)
                      .reshape(M, -1) for layer in init for t in layer], dim=1)
    layers, start = [], 0
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        w = flat[:, start:start + d_in * d_out].view(M, d_in, d_out)
        start += d_in * d_out
        b = flat[:, start:start + d_out]
        start += d_out
        layers.append((w, b))
    m_state = torch.zeros_like(flat)
    v_state = torch.zeros_like(flat)

    b_size = min(_BATCH, N)
    batches = [(s, min(s + b_size, N)) for s in range(0, N, b_size)]
    members = torch.arange(M, device=device)[:, None]
    active = torch.ones(M, dtype=torch.bool, device=device)
    n_iter = torch.zeros(M, dtype=torch.int64, device=device)
    count = torch.zeros(M, dtype=torch.int64, device=device)
    best = torch.full((M,), math.inf, dtype=dtype, device=device)
    curves = []
    t = epoch = 0
    while epoch < max_iter:
        n_block = min(_BLOCK, max_iter - epoch)
        if orders is None:
            block = _draw_orders(generators, n_block, N, device)
        elif orders.shape[1] < epoch + n_block:
            raise ValueError(f"orders hold {orders.shape[1]} epochs; the "
                             f"fit needs {epoch + n_block}")
        else:
            block = orders[:, epoch:epoch + n_block]
        for k in range(n_block):
            acc = torch.zeros(M, dtype=dtype, device=device)
            for s, e in batches:
                rows = block[:, k, s:e]
                loss, g = _backprop(layers, X_tr[members, rows],
                                    Y_tr[members, rows])
                acc = acc + loss * (e - s)
                t += 1
                lr_t = (_LR * math.sqrt(1.0 - _BETA_2 ** t)
                        / (1.0 - _BETA_1 ** t))
                m_new = _BETA_1 * m_state + (1.0 - _BETA_1) * g
                v_new = _BETA_2 * v_state + (1.0 - _BETA_2) * (g * g)
                step = (-lr_t * m_new) / (torch.sqrt(v_new) + _EPSILON)
                live = active[:, None]
                flat.copy_(torch.where(live, flat + step, flat))
                m_state = torch.where(live, m_new, m_state)
                v_state = torch.where(live, v_new, v_state)
            loss = acc / N
            n_iter = n_iter + active
            curves.append(torch.where(active, loss,
                                      torch.full_like(loss, math.nan)))
            worse = loss > best - _TOL
            count = torch.where(active, torch.where(
                worse, count + 1, torch.zeros_like(count)), count)
            best = torch.where(active & (loss < best), loss, best)
            active = (active & (count <= _N_ITER_NO_CHANGE)
                      & torch.isfinite(loss))
        epoch += n_block
        if not bool(active.any()):
            break
    pred = _forward(layers, X_te.to(dtype))[-1]
    return MLPFit(pred, [(w.clone(), b.clone()) for w, b in layers], n_iter,
                  torch.stack(curves, dim=1))
