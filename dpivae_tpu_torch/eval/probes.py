"""Disentanglement probes, batched on the device (counterpart of
dpivae_tpu/eval/probes.py).

Every (member, factor, latent block) probe trains at once: the probe
inputs are zero-padded to a common width and stacked on a probe axis.

- ``fit_linear_probes_batched``: least squares with an intercept through
  a pseudo-inverse (zero-padded columns get zero weight), as
  scikit-learn's ``LinearRegression``.
- ``fit_mlp_probes_sklearn``: ``MLPRegressor(hidden_layer_sizes=(128,
  128), max_iter=20000)`` per probe, as the JAX package's ``mlp`` probe
  (``eval/sklearn_mlp.py``: its init, shuffled epochs and tolerance stop,
  raw targets), every probe at once.
- ``fit_mlp_probes_batched``: the JAX package's batched ``mlp_jax`` probe,
  MLP(128, 128) trained with Adam, Glorot init, minibatches of 200 and L2
  alpha 1e-4 for a fixed epoch count, on per-probe standardized targets;
  the trainer is the batched MLP baseline's (``eval/baselines.py``), with
  the same ``generator`` / ``init`` / ``indices`` seam.

``make_probe_regressor`` names them as the JAX program does: "linear" and
"linear_jax" are the same exact least squares, "mlp" is scikit-learn's
fit and "mlp_jax" the batched one.

Scores are test-set R², as scikit-learn's ``score``. The JAX package's
``warm_batched_probes`` compiles its programs ahead of use; eager PyTorch
compiles nothing, so it has no counterpart here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.eval.baselines import (
    _as_f32,
    _mlp_apply,
    _pinv,
    mlp_draws,
    train_mlp_batched,
)
from dpivae_tpu_torch.eval.sklearn_mlp import fit_mlp_sklearn
from dpivae_tpu_torch.train.train import member_generators
from dpivae_tpu_torch.utils import DeviceLike, resolve_device

BLOCKS = ("zx", "zc", "zy")


def _r2(y_true, y_pred):
    ss_res = torch.sum((y_true - y_pred) ** 2, dim=-1)
    ss_tot = torch.sum((y_true - torch.mean(y_true, dim=-1, keepdim=True))
                       ** 2, dim=-1)
    return 1.0 - ss_res / ss_tot


def fit_linear_probes_batched(X_train, y_train, X_test, y_test):
    """Per-probe least squares with an intercept; test R² of shape (P,).

    Shapes: X_* (P, N, D) (zero-padded features allowed), y_* (P, N).
    """
    Xm = torch.mean(X_train, dim=1, keepdim=True)
    ym = torch.mean(y_train, dim=1, keepdim=True)
    coef = (_pinv(X_train - Xm) @ (y_train - ym)[:, :, None])[:, :, 0]
    pred = torch.einsum("pnd,pd->pn", X_test - Xm, coef) + ym
    return _r2(y_test, pred)


def fit_mlp_probes_batched(
    X_train,
    y_train,
    X_test,
    y_test,
    hidden: Tuple[int, ...] = (128, 128),
    lr: float = 1e-3,
    batch_size: int = 200,
    n_epochs: int = 300,
    alpha: float = 1e-4,
    generator: Optional[torch.Generator] = None,
    fan_in=None,
    init=None,
    indices=None,
):
    """Train all P probes at once; test R² of shape (P,).

    ``fan_in`` (P,): each probe's input width before the zero padding to
    D. scikit-learn's Glorot bound for the first layer uses the true
    width, so the first layer's initial weights scale by
    sqrt((D + h) / (fan_in + h)); only the init scale changes. Tensors on
    one device; ``generator``, ``init`` (the Glorot draws before that
    scaling) and ``indices`` as in ``eval.baselines.mlp_draws``.
    """
    P, N, D = X_train.shape
    init, indices = mlp_draws([D, *hidden, 1], P, N, batch_size, n_epochs,
                              generator, X_train.device, init, indices)
    if fan_in is not None:
        f = _as_f32(fan_in, X_train.device)
        scale = torch.sqrt((D + hidden[0]) / (f + hidden[0]))
        init[0] = (init[0][0] * scale[:, None, None], init[0][1])

    mu = torch.mean(y_train, dim=1, keepdim=True)
    sd = torch.std(y_train, dim=1, keepdim=True, correction=0) + 1e-12
    layers = train_mlp_batched(init, X_train, ((y_train - mu) / sd)[..., None],
                               indices, lr, alpha)
    with torch.no_grad():
        pred = _mlp_apply(layers, X_test)[..., 0] * sd + mu
        return _r2(y_test, pred)


def _pack(latents, z, n_factors: int, device):
    """One split's probes as (P, N, D) inputs and (P, N) targets."""
    d_max = max(int(latents[b].shape[-1]) for b in BLOCKS)
    padded = [torch.nn.functional.pad(
        _as_f32(latents[b], device), (0, d_max - int(latents[b].shape[-1])))
        for b in BLOCKS]
    x = torch.stack(padded, dim=1)  # (M, B, N, D)
    m, n_blocks, n, _ = x.shape
    x = x[:, None].expand(m, n_factors, n_blocks, n, d_max)
    y = torch.swapaxes(_as_f32(z, device), 1, 2)  # (M, F, N)
    y = y[:, :, None, :].expand(m, n_factors, n_blocks, n)
    p = m * n_factors * n_blocks
    return x.reshape(p, n, d_max), y.reshape(p, n)


def pack_probe_batch(latents_train, latents_test, z_train, z_test, n_factors,
                     device: DeviceLike = None):
    """Stack the (member, factor, block) probes into zero-padded (P, N, D)
    inputs and (P, N) targets on ``device`` (None means CUDA).

    ``latents_*`` map block name -> (M, N, d_block); ``z_*`` are (M, N,
    n_factors). Probe order is member-major, then factor, then block ("zx",
    "zc", "zy"): the reference's row order.
    """
    device = resolve_device(device)
    x_tr, y_tr = _pack(latents_train, z_train, n_factors, device)
    x_te, y_te = _pack(latents_test, z_test, n_factors, device)
    return x_tr, y_tr, x_te, y_te


def fit_mlp_probes_sklearn(X_train, y_train, X_test, y_test, *,
                           generator: Optional[torch.Generator] = None,
                           fan_in=None, max_iter: int = 20_000, init=None,
                           orders=None):
    """``MLPRegressor(hidden_layer_sizes=(128, 128), max_iter=max_iter)``
    per probe, every probe at once; its test R² (P,), as ``score`` gives
    it.

    Shapes: X_* (P, N, D) zero-padded to D, y_* (P, N); ``fan_in`` (P,)
    each probe's true input width. Probe p draws from its own generator,
    ``member_generators(seed, [p])`` with ``seed`` one draw from
    ``generator`` (default: seeded 0 on the data's device); ``init`` and
    ``orders`` replace the draws (``fit_mlp_sklearn``).
    """
    device = X_train.device
    gens = None
    if init is None or orders is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        seed = int(torch.randint(2 ** 62, (), generator=generator,
                                 device=generator.device))
        gens = member_generators(seed, range(X_train.shape[0]), device)
    fit = fit_mlp_sklearn(X_train, y_train[..., None], X_test, (128, 128),
                          max_iter, generators=gens, fan_in=fan_in,
                          init=init, orders=orders)
    return _r2(y_test, fit.pred[..., 0])


def make_probe_regressor(regressor: str):
    """The probe fit for ``regressor``, by the JAX program's names:
    "linear" and "linear_jax" (least squares, as scikit-learn's
    ``LinearRegression``), "mlp" (``fit_mlp_probes_sklearn``, as its
    ``MLPRegressor(128, 128)``) and "mlp_jax" (``fit_mlp_probes_batched``,
    a fixed epoch count), each ``(X_train, y_train, X_test, y_test, *,
    generator=None, fan_in=None, **kwargs) -> test R² (P,)``."""
    if regressor in ("linear", "linear_jax"):
        def fit_linear(X_tr, y_tr, X_te, y_te, *, generator=None, fan_in=None):
            return fit_linear_probes_batched(X_tr, y_tr, X_te, y_te)
        return fit_linear
    if regressor == "mlp":
        return fit_mlp_probes_sklearn
    if regressor == "mlp_jax":
        return fit_mlp_probes_batched
    raise ValueError(f"Unknown regressor {regressor!r}; have 'linear', "
                     f"'mlp', 'linear_jax' and 'mlp_jax'")


def batched_probe_scores(
    latents_train,
    latents_test,
    z_train,
    z_test,
    n_factors: int,
    regressor: str = "mlp_jax",
    generator: Optional[torch.Generator] = None,
    device: DeviceLike = None,
    **mlp_kwargs,
) -> np.ndarray:
    """All probes' test R² as (M, n_factors, 3), blocks in the order (zx,
    zc, zy); ``regressor`` a name of ``make_probe_regressor``."""
    fit = make_probe_regressor(regressor)
    X_tr, y_tr, X_te, y_te = pack_probe_batch(
        latents_train, latents_test, z_train, z_test, n_factors, device)
    m = int(z_train.shape[0])
    # Each probe's true input width, in probe order
    dims = [int(latents_train[b].shape[-1]) for b in BLOCKS]
    fan_in = np.tile(np.asarray(dims, np.float32), m * n_factors)
    r2 = fit(X_tr, y_tr, X_te, y_te, generator=generator, fan_in=fan_in,
             **mlp_kwargs)
    return r2.cpu().numpy().reshape(m, n_factors, len(BLOCKS))
