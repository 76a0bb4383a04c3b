"""Comparison baselines LIN, GPR and MLP, batched over members on the device
(counterpart of dpivae_tpu/eval/baselines.py).

Each family fits every member at once, in f32 on one device:

- ``fit_lin_batched``: centered least squares with an intercept, through
  a pseudo-inverse with the JAX package's cutoff (singular values below
  10 * max(N, D) * eps of the largest are dropped).
- ``fit_gpr_batched``: exact GP regression with the kernel RBF(1) +
  WhiteKernel(1); (log length_scale, log noise) maximize the marginal
  likelihood, summed over output dims, from (0, 0) by BFGS, clipped into
  the log-bounds [log 1e-5, log 1e5], with a jitter of 1e-6 on the
  diagonal. torch has no ``jax.scipy.optimize.minimize``: ``_bfgs`` and
  ``_line_search`` follow the JAX implementation (identity initial
  inverse Hessian, a strong-Wolfe line search with its zoom, gtol 1e-5 on
  the inf-norm, 200 iterations), batched over members with masks, each
  member's state frozen once its own loop would have ended. A failed
  Cholesky factorisation (``cholesky_ex``) makes the objective and its
  gradient NaN, as in JAX, and a member whose optimum is not finite or no
  better than the start falls back to the start.
- ``fit_gpr_lbfgsb``: the same GPR fitted as scikit-learn's
  ``GaussianProcessRegressor(RBF() + WhiteKernel())`` fits it, one member
  at a time: float64, scikit-learn's alpha of 1e-10 on the diagonal, and
  scipy's L-BFGS-B within the log-bounds from (0, 0), the marginal
  likelihood and its gradient (autograd) on the device. ``run_comparison``
  uses it; the batched fit misses scikit-learn's optimum on folds where
  the clamped float32 BFGS stops early.
- ``fit_mlp_baseline_batched``: MLP(64, 64) with ReLU, Glorot-uniform init,
  Adam (optax's update), minibatches of 200 drawn with replacement and
  shared by the members, L2 alpha 1e-4, a fixed epoch count; targets are
  standardized per member and mapped back.

The MLP draws its initial weights and minibatch rows from an explicit
``torch.Generator``; ``init`` and ``indices`` hand in ready-made ones (the
seam through which tests give it the JAX package's draws).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dpivae_tpu_torch.utils import DeviceLike, resolve_device
from dpivae_tpu_torch.utils.metrics import regression_metrics

# The kernel's log-bounds, scikit-learn's (1e-5, 1e5) for RBF and
# WhiteKernel; the objective clips into them.
_LOG_LB = math.log(1e-5)
_LOG_UB = math.log(1e5)
# scikit-learn's alpha=1e-10 jitter, raised to be safe in f32
_JITTER = 1e-6
_SKLEARN_ALPHA = 1e-10
_GTOL = 1e-5
_BFGS_MAXITER = 200
_LINE_SEARCH_MAXITER = 10
_ZOOM_MAXITER = 30


def _as_f32(a, device) -> torch.Tensor:
    """A tensor, or an array (copied), as f32 on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _standardize_features(x_tr, c_tr, x, c):
    """[x ‖ c] standardized by each member's train moments (ddof 0): the
    feature map of ``run_comparison``. Member-stacked (M, N, d)."""

    def scale(train, a):
        mu = torch.mean(train, dim=1, keepdim=True)
        sd = torch.std(train, dim=1, keepdim=True, correction=0)
        return (a - mu) / sd

    return torch.cat((scale(x_tr, x), scale(c_tr, c)), dim=-1)


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """Batched pseudo-inverse with the JAX package's default cutoff."""
    m, n = a.shape[-2:]
    return torch.linalg.pinv(a, rtol=10.0 * max(m, n)
                             * torch.finfo(a.dtype).eps)


# ---------------------------------------------------------------------------
# LIN


def fit_lin_batched(X_tr, Y_tr, X_te):
    """Multi-output least squares with an intercept, per member.

    Shapes: X_tr (M, N, D), Y_tr (M, N, Q), X_te (M, T, D) -> (M, T, Q).
    """
    Xm = torch.mean(X_tr, dim=1, keepdim=True)
    Ym = torch.mean(Y_tr, dim=1, keepdim=True)
    coef = _pinv(X_tr - Xm) @ (Y_tr - Ym)  # (M, D, Q)
    return (X_te - Xm) @ coef + Ym


# ---------------------------------------------------------------------------
# GPR


def _sqdist(a, b):
    # (M, N, D), (M, T, D) -> (M, N, T); the clamp guards tiny negative
    # round-off.
    d = (torch.sum(a * a, -1)[:, :, None] + torch.sum(b * b, -1)[:, None, :]
         - 2.0 * a @ b.transpose(1, 2))
    return torch.clamp(d, min=0.0)


def _gpr_factor(theta, X):
    """Cholesky factor of the kernel matrix at (clipped) ``theta``, and
    whether the factorisation succeeded, per member."""
    ls, noise = torch.exp(theta[:, 0]), torch.exp(theta[:, 1])
    n = X.shape[1]
    K = torch.exp(-0.5 * _sqdist(X, X) / (ls * ls)[:, None, None])
    K = K + (noise + _JITTER)[:, None, None] * torch.eye(
        n, dtype=X.dtype, device=X.device)
    L, info = torch.linalg.cholesky_ex(K)
    return L, info == 0


def _gpr_nlml(theta, X, Y):
    """Negative log marginal likelihood per member, summed over the output
    dims; NaN where the factorisation failed."""
    theta = torch.clamp(theta, _LOG_LB, _LOG_UB)
    L, ok = _gpr_factor(theta, X)
    alpha = torch.cholesky_solve(Y, L)
    n, q = Y.shape[1], Y.shape[2]
    lml = (-0.5 * torch.sum(Y * alpha, dim=(1, 2))
           - q * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)), -1)
           - 0.5 * n * q * math.log(2.0 * math.pi))
    return torch.where(ok, -lml, torch.full_like(lml, float("nan")))


def _value_and_grad(fun):
    """(f, df/dtheta) per member of a member-batched objective; both NaN
    where f is not finite, as jax.value_and_grad gives through a failed
    factorisation."""

    def fg(theta):
        with torch.enable_grad():
            t = theta.detach().requires_grad_()
            f = fun(t)
            (g,) = torch.autograd.grad(torch.nansum(f), t)
        bad = ~torch.isfinite(f)
        g = torch.where(bad[:, None], torch.full_like(g, float("nan")), g)
        return f.detach(), g

    return fg


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _pick(mask, new, old):
    """``new`` where ``mask`` (per member) is set, else ``old``."""
    return torch.where(mask.reshape(-1, *([1] * (old.dim() - 1))), new, old)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    d2_0 = fb - fa - C * db
    d2_1 = fc - fa - C * dc
    A = (dc ** 2 * d2_0 - db ** 2 * d2_1) / denom
    B = (-dc ** 3 * d2_0 + db ** 3 * d2_1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


def _zoom(phi_fn, wolfe_one, wolfe_two, a_lo, phi_lo, dphi_lo, a_hi, phi_hi,
          dphi_hi, g_0, skip):
    """Zoom of the strong-Wolfe line search (Nocedal and Wright, algorithm
    3.6), as jax/_src/scipy/optimize/line_search.py ``_zoom``: cubic, then
    quadratic, then bisection steps. Members in ``skip`` pass through.
    Returns (failed, a_star, phi_star, dphi_star, g_star)."""
    s = dict(done=torch.zeros_like(skip), failed=torch.zeros_like(skip),
             a_lo=a_lo, phi_lo=phi_lo, dphi_lo=dphi_lo, a_hi=a_hi,
             phi_hi=phi_hi, dphi_hi=dphi_hi, a_rec=(a_lo + a_hi) / 2.0,
             phi_rec=(phi_lo + phi_hi) / 2.0,
             a_star=torch.ones_like(a_lo), phi_star=phi_lo,
             dphi_star=dphi_lo, g_star=g_0)
    for j in range(_ZOOM_MAXITER):
        live = ~s["done"] & ~skip & ~s["failed"]
        if not bool(live.any()):
            break
        n = dict(s)
        dalpha = s["a_hi"] - s["a_lo"]
        lo = torch.minimum(s["a_hi"], s["a_lo"])
        hi = torch.maximum(s["a_hi"], s["a_lo"])
        cchk, qchk = 0.2 * dalpha, 0.1 * dalpha
        n["failed"] = s["failed"] | (dalpha <= 1e-5)
        a_cubic = _cubicmin(s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"],
                            s["phi_hi"], s["a_rec"], s["phi_rec"])
        use_cubic = (j > 0) & (a_cubic > lo + cchk) & (a_cubic < hi - cchk)
        a_quad = _quadmin(s["a_lo"], s["phi_lo"], s["dphi_lo"], s["a_hi"],
                          s["phi_hi"])
        use_quad = ~use_cubic & (a_quad > lo + qchk) & (a_quad < hi - qchk)
        use_bisection = ~use_cubic & ~use_quad
        a_j = torch.where(use_cubic, a_cubic, s["a_rec"])
        a_j = torch.where(use_quad, a_quad, a_j)
        a_j = torch.where(use_bisection, (s["a_lo"] + s["a_hi"]) / 2.0, a_j)
        phi_j, dphi_j, g_j = phi_fn(a_j)

        hi_to_j = wolfe_one(a_j, phi_j) | (phi_j >= s["phi_lo"])
        star_to_j = wolfe_two(dphi_j) & ~hi_to_j
        hi_to_lo = ((dphi_j * (s["a_hi"] - s["a_lo"]) >= 0.0) & ~hi_to_j
                    & ~star_to_j)
        lo_to_j = ~hi_to_j & ~star_to_j
        # The updates in JAX's order; each mask excludes the ones before
        # it where they would overlap.
        for key, val in (("a_hi", a_j), ("phi_hi", phi_j),
                         ("dphi_hi", dphi_j), ("a_rec", s["a_hi"]),
                         ("phi_rec", s["phi_hi"])):
            n[key] = _pick(hi_to_j, val, n[key])
        n["done"] = star_to_j | s["done"]
        for key, val in (("a_star", a_j), ("phi_star", phi_j),
                         ("dphi_star", dphi_j), ("g_star", g_j)):
            n[key] = _pick(star_to_j, val, n[key])
        for key, val in (("a_hi", s["a_lo"]), ("phi_hi", s["phi_lo"]),
                         ("dphi_hi", s["dphi_lo"]), ("a_rec", s["a_hi"]),
                         ("phi_rec", s["phi_hi"])):
            n[key] = _pick(hi_to_lo, val, n[key])
        for key, val in (("a_rec", s["a_lo"]), ("phi_rec", s["phi_lo"])):
            n[key] = _pick(lo_to_j & ~hi_to_lo, val, n[key])
        for key, val in (("a_lo", a_j), ("phi_lo", phi_j),
                         ("dphi_lo", dphi_j)):
            n[key] = _pick(lo_to_j, val, n[key])
        n["failed"] = n["failed"] | (j + 1 >= _ZOOM_MAXITER)
        s = {key: _pick(live, n[key], s[key]) for key in s}
    return (s["failed"], s["a_star"], s["phi_star"], s["dphi_star"],
            s["g_star"])


def _line_search(fg, xk, pk, phi_0, old_old_fval, gfk, live, c1=1e-4,
                 c2=0.9):
    """Strong-Wolfe line search (Nocedal and Wright, algorithm 3.5), as
    jax/_src/scipy/optimize/line_search.py ``line_search``, for the members
    in ``live``. Returns (failed, a_k, f_k, g_k)."""

    def phi_fn(a):
        phi, g = fg(xk + a[:, None] * pk)
        return phi, _dot(g, pk), g

    dphi_0 = _dot(gfk, pk)
    candidate = 1.01 * 2.0 * (phi_0 - old_old_fval) / dphi_0
    start = torch.where(candidate > 1, torch.ones_like(candidate), candidate)
    wolfe_one = lambda a_i, phi_i: phi_i > phi_0 + c1 * a_i * dphi_0
    wolfe_two = lambda dphi_i: torch.abs(dphi_i) <= -c2 * dphi_0

    zeros = torch.zeros_like(phi_0)
    s = dict(done=~live, failed=torch.zeros_like(live), a_i1=zeros,
             phi_i1=phi_0, dphi_i1=dphi_0, a_star=zeros, phi_star=phi_0,
             dphi_star=dphi_0, g_star=gfk)
    for i in range(1, _LINE_SEARCH_MAXITER + 1):
        active = ~s["done"] & ~s["failed"]
        if not bool(active.any()):
            break
        n = dict(s)
        a_i = start if i == 1 else s["a_i1"] * 2.0
        phi_i, dphi_i, g_i = phi_fn(a_i)
        to_zoom1 = wolfe_one(a_i, phi_i) | ((phi_i >= s["phi_i1"]) & (i > 1))
        to_i = wolfe_two(dphi_i) & ~to_zoom1
        to_zoom2 = (dphi_i >= 0.0) & ~to_zoom1 & ~to_i
        zoom1 = _zoom(phi_fn, wolfe_one, wolfe_two, s["a_i1"], s["phi_i1"],
                      s["dphi_i1"], a_i, phi_i, dphi_i, gfk,
                      ~(to_zoom1 & active))
        zoom2 = _zoom(phi_fn, wolfe_one, wolfe_two, a_i, phi_i, dphi_i,
                      s["a_i1"], s["phi_i1"], s["dphi_i1"], gfk,
                      ~(to_zoom2 & active))
        # The three outcomes in JAX's order: zoom in (a_i1, a_i), take
        # a_i, zoom in (a_i, a_i1)
        for mask, failed, star in (
                (to_zoom1, zoom1[0], zoom1[1:]),
                (to_i, None, (a_i, phi_i, dphi_i, g_i)),
                (to_zoom2, zoom2[0], zoom2[1:])):
            n["done"] = mask | n["done"]
            if failed is not None:
                n["failed"] = (mask & failed) | n["failed"]
            for key, val in zip(("a_star", "phi_star", "dphi_star",
                                 "g_star"), star):
                n[key] = _pick(mask, val, n[key])
        n["a_i1"], n["phi_i1"], n["dphi_i1"] = a_i, phi_i, dphi_i
        s = {key: _pick(active, n[key], s[key]) for key in s}

    failed = s["failed"] | ~s["done"]
    # JAX's floor on tiny steps in less than 64-bit precision
    a_k = s["a_star"]
    a_k = torch.where(torch.abs(a_k) < 1e-8, torch.sign(a_k) * 1e-8, a_k)
    return failed, a_k, s["phi_star"], s["g_star"]


def _bfgs(fun, x0, maxiter: int = _BFGS_MAXITER):
    """BFGS (Nocedal and Wright, algorithm 6.1) of a member-batched
    objective from ``x0`` (M, d), as jax/_src/scipy/optimize/bfgs.py
    ``minimize_bfgs``. Returns (x, f) per member."""
    fg = _value_and_grad(fun)
    m, d = x0.shape
    eye = torch.eye(d, dtype=x0.dtype, device=x0.device)
    f_0, g_0 = fg(x0)
    s = dict(converged=torch.amax(torch.abs(g_0), -1) < _GTOL,
             failed=torch.zeros(m, dtype=torch.bool, device=x0.device),
             x=x0, f=f_0, g=g_0, H=eye.expand(m, d, d).clone(),
             old_old_fval=f_0 + torch.linalg.vector_norm(g_0, dim=-1) / 2)
    for _ in range(maxiter):
        live = ~s["converged"] & ~s["failed"]
        if not bool(live.any()):
            break
        p = -(s["H"] @ s["g"][:, :, None])[:, :, 0]
        failed, a_k, f_1, g_1 = _line_search(fg, s["x"], p, s["f"],
                                             s["old_old_fval"], s["g"], live)
        step = a_k[:, None] * p
        y = g_1 - s["g"]
        rho = 1.0 / _dot(y, step)
        w = eye - rho[:, None, None] * step[:, :, None] * y[:, None, :]
        H_1 = (w @ s["H"] @ w.transpose(1, 2)
               + rho[:, None, None] * step[:, :, None] * step[:, None, :])
        H_1 = _pick(torch.isfinite(rho), H_1, s["H"])
        n = dict(converged=torch.amax(torch.abs(g_1), -1) < _GTOL,
                 failed=failed, x=s["x"] + step, f=f_1, g=g_1, H=H_1,
                 old_old_fval=s["f"])
        s = {key: _pick(live, n[key], s[key]) for key in s}
    return s["x"], s["f"]


def _gpr_fit(X, Y):
    """The optimum (log length_scale, log noise) per member, from
    scikit-learn's start (1, 1); a member whose optimum is not finite, or
    is no better than the start, keeps the start."""
    theta0 = torch.zeros((X.shape[0], 2), dtype=X.dtype, device=X.device)
    fun = lambda t: _gpr_nlml(t, X, Y)
    x, f = _bfgs(fun, theta0)
    theta = torch.where(torch.isfinite(x), x, theta0)
    better = torch.isfinite(f) & (f < fun(theta0))
    theta = _pick(better, theta, theta0)
    return torch.clamp(theta, _LOG_LB, _LOG_UB)


def fit_gpr_batched(X_tr, Y_tr, X_te):
    """Exact GPR(RBF + White) fit and predict, per member.

    Shapes: X_tr (M, N, D), Y_tr (M, N, Q), X_te (M, T, D) -> predictions
    (M, T, Q) and the kernel parameters (M, 2) as (length_scale,
    noise_level)."""
    with torch.no_grad():
        theta = _gpr_fit(X_tr, Y_tr)
        L, ok = _gpr_factor(theta, X_tr)
        alpha = torch.cholesky_solve(Y_tr, L)
        ls = torch.exp(theta[:, 0])
        # WhiteKernel adds nothing off the diagonal: the cross-covariance
        # is the RBF alone, scikit-learn's K_trans @ alpha_.
        Ks = torch.exp(-0.5 * _sqdist(X_te, X_tr) / (ls * ls)[:, None, None])
        pred = Ks @ alpha
        pred = _pick(ok, pred, torch.full_like(pred, float("nan")))
    return pred, torch.exp(theta)


def fit_gpr_lbfgsb(X_tr, Y_tr, X_te):
    """GPR(RBF + White) fit and predict per member as scikit-learn fits it
    (float64, alpha 1e-10, L-BFGS-B within the log-bounds), one member at
    a time; the objective runs on the tensors' device.

    Shapes: X_tr (M, N, D), Y_tr (M, N, Q), X_te (M, T, D) -> float64
    predictions (M, T, Q) and the kernel parameters (M, 2) as
    (length_scale, noise_level). Raises, as scikit-learn does, if the
    fitted kernel matrix is not positive definite."""
    from scipy.optimize import minimize

    preds, kparams = [], []
    for X, Y, Xs in zip(*(a.to(torch.float64) for a in (X_tr, Y_tr, X_te))):
        n, q = Y.shape
        eye = torch.eye(n, dtype=X.dtype, device=X.device)
        # Squared distances by differences, as scipy's pdist takes them
        d2 = torch.cdist(X, X, compute_mode="donot_use_mm_for_euclid_dist")
        d2 = d2 * d2

        def kernel(theta):
            ls, noise = torch.exp(theta[0]), torch.exp(theta[1])
            return (torch.exp(-0.5 * d2 / (ls * ls))
                    + (noise + _SKLEARN_ALPHA) * eye)

        def objective(theta_np):
            theta = torch.tensor(theta_np, dtype=X.dtype, device=X.device,
                                 requires_grad=True)
            with torch.enable_grad():
                L, info = torch.linalg.cholesky_ex(kernel(theta))
                if int(info) != 0:
                    # scikit-learn's LinAlgError branch: -inf likelihood
                    return math.inf, np.zeros(2)
                alpha = torch.cholesky_solve(Y, L)
                nlml = (0.5 * torch.sum(Y * alpha)
                        + q * torch.sum(torch.log(torch.diagonal(L)))
                        + 0.5 * n * q * math.log(2.0 * math.pi))
                (grad,) = torch.autograd.grad(nlml, theta)
            return float(nlml.detach()), grad.cpu().numpy()

        res = minimize(objective, np.zeros(2), method="L-BFGS-B", jac=True,
                       bounds=[(_LOG_LB, _LOG_UB)] * 2)
        theta = torch.tensor(res.x, dtype=X.dtype, device=X.device)
        with torch.no_grad():
            L = torch.linalg.cholesky(kernel(theta))
            ls = torch.exp(theta[0])
            Ks = torch.exp(-0.5 * torch.cdist(
                Xs, X, compute_mode="donot_use_mm_for_euclid_dist") ** 2
                / (ls * ls))
            preds.append(Ks @ torch.cholesky_solve(Y, L))
        kparams.append(torch.exp(theta))
    return torch.stack(preds), torch.stack(kparams)


# ---------------------------------------------------------------------------
# MLP


def glorot_init(sizes: Sequence[int], n_members: int,
                generator: torch.Generator, device) -> List[Tuple]:
    """Per-member layers (w (M, in, out), b (M, out)): Glorot-uniform
    weights drawn from ``generator``, zero biases."""
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((n_members, fan_in, fan_out), generator=generator,
                       device=generator.device)
        layers.append(((2.0 * u - 1.0).mul_(bound).to(device),
                       torch.zeros((n_members, fan_out), device=device)))
    return layers


def _mlp_apply(layers, x):
    h = x
    for w, b in layers[:-1]:
        h = torch.relu(torch.baddbmm(b[:, None, :], h, w))
    w, b = layers[-1]
    return torch.baddbmm(b[:, None, :], h, w)


def train_mlp_batched(layers, X_tr, Y_tr, indices, lr: float, alpha: float,
                      b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Train per-member MLPs with Adam on the minibatch rows ``indices``
    (n_steps, b), shared by the members. Each member's loss is half the
    mean squared error over its minibatch rows and outputs, plus
    0.5 * alpha * (sum of squared weights) / b, scikit-learn's MLPRegressor
    loss; the update is optax.adam's. Returns the trained layers."""
    params = [t.detach().clone().requires_grad_()
              for layer in layers for t in layer]
    m_state = [torch.zeros_like(p) for p in params]
    v_state = [torch.zeros_like(p) for p in params]
    b = indices.shape[1]
    for step, idx in enumerate(indices, start=1):
        pairs = list(zip(params[::2], params[1::2]))
        xb, yb = X_tr[:, idx], Y_tr[:, idx]
        sq = 0.5 * torch.mean((_mlp_apply(pairs, xb) - yb) ** 2, dim=(1, 2))
        l2 = sum(torch.sum(w * w, dim=(1, 2)) for w, _ in pairs)
        loss = torch.sum(sq + 0.5 * alpha * l2 / b)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for p, g, m, v in zip(params, grads, m_state, v_state):
                m.mul_(b1).add_((1.0 - b1) * g)
                v.mul_(b2).add_((1.0 - b2) * (g * g))
                p.add_(-lr * ((m / c1) / (torch.sqrt(v / c2) + eps)))
    return [(w.detach(), bias.detach())
            for w, bias in zip(params[::2], params[1::2])]


def mlp_draws(sizes: Sequence[int], n_members: int, n_rows: int,
              batch_size: int, n_epochs: int,
              generator: Optional[torch.Generator], device, init=None,
              indices=None):
    """The MLP fits' random inputs on ``device``: initial layers
    (``glorot_init``) and minibatch rows (n_epochs * max(N // b, 1), b),
    uniform with replacement, for b = min(batch_size, N). ``generator``
    (default: seeded 0 on ``device``) draws them; ``init`` and ``indices``
    replace the draws."""
    b = min(batch_size, n_rows)
    n_steps = n_epochs * max(n_rows // b, 1)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if init is None:
        init = glorot_init(sizes, n_members, generator, device)
    if indices is None:
        indices = torch.randint(0, n_rows, (n_steps, b), generator=generator,
                                device=generator.device)
    init = [(_as_f32(w, device), _as_f32(bias, device)) for w, bias in init]
    return init, _as_f32(indices, device).long()


def fit_mlp_baseline_batched(X_tr, Y_tr, X_te, hidden: Tuple[int, ...] = (64, 64),
                             lr: float = 1e-3, batch_size: int = 200,
                             n_epochs: int = 300, alpha: float = 1e-4,
                             generator: Optional[torch.Generator] = None,
                             init=None, indices=None):
    """MLP(64, 64) per member; returns (M, T, Q) predictions. Tensors on
    one device; ``generator``, ``init`` and ``indices`` as in
    ``mlp_draws``."""
    M, N, D = X_tr.shape
    init, indices = mlp_draws([D, *hidden, Y_tr.shape[-1]], M, N, batch_size,
                              n_epochs, generator, X_tr.device, init, indices)
    mu = torch.mean(Y_tr, dim=1, keepdim=True)
    sd = torch.std(Y_tr, dim=1, keepdim=True, correction=0) + 1e-12
    layers = train_mlp_batched(init, X_tr, (Y_tr - mu) / sd, indices, lr,
                               alpha)
    with torch.no_grad():
        return _mlp_apply(layers, X_te) * sd + mu


# ---------------------------------------------------------------------------
# run_comparison, batched


def run_comparison_batched(
    data_train,
    data_test,
    generator: Optional[torch.Generator] = None,
    models: Tuple[str, ...] = ("LIN", "GPR", "MLP"),
    mlp_kwargs: Optional[dict] = None,
    device: DeviceLike = None,
    gpr: str = "batched",
) -> Tuple[List[Dict[str, dict]], List[Dict[str, np.ndarray]]]:
    """Every member's comparison against the baselines, on ``device``
    (None means CUDA).

    ``data_*`` are member-stacked (x, c, y, ...) of shape (M, N, d); the
    features are [x ‖ c] standardized by each member's train moments.
    Returns per-member ``(metrics, predictions)`` dict lists in member
    order; ``generator`` feeds the MLP. ``gpr`` picks the GPR fit:
    "batched" (``fit_gpr_batched``, every member at once in float32) or
    "lbfgsb" (``fit_gpr_lbfgsb``, scikit-learn's fit, member by member).
    """
    gpr_fits = {"batched": fit_gpr_batched, "lbfgsb": fit_gpr_lbfgsb}
    if gpr not in gpr_fits:
        raise ValueError(f"Unknown GPR fit {gpr!r}; have {sorted(gpr_fits)}")
    device = resolve_device(device)
    x_tr, c_tr, y_tr = (_as_f32(a, device) for a in data_train[:3])
    x_te, c_te, y_te = (_as_f32(a, device) for a in data_test[:3])
    X_tr = _standardize_features(x_tr, c_tr, x_tr, c_tr)
    X_te = _standardize_features(x_tr, c_tr, x_te, c_te)

    preds = {}
    for name in models:
        if name == "LIN":
            pred = fit_lin_batched(X_tr, y_tr, X_te)
        elif name == "GPR":
            pred, _ = gpr_fits[gpr](X_tr, y_tr, X_te)
        elif name == "MLP":
            pred = fit_mlp_baseline_batched(X_tr, y_tr, X_te,
                                            generator=generator,
                                            **(mlp_kwargs or {}))
        else:
            raise ValueError(f"Unknown baseline {name!r}; have LIN, GPR, MLP")
        preds[name] = pred.cpu().numpy()

    y_te_h = y_te.cpu().numpy()
    metrics_by_member, preds_by_member = [], []
    for m in range(y_te_h.shape[0]):
        metrics_by_member.append({
            name: regression_metrics(y_te_h[m], p[m])
            for name, p in preds.items()
        })
        preds_by_member.append({name: p[m] for name, p in preds.items()})
    return metrics_by_member, preds_by_member
