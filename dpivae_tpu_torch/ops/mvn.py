"""Full-covariance multivariate normal: reparameterized sampling and
log-density (counterpart of dpivae_tpu/ops/mvn.py:51-104).

- ``mvn_sample_with_log_prob`` samples ``z = loc + L @ eps`` and computes
  ``log q(z)`` from the noise, ``-0.5*||eps||^2 - sum(log diag L) + d*const``,
  which equals the Mahalanobis form for z drawn from the same distribution.
- ``mvn_log_prob`` is the generic density (triangular solve) for z drawn
  elsewhere, e.g. learned priors evaluated at encoder samples.

Latent dims in this model family are 1-10. At d <= 16 the matvec and the
triangular solve are written out elementwise, as in the JAX package, so
each is a handful of broadcast ops over the (n, batch) rows rather than
many tiny batched matrix products.
"""

from __future__ import annotations

from typing import Optional

import torch

from dpivae_tpu_torch.utils import GAUSSIAN_CONST, randn

_SMALL_DIM = 16


def _matvec_small(L, v):
    """(..., d, d) @ (..., d) as a broadcast-multiply + reduce."""
    return torch.sum(L * v[..., None, :], dim=-1)


def _tri_solve_small(L, b):
    """Forward substitution for lower-triangular L, unrolled over the
    (tiny) dimension."""
    d = b.shape[-1]
    xs = []
    for i in range(d):
        s = b[..., i]
        for j in range(i):
            s = s - L[..., i, j] * xs[j]
        xs.append(s / L[..., i, i])
    return torch.stack(xs, dim=-1)


def _half_log_det(scale_tril):
    return torch.sum(
        torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)), dim=-1
    )


def mvn_sample_with_log_prob(loc, scale_tril, n: int, *,
                             generator: Optional[torch.Generator] = None,
                             eps: Optional[torch.Tensor] = None):
    """Draw ``n`` reparameterized samples and their log-density.

    Args:
        loc: (..., d) mean.
        scale_tril: (..., d, d) lower-triangular scale.
        n: number of Monte-Carlo samples (leading axis of the output).
        generator: source of the standard normals, unless ``eps`` is given.
        eps: explicit standard normals of shape (n, *loc.shape).

    Returns:
        z: (n, ..., d) samples.
        log_q: (n, ...) log density of each sample under MVN(loc, L L^T).
    """
    d = loc.shape[-1]
    shape = (n, *loc.shape)
    if eps is None:
        eps = randn(shape, generator, loc.device, loc.dtype)
    elif tuple(eps.shape) != shape:
        raise ValueError(f"eps has shape {tuple(eps.shape)}, expected {shape}")
    if d <= _SMALL_DIM:
        z = loc + _matvec_small(scale_tril, eps)
    else:
        z = loc + torch.squeeze(scale_tril @ eps[..., None], -1)
    log_q = (
        torch.sum(-0.5 * eps * eps, dim=-1) + d * GAUSSIAN_CONST
        - _half_log_det(scale_tril)
    )
    return z, log_q


def mvn_log_prob(z, loc, scale_tril):
    """Generic MVN log-density via triangular solve.

    Args:
        z: (..., d) points (may have extra leading axes vs loc).
        loc: (..., d) mean.
        scale_tril: (..., d, d) lower-triangular scale.

    Returns:
        (...) log densities, broadcasting z against loc.
    """
    d = z.shape[-1]
    diff = z - loc
    if d <= _SMALL_DIM:
        u = _tri_solve_small(scale_tril, diff)
    else:
        L = scale_tril.expand(*diff.shape[:-1], d, d)
        u = torch.linalg.solve_triangular(L, diff[..., None], upper=False)[..., 0]
    return (
        torch.sum(-0.5 * u * u, dim=-1) + d * GAUSSIAN_CONST
        - _half_log_det(scale_tril)
    )
