"""Prior construction, latent-space bookkeeping and the transfer study's
domain splits (counterpart of dpivae_tpu/utils/priors.py)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from dpivae_tpu_torch.utils.distributions import (
    BoxUniform,
    MarginalDistribution,
    UniformBoxMixture,
    make_distribution,
)


def get_prior_dist(specs: Sequence) -> MarginalDistribution:
    """The product prior over factor/prior specs."""
    return MarginalDistribution(
        [make_distribution(s.dist, **s.args) for s in specs]
    )


def interp_ground_truth(factors: Sequence) -> Tuple[List[float], List[float]]:
    """The factors' bounds for plots and traversals: ([lb], [ub])."""
    return [f.lb for f in factors], [f.ub for f in factors]


def get_shapes_from_factors(factors: Sequence) -> Tuple[int, int, int, int, int]:
    """Count latent dims by type tag: (n_x, n_c, n_y, n_f, n_p); ``p``
    counts physical covariates (type == "c" and phys)."""
    n_x = sum(1 for f in factors if f.type == "x")
    n_c = sum(1 for f in factors if f.type == "c")
    n_y = sum(1 for f in factors if f.type == "y")
    n_f = sum(1 for f in factors if f.type == "f")
    n_p = sum(1 for f in factors if f.type == "c" and f.phys)
    return n_x, n_c, n_y, n_f, n_p


def factor_indices(factors: Sequence, type_tag: str) -> List[int]:
    """Positions of factors with the given type tag in declaration order."""
    return [i for i, f in enumerate(factors) if f.type == type_tag]


def phys_covariate_indices(factors: Sequence) -> List[int]:
    """Indices within the c-block of physical covariates (``idx_c_phys``)."""
    c_factors = [f for f in factors if f.type == "c"]
    return [i for i, f in enumerate(c_factors) if f.phys]


def make_square_dist(case) -> Tuple[List[UniformBoxMixture], List[BoxUniform]]:
    """The transfer study's four quadrant folds (counterpart of
    dpivae_tpu/utils/priors.py:59-115): the 2-D physics-latent box split
    into quadrants; fold i trains on a uniform mixture over three
    quadrants and tests on the fourth. Assumes exactly two type-"x"
    factors, as the JAX package does.

    Returns (train_dists, test_dists), 4 of each, over all factors.
    """
    factors = case.factors
    phys = [f for f in factors if f.type == "x"]
    assert len(phys) == 2, "make_square_dist assumes exactly 2 physics latents"

    lb = np.array([f.lb for f in factors], dtype=np.float64)
    ub = np.array([f.ub for f in factors], dtype=np.float64)
    lb_x = np.array([f.args["low"] for f in phys])
    ub_x = np.array([f.args["high"] for f in phys])
    ce_x = lb_x + (ub_x - lb_x) / 2

    # Quadrant bounds along each physics dim, in the JAX package's order
    bounds_0 = np.array([[lb_x[0], ce_x[0]], [ce_x[0], ub_x[0]],
                         [ce_x[0], ub_x[0]], [lb_x[0], ce_x[0]]])
    bounds_1 = np.array([[lb_x[1], ce_x[1]], [lb_x[1], ce_x[1]],
                         [ce_x[1], ub_x[1]], [ce_x[1], ub_x[1]]])
    lb_new = np.tile(lb, (4, 1))
    ub_new = np.tile(ub, (4, 1))
    lb_new[:, 0], lb_new[:, 1] = bounds_0[:, 0], bounds_1[:, 0]
    ub_new[:, 0], ub_new[:, 1] = bounds_0[:, 1], bounds_1[:, 1]

    # circulant(arange(4)): column i is [i, i-1, i-2, i-3] mod 4, so fold i
    # trains on quadrants {i, i-1, i-2} and tests on quadrant i-3.
    circ = np.stack([np.roll(np.arange(4), k) for k in range(4)], axis=1)
    dist_train, dist_test = [], []
    for i in range(4):
        idx_train, idx_test = circ[:3, i], int(circ[3, i])
        dist_train.append(UniformBoxMixture(
            lows=np.asarray(lb_new[idx_train], dtype=np.float32),
            highs=np.asarray(ub_new[idx_train], dtype=np.float32)))
        dist_test.append(BoxUniform(
            low=np.asarray(lb_new[idx_test], dtype=np.float32),
            high=np.asarray(ub_new[idx_test], dtype=np.float32)))
    return dist_train, dist_test
