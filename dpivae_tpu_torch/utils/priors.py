"""Prior construction and latent-space bookkeeping (counterpart of
dpivae_tpu/utils/priors.py:22-56)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from dpivae_tpu_torch.utils.distributions import (
    MarginalDistribution,
    make_distribution,
)


def get_prior_dist(specs: Sequence) -> MarginalDistribution:
    """The product prior over factor/prior specs."""
    return MarginalDistribution(
        [make_distribution(s.dist, **s.args) for s in specs]
    )


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
