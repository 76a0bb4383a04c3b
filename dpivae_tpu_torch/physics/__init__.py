"""Analytic physics models (counterpart of dpivae_tpu/physics/)."""

from dpivae_tpu_torch.physics.beam import euler_bernoulli_point_load  # noqa: F401
from dpivae_tpu_torch.physics.oscillator import (  # noqa: F401
    mass_spring,
    mass_spring_dashpot,
)
