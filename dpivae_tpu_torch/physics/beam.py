"""Euler-Bernoulli simply-supported beam with a point load (counterpart of
dpivae_tpu/physics/beam.py:14-37)."""

import torch


def euler_bernoulli_point_load(z, I=2e-6, L=1.0, P=1.0, npts=200):
    """Deflection of a simply-supported beam under a point load.

    Args:
        z: (..., 2) tensor; z[..., 0] = Young's modulus in MPa,
           z[..., 1] = load position a in [0, L].
        I: second moment of area.
        L: beam length.
        P: point load magnitude.
        npts: number of evaluation points along the beam.

    Returns:
        (..., npts) deflection in mm (negative down). The grid is f32 (f64
        for f64 z), as the JAX package's: bf16 latents round E and a to
        bf16 and the deflection is computed in f32.
    """
    x = torch.linspace(0.0, L, npts, device=z.device,
                       dtype=torch.promote_types(z.dtype, torch.float32))
    E = z[..., 0:1] * 1e6
    a = z[..., 1:2]
    b = L - a

    w = P * b * x * (L**2 - b**2 - x**2) / (6.0 * E * I * L)
    wb = P * (x - a) ** 3 / (6.0 * E * I)
    w = torch.where(x > a, w + wb, w)
    return -1000.0 * w
