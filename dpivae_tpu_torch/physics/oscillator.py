"""Mass-spring oscillator physics (counterpart of
dpivae_tpu/physics/oscillator.py:14-63).

``mass_spring`` is the frozen partial physics of the damped_oscillator
case: an undamped unit-stiffness oscillator whose only latent is the mass.
``mass_spring_dashpot`` is the full damped, temperature-dependent
generator in closed form. The time grid ``t`` is a tensor on z's device
(a numpy grid is copied there), in f32 (f64 for f64 z), as the JAX
package's: bf16 latents give f32 responses.
"""

import torch


def grid_dtype(z: torch.Tensor) -> torch.dtype:
    """The time grid's dtype for latents ``z``: f32, or f64 for f64 z."""
    return torch.promote_types(z.dtype, torch.float32)


def mass_spring(z, t):
    """Undamped oscillator response x(t) = x0 * cos(sqrt(k/m) t), k = x0 = 1.

    Args:
        z: (..., >=1) latents; z[..., 0] = mass.
        t: (npts,) time grid.

    Returns:
        (..., npts) displacement.
    """
    t = torch.as_tensor(t, dtype=grid_dtype(z), device=z.device)
    k = 1.0
    x0 = 1.0
    xd0 = 0.0
    m = z[..., 0:1]
    omega = torch.sqrt(k / m)
    B = xd0 / omega
    return B * torch.sin(omega * t) + x0 * torch.cos(omega * t)


def mass_spring_dashpot(z, t, k=1.0, omega_f=None, T0=20.0, alpha_T=0.01):
    """Damped oscillator with temperature-dependent stiffness (closed form):
    stiffness k_T = alpha_T * (T0 - T) + k, damping ratio from the
    dashpot c.

    Args:
        z: (..., 4) inputs [m, c, T, x0].
        t: (npts,) time grid.

    Returns:
        (..., npts) displacement of the underdamped solution.
    """
    del omega_f  # forcing amplitude is zero in the case study
    t = torch.as_tensor(t, dtype=grid_dtype(z), device=z.device)
    m = z[..., 0:1]
    c = z[..., 1:2]
    T = z[..., 2:3]
    x0 = z[..., 3:4]
    xd0 = 0.0

    k_T = alpha_T * (T0 - T) + k
    omega0 = torch.sqrt(k_T / m)
    zeta = c / (2.0 * torch.sqrt(k_T * m))
    # Underdamped closed form (zeta < 1 across the case's parameter ranges)
    omega_d = omega0 * torch.sqrt(torch.clamp(1.0 - zeta**2, min=1e-12))
    A = x0
    B = (xd0 + zeta * omega0 * x0) / omega_d
    return torch.exp(-zeta * omega0 * t) * (
        A * torch.cos(omega_d * t) + B * torch.sin(omega_d * t)
    )
