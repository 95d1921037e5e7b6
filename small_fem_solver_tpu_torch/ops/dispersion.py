"""Linear dispersion relation solver (PyTorch counterpart of
``small_fem_solver_tpu/ops/dispersion.py``).

Fixed-count Newton iteration from k0 = omega^2 / g on
f = omega^2 - g k tanh(k d), f' = -g (tanh(k d) + k d / cosh(k d)^2);
50 iterations reproduce the reference's |dk| < 1e-10 stop to well below
1e-8.
"""
from __future__ import annotations

import math

import torch

from ..constants import G_GRAV


def solve_dispersion(omega: torch.Tensor, d: torch.Tensor,
                     n_iter: int = 50) -> torch.Tensor:
    """Wavenumber k with omega^2 = g k tanh(k d), elementwise over
    tensors of a common floating dtype."""
    k = omega**2 / G_GRAV
    for _ in range(n_iter):
        kd = k * d
        th = torch.tanh(kd)
        f = omega**2 - G_GRAV * k * th
        df = -G_GRAV * (th + kd / torch.cosh(kd) ** 2)
        k = k - f / df
    return k


def apparent_period(T, d, U_along, n_iter: int = 50) -> torch.Tensor:
    """Apparent (intrinsic) wave period in the frame moving with the
    current, the API RP 2A wave-current Doppler correction.

    A wave of absolute period ``T`` on a uniform current ``U_along`` (its
    component along the wave heading, positive following) satisfies
    (omega_a - k U)^2 = g k tanh(k d) with omega_a = 2 pi / T; the wave
    theory is evaluated at T_app = 2 pi / (omega_a - k U).  Fixed-count
    Newton on k, elementwise; numbers become float64 tensors.  Beyond the
    blocking limit of an opposing current no steady wave exists and the
    iteration diverges.
    """
    T, d, U = (v if torch.is_tensor(v)
               else torch.tensor(v, dtype=torch.float64)
               for v in (T, d, U_along))
    omega_a = 2.0 * math.pi / T
    k = omega_a**2 / G_GRAV
    for _ in range(n_iter):
        kd = k * d
        th = torch.tanh(kd)
        wi = omega_a - k * U
        f = wi**2 - G_GRAV * k * th
        df = -2.0 * wi * U - G_GRAV * (th + kd / torch.cosh(kd) ** 2)
        k = k - f / df
    return 2.0 * math.pi / (omega_a - k * U)
