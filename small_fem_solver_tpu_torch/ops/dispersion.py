"""Linear dispersion relation solver (PyTorch counterpart of
``small_fem_solver_tpu/ops/dispersion.py``).

Fixed-count Newton iteration from k0 = omega^2 / g on
f = omega^2 - g k tanh(k d), f' = -g (tanh(k d) + k d / cosh(k d)^2);
50 iterations reproduce the reference's |dk| < 1e-10 stop to well below
1e-8.
"""
from __future__ import annotations

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
