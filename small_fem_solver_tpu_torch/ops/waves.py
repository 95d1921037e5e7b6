"""Steady waves in one canonical Fourier form (PyTorch counterpart of
``small_fem_solver_tpu/ops/waves.py``).

Every supported wave theory is lowered at construction to a
:class:`FourierWave` of fixed-size coefficient tensors (theta = k x -
omega t, z from MWL, d = depth):

    eta(x, t)  = sum_j E_j cos(j theta)
    u(x, z, t) = sum_j U_j C_j(z) cos(j theta)      (+ current U_c)
    w(x, z, t) = sum_j U_j S_j(z) sin(j theta)
    C_j = cosh(j k (z + d)) / cosh(j k d),  S_j = sinh(j k (z + d)) / cosh(j k d)

The phase-batch Morison engines (``ops/morison.py`` and its fused kernel)
consume these coefficients directly; pointwise kinematics is not ported
yet (ROADMAP.md, Queue A item 2).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .dispersion import solve_dispersion


@dataclasses.dataclass(frozen=True)
class FourierWave:
    """Canonical steady-wave representation.  Scalars are 0-d tensors;
    ``E`` and ``U`` are ``[N]`` (N Fourier modes, zero-padded)."""

    k: torch.Tensor       # wavenumber [1/m]
    omega: torch.Tensor   # angular frequency [rad/s]
    c: torch.Tensor       # phase speed [m/s]
    d: torch.Tensor       # water depth [m]
    U_c: torch.Tensor     # uniform current speed [m/s]
    H: torch.Tensor       # wave height [m]
    T: torch.Tensor       # period [s]
    E: torch.Tensor       # [N] surface-elevation cosine coefficients [m]
    U: torch.Tensor       # [N] velocity coefficients [m/s]
    clamp_z: bool = False
    dt_fd: float = 1e-3
    model: str = "airy"
    order: int = 1

    @property
    def n_modes(self) -> int:
        return self.E.shape[-1]

    def to(self, dtype: torch.dtype, device=None) -> "FourierWave":
        """Every coefficient tensor cast to ``dtype`` (and moved)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dtype=dtype, device=device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def airy_wave(H, T, d, U_c=0.0, n_modes: int = 1,
              dtype: torch.dtype = torch.float64, device="cpu") -> FourierWave:
    """First-order (linear) wave: eta = (H/2) cos(theta), canonical
    U_1 = (H/2) omega / tanh(k d); ``n_modes`` zero-pads the coefficients."""
    def scal(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    H, T, d, U_c = scal(H), scal(T), scal(d), scal(U_c)
    omega = 2.0 * math.pi / T
    k = solve_dispersion(omega, d)
    a = H / 2.0
    pad = torch.zeros(n_modes - 1, dtype=dtype, device=device)
    E = torch.cat([a[None], pad])
    U = torch.cat([(a * omega / torch.tanh(k * d))[None], pad])
    return FourierWave(k=k, omega=omega, c=omega / k, d=d, U_c=U_c, H=H,
                       T=T, E=E, U=U, clamp_z=False, model="airy", order=1)
