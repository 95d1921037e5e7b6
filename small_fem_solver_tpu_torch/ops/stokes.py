"""Stokes wave theory (orders 1-5), Fenton (1985) formulation (PyTorch
counterpart of ``small_fem_solver_tpu/ops/stokes.py``).

J.D. Fenton, "A fifth-order Stokes theory for steady waves", J. Waterway,
Port, Coastal and Ocean Engineering 111(2), 1985 (with the standard erratum
to A44/C2).  The construction lowers (H, T, d) to the canonical
:class:`~.waves.FourierWave`: a 5-mode cosine series for the surface and a
5-mode velocity series.  Like ``ops/fenton.py`` it is host-side wave setup:
it always runs in float64 on the CPU, and only the resulting coefficients
are cast to the requested dtype and moved to the requested device.

Conventions: theta = k x - omega t; zero mean Eulerian current (Stokes'
first definition of celerity); a uniform current is added to u downstream.

Fenton's expansion parameter is eps = k H / 2.  Surface elevation:

    k eta = kd + eps cos t + eps^2 B22 cos 2t + eps^3 B31 (cos t - cos 3t)
            + eps^4 (B42 cos 2t + B44 cos 4t)
            + eps^5 (-(B53 + B55) cos t + B53 cos 3t + B55 cos 5t)

Velocity coefficients in the canonical normalized form:
U_j = C0 sqrt(g/k) j (sum_i eps^i A_ij) cosh(j k d).

Dispersion (zero current): omega / k = sqrt(g / k) (C0 + eps^2 C2 +
eps^4 C4), solved for k by a fixed-count Newton iteration.
"""
from __future__ import annotations

import math

import torch

from ..constants import G_GRAV
from ..device import resolve_device
from .dispersion import solve_dispersion
from .waves import FourierWave

_F64 = torch.float64


def _fenton_coefficients(kd: torch.Tensor):
    """A_ij, B_ij, C_i polynomials in S = sech(2kd) (Fenton 1985, Table 1)."""
    S = 1.0 / torch.cosh(2.0 * kd)
    sh = torch.sinh(kd)
    th = torch.tanh(kd)
    cth = 1.0 / th
    Sm1 = 1.0 - S

    A = {}
    A[1, 1] = 1.0 / sh
    A[2, 2] = 3.0 * S**2 / (2.0 * Sm1**2)
    A[3, 1] = (-4.0 - 20.0 * S + 10.0 * S**2 - 13.0 * S**3) / (8.0 * sh
                                                               * Sm1**3)
    A[3, 3] = (-2.0 * S**2 + 11.0 * S**3) / (8.0 * sh * Sm1**3)
    A[4, 2] = (12.0 * S - 14.0 * S**2 - 264.0 * S**3 - 45.0 * S**4
               - 13.0 * S**5) / (24.0 * Sm1**5)
    A[4, 4] = (10.0 * S**3 - 174.0 * S**4 + 291.0 * S**5
               + 278.0 * S**6) / (48.0 * (3.0 + 2.0 * S) * Sm1**5)
    A[5, 1] = (-1184.0 + 32.0 * S + 13232.0 * S**2 + 21712.0 * S**3
               + 20940.0 * S**4 + 12554.0 * S**5 - 500.0 * S**6
               - 3341.0 * S**7 - 670.0 * S**8) / (
                   64.0 * sh * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)
    A[5, 3] = (4.0 * S + 105.0 * S**2 + 198.0 * S**3 - 1376.0 * S**4
               - 1302.0 * S**5 - 117.0 * S**6 + 58.0 * S**7) / (
                   32.0 * sh * (3.0 + 2.0 * S) * Sm1**6)
    A[5, 5] = (-6.0 * S**3 + 272.0 * S**4 - 1552.0 * S**5 + 852.0 * S**6
               + 2029.0 * S**7 + 430.0 * S**8) / (
                   64.0 * sh * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)

    B = {}
    B[2, 2] = cth * (1.0 + 2.0 * S) / (2.0 * Sm1)
    B[3, 1] = -3.0 * (1.0 + 3.0 * S + 3.0 * S**2 + 2.0 * S**3) / (8.0
                                                                  * Sm1**3)
    B[4, 2] = cth * (6.0 - 26.0 * S - 182.0 * S**2 - 204.0 * S**3
                     - 25.0 * S**4 + 26.0 * S**5) / (
                         6.0 * (3.0 + 2.0 * S) * Sm1**4)
    B[4, 4] = cth * (24.0 + 92.0 * S + 122.0 * S**2 + 66.0 * S**3
                     + 67.0 * S**4 + 34.0 * S**5) / (
                         24.0 * (3.0 + 2.0 * S) * Sm1**4)
    B[5, 3] = 9.0 * (132.0 + 17.0 * S - 2216.0 * S**2 - 5897.0 * S**3
                     - 6292.0 * S**4 - 2687.0 * S**5 + 194.0 * S**6
                     + 467.0 * S**7 + 82.0 * S**8) / (
                         128.0 * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)
    B[5, 5] = 5.0 * (300.0 + 1579.0 * S + 3176.0 * S**2 + 2949.0 * S**3
                     + 1188.0 * S**4 + 675.0 * S**5 + 1326.0 * S**6
                     + 827.0 * S**7 + 130.0 * S**8) / (
                         384.0 * (3.0 + 2.0 * S) * (4.0 + S) * Sm1**6)

    C = {}
    C[0] = torch.sqrt(th)
    C[2] = C[0] * (2.0 + 7.0 * S**2) / (4.0 * Sm1**2)
    C[4] = C[0] * (4.0 + 32.0 * S - 116.0 * S**2 - 400.0 * S**3
                   - 71.0 * S**4 + 146.0 * S**5) / (32.0 * Sm1**5)
    return A, B, C


def _celerity_factor(kd, eps, order: int):
    """C0 + eps^2 C2 + eps^4 C4 truncated to the requested order."""
    _, _, C = _fenton_coefficients(kd)
    fac = C[0]
    if order >= 3:
        fac = fac + eps**2 * C[2]
    if order >= 5:
        fac = fac + eps**4 * C[4]
    return fac


def solve_stokes_dispersion(H, T, d, order: int = 5,
                            n_iter: int = 40) -> torch.Tensor:
    """Wavenumber k from omega/k = sqrt(g/k) (C0 + eps^2 C2 + eps^4 C4),
    eps = kH/2, elementwise over float64 tensors of a common shape.

    Fixed-count Newton from the linear-theory k; the derivative of the
    (elementwise) residual is a forward-mode ``torch.func.jvp``.
    """
    H, T, d = (torch.as_tensor(v, dtype=_F64) for v in (H, T, d))
    omega = 2.0 * math.pi / T

    def residual(k):
        return (torch.sqrt(G_GRAV * k)
                * _celerity_factor(k * d, k * H / 2.0, order) - omega)

    k = solve_dispersion(omega, d)
    ones = torch.ones_like(k)
    for _ in range(n_iter):
        r, dr = torch.func.jvp(residual, (k,), (ones,))
        k = k - r / dr
    return k


def stokes_wave(H, T, d, U_c=0.0, order: int = 5, n_modes: int = 5,
                dtype: torch.dtype = torch.float64,
                device=None) -> FourierWave:
    """Stokes wave of the given order (1-5) in canonical Fourier form, on
    ``device`` (``None``: the CUDA card) in ``dtype``.

    ``order`` mirrors the reference's N for a Stokes wave (clipped to 5 by
    ``make_wave``); order 1 reduces to linear theory with the Airy
    dispersion.  Stokes waves take the evaluation-height clamp
    (``clamp_z=True``).
    """
    if not 1 <= order <= 5:
        raise ValueError(f"Stokes order must be in 1..5, got {order}")
    device = resolve_device(device)
    n_modes = max(n_modes, 5)
    H, T, d, U_c = (torch.as_tensor(v, dtype=_F64) for v in (H, T, d, U_c))

    k = solve_stokes_dispersion(H, T, d, order=order)
    omega = 2.0 * math.pi / T
    kd = k * d
    eps = k * H / 2.0
    A, B, _ = _fenton_coefficients(kd)

    def ord_(n, value):
        """Include a term only if the order admits it."""
        return value if order >= n else torch.zeros_like(value)

    # surface elevation coefficients, eta = sum E_j cos(j theta)
    E1 = (eps + ord_(3, eps**3 * B[3, 1])
          + ord_(5, -eps**5 * (B[5, 3] + B[5, 5])))
    E2 = ord_(2, eps**2 * B[2, 2]) + ord_(4, eps**4 * B[4, 2])
    E3 = ord_(3, -eps**3 * B[3, 1]) + ord_(5, eps**5 * B[5, 3])
    E4 = ord_(4, eps**4 * B[4, 4])
    E5 = ord_(5, eps**5 * B[5, 5])
    E = torch.stack([E1, E2, E3, E4, E5], dim=-1) / k[..., None]

    # velocity coefficients (canonical, normalized by cosh(j k d))
    P1 = (eps * A[1, 1] + ord_(3, eps**3 * A[3, 1])
          + ord_(5, eps**5 * A[5, 1]))
    P2 = ord_(2, eps**2 * A[2, 2]) + ord_(4, eps**4 * A[4, 2])
    P3 = ord_(3, eps**3 * A[3, 3]) + ord_(5, eps**5 * A[5, 3])
    P4 = ord_(4, eps**4 * A[4, 4])
    P5 = ord_(5, eps**5 * A[5, 5])
    P = torch.stack([P1, P2, P3, P4, P5], dim=-1)
    j = torch.arange(1, 6, dtype=_F64)
    C0 = torch.sqrt(torch.tanh(kd))
    U = ((C0 * torch.sqrt(G_GRAV / k))[..., None] * j * P
         * torch.cosh(j * kd[..., None]))

    pad = torch.zeros(E.shape[:-1] + (n_modes - 5,), dtype=_F64)
    return FourierWave(
        k=k, omega=omega, c=omega / k, d=d, U_c=U_c, H=H, T=T,
        E=torch.cat([E, pad], dim=-1), U=torch.cat([U, pad], dim=-1),
        clamp_z=True, model="stokes", order=order).to(dtype, device)
