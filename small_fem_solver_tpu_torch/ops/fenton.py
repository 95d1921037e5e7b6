"""Fenton stream-function wave theory (fully nonlinear), PyTorch
counterpart of ``small_fem_solver_tpu/ops/fenton.py``.

Rienecker & Fenton (J. Fluid Mech. 104, 1981) collocation, solved by a
fixed-iteration Newton method with wave-height continuation.  The solve is
host-side wave setup: it always runs in float64 on the CPU (the Jacobian is
ill-conditioned near steep crests), and only the resulting Fourier
coefficients are cast to the requested dtype and moved to the requested
device.

Unknowns q = [eta_0..eta_M, B_1..B_N, B0, k, Q, R] with M = N collocation
points over half a wavelength (theta_m = m pi / M); equations: KFSBC and
DFSBC at every point, mean depth, wave height, period.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import G_GRAV
from .dispersion import solve_dispersion
from .waves import FourierWave

_F64 = torch.float64


def _residual(q, d, H, omega, M: int, g):
    """The 2M+5 collocation equations; q = [eta(M+1), B(M), B0, k, Q, R]."""
    eta = q[: M + 1]
    B = q[M + 1: 2 * M + 1]
    B0, k, Q, R = q[2 * M + 1], q[2 * M + 2], q[2 * M + 3], q[2 * M + 4]

    j = torch.arange(1, M + 1, dtype=q.dtype)
    theta = math.pi * torch.arange(M + 1, dtype=q.dtype) / M
    cjt = torch.cos(torch.outer(theta, j))              # [M+1, N]
    sjt = torch.sin(torch.outer(theta, j))

    # hyperbolic profiles at the surface heights, normalized by cosh(j k d)
    A = j * k * eta[:, None]
    Bd = j * k * d
    scale = torch.exp(A - Bd) / (1.0 + torch.exp(-2.0 * Bd))
    Cj = scale * (1.0 + torch.exp(-2.0 * A))
    Sj = scale * (1.0 - torch.exp(-2.0 * A))

    psi = B0 * eta + (Sj * cjt) @ B
    u_f = B0 + ((j * k) * Cj * cjt) @ B
    w_f = ((j * k) * Sj * sjt) @ B

    r_mean = (0.5 * eta[0] + torch.sum(eta[1:M]) + 0.5 * eta[M]) / M - d
    r_height = eta[0] - eta[M] - H
    r_period = -B0 * k - omega
    return torch.cat([psi - Q, 0.5 * (u_f**2 + w_f**2) + g * eta - R,
                      torch.stack([r_mean, r_height, r_period])])


def _initial_guess(H, T, d, M: int):
    """Linear-theory start vector (float64)."""
    omega = 2.0 * math.pi / T
    k = solve_dispersion(omega, d)
    c = omega / k
    a = H / 2.0
    theta = math.pi * torch.arange(M + 1, dtype=_F64) / M
    eta = d + a * torch.cos(theta)
    B = torch.zeros(M, dtype=_F64)
    B[0] = a * omega / (k * torch.tanh(k * d))
    B0 = -c
    return torch.cat([eta, B, torch.stack([B0, k, B0 * d,
                                           0.5 * B0**2 + G_GRAV * d])])


def _solve_fenton(H: float, T: float, d: float, M: int, n_newton: int = 12,
                  n_cont: int = 10) -> torch.Tensor:
    """Height-continuation Newton solve (float64, CPU); returns q.

    Height ramps 0 -> H in ``n_cont`` steps, each running ``n_newton``
    full Newton iterations with the exact forward-mode Jacobian.
    """
    H, T, d = (torch.tensor(float(v), dtype=_F64) for v in (H, T, d))
    g = torch.tensor(G_GRAV, dtype=_F64)
    omega = 2.0 * math.pi / T
    jac = torch.func.jacfwd(_residual)
    q = _initial_guess(H / n_cont, T, d, M)
    for i in range(n_cont):
        Hi = H * (i + 1.0) / n_cont
        for _ in range(n_newton):
            r = _residual(q, d, Hi, omega, M, g)
            q = q - torch.linalg.solve(jac(q, d, Hi, omega, M, g), r)
    return q


def fenton_wave(H, T, d, U_c=0.0, N: int = 10, n_modes: int | None = None,
                dtype: torch.dtype = torch.float64, device="cpu",
                n_newton: int = 12, n_cont: int = 10,
                check: bool = True) -> FourierWave:
    """Fully nonlinear stream-function wave in canonical Fourier form.

    ``check=True`` verifies the collocation residual and raises for a
    non-converged (e.g. above-breaking) wave.
    """
    M = int(N)
    q = _solve_fenton(H, T, d, M, n_newton=n_newton, n_cont=n_cont)
    if check:
        r = _residual(q, torch.tensor(float(d), dtype=_F64),
                      torch.tensor(float(H), dtype=_F64),
                      2.0 * math.pi / float(T), M,
                      torch.tensor(G_GRAV, dtype=_F64)).numpy()
        if not np.isfinite(r).all() or \
                np.abs(r).max() > 1e-6 * max(G_GRAV * float(d), 1.0):
            raise ValueError(
                f"Fenton stream-function solve did not converge for H={H}, "
                f"T={T}, d={d} (residual {np.abs(r).max():.2e}); the wave "
                f"may exceed the breaking limit")
    return fenton_wave_from_solution(q.to(dtype=dtype, device=device), H, T,
                                     d, U_c, M, n_modes=n_modes)


def fenton_wave_from_solution(q: torch.Tensor, H, T, d, U_c, M: int,
                              n_modes: int | None = None) -> FourierWave:
    """Lower a collocation solution vector to the canonical FourierWave,
    in ``q``'s dtype and on its device.

    E_j is the type-I DCT of eta - d over the half-wavelength grid; the
    Nyquist term (j = M) takes 1/M, not 2/M.
    """
    dtype, device = q.dtype, q.device

    def scal(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    eta = q[: M + 1]
    B = q[M + 1: 2 * M + 1]
    k = q[2 * M + 2]
    omega = 2.0 * math.pi / scal(T)
    d = scal(d)

    j = torch.arange(1, M + 1, dtype=dtype, device=device)
    theta = math.pi * torch.arange(M + 1, dtype=dtype, device=device) / M
    w = torch.ones(M + 1, dtype=dtype, device=device)
    w[0] = w[M] = 0.5
    E = (2.0 / M) * torch.einsum("m,mj->j", w * (eta - d),
                                 torch.cos(torch.outer(theta, j)))
    E[-1] = E[-1] * 0.5
    U = j * k * B

    n_modes = n_modes or M
    if n_modes < M:
        raise ValueError("n_modes must be >= N")
    pad = torch.zeros(n_modes - M, dtype=dtype, device=device)
    return FourierWave(
        k=k, omega=omega, c=omega / k, d=d, U_c=scal(U_c), H=scal(H),
        T=scal(T), E=torch.cat([E, pad]), U=torch.cat([U, pad]),
        clamp_z=True, model="fenton", order=M)
