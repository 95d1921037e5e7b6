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
from ..device import resolve_device
from .dispersion import solve_dispersion
from .waves import FourierWave, stack_waves

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


def _solve_fenton(H: torch.Tensor, T: torch.Tensor, d: torch.Tensor, M: int,
                  n_newton: int = 12, n_cont: int = 10) -> torch.Tensor:
    """Height-continuation Newton solve over a case batch ([C] float64 CPU
    tensors); returns q [C, 2M+5].

    Height ramps 0 -> H in ``n_cont`` steps, each running ``n_newton``
    full Newton iterations with the exact forward-mode Jacobian (vmapped
    over the cases, one batched linear solve per iteration).
    """
    g = torch.tensor(G_GRAV, dtype=_F64)
    omega = 2.0 * math.pi / T
    residual = torch.func.vmap(_residual, in_dims=(0, 0, 0, 0, None, None))
    jac = torch.func.vmap(torch.func.jacfwd(_residual),
                          in_dims=(0, 0, 0, 0, None, None))
    q = torch.stack([_initial_guess(h / n_cont, t, dd, M)
                     for h, t, dd in zip(H, T, d)])
    for i in range(n_cont):
        Hi = H * (i + 1.0) / n_cont
        for _ in range(n_newton):
            r = residual(q, d, Hi, omega, M, g)
            q = q - torch.linalg.solve(jac(q, d, Hi, omega, M, g), r)
    return q


def fenton_wave(H, T, d, U_c=0.0, N: int = 10, n_modes: int | None = None,
                dtype: torch.dtype = torch.float64, device=None,
                n_newton: int = 12, n_cont: int = 10,
                check: bool = True) -> FourierWave:
    """Fully nonlinear stream-function wave in canonical Fourier form: a
    batch of one :func:`fenton_wave_batch` case.

    ``check=True`` verifies the collocation residual and raises for a
    non-converged (e.g. above-breaking) wave.
    """
    return fenton_wave_batch(H, T, d, U_c, N=N, n_modes=n_modes, dtype=dtype,
                             device=device, n_newton=n_newton, n_cont=n_cont,
                             check=check).case(0)


def fenton_wave_batch(H, T, d, U_c=0.0, N: int = 10,
                      n_modes: int | None = None,
                      dtype: torch.dtype = torch.float32, device=None,
                      n_newton: int = 12, n_cont: int = 10,
                      check: bool = True) -> FourierWave:
    """Batched Fenton setup: one float64 CPU Newton over all (H, T) cases,
    returning a batched :class:`FourierWave` (leading case axis) on
    ``device`` (``None``: the CUDA card) in ``dtype``.

    ``T``, ``d`` and ``U_c`` may be scalars or per-case arrays.
    ``check=True`` evaluates every case's collocation residual in one
    batched call and raises ``ValueError`` naming the cases that did not
    converge (e.g. above-breaking waves).
    """
    device = resolve_device(device)
    M = int(N)
    H = np.atleast_1d(np.asarray(H, np.float64))
    T, d_b, Uc_b = (np.broadcast_to(np.asarray(v, np.float64), H.shape)
                    for v in (T, d, U_c))
    Ht, Tt, dt = (torch.tensor(v, dtype=_F64) for v in (H, T, d_b))
    q = _solve_fenton(Ht, Tt, dt, M, n_newton=n_newton, n_cont=n_cont)
    if check:
        res = torch.func.vmap(_residual, in_dims=(0, 0, 0, 0, None, None))(
            q, dt, Ht, 2.0 * math.pi / Tt, M,
            torch.tensor(G_GRAV, dtype=_F64)).numpy()
        scale = np.maximum(G_GRAV * d_b, 1.0)
        bad = ~(np.isfinite(res).all(axis=1)
                & (np.abs(res).max(axis=1) <= 1e-6 * scale))
        if bad.any():
            idx = np.flatnonzero(bad)
            raise ValueError(
                f"Fenton stream-function solve did not converge for "
                f"{idx.size} of {H.size} cases (indices {idx[:10].tolist()}, "
                f"e.g. H={H[idx[0]]}, T={T[idx[0]]}, d={d_b[idx[0]]}); the "
                f"waves may exceed the breaking limit")
    q = q.to(dtype=dtype, device=device)
    return stack_waves(fenton_wave_from_solution(
        q[i], H[i], T[i], d_b[i], Uc_b[i], M, n_modes=n_modes)
        for i in range(H.size))


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
