"""Steady-wave set-up of the plain reference, in float64 numpy.

Every wave is worked out again from (H, T, d, U_c); nothing is read from
the program.  A wave is a dict of the Fourier form that both wave theories
share (theta = k x - omega t, z from the mean water level, d the depth):

    eta(x, t)  = sum_j E_j cos(j theta)
    u(x, z, t) = sum_j U_j cosh(j k (z + d)) / cosh(j k d) cos(j theta)
    w(x, z, t) = sum_j U_j sinh(j k (z + d)) / cosh(j k d) sin(j theta)

plus the uniform current U_c, added where a point is wet.

- Fenton: the stream-function theory of Rienecker & Fenton (J. Fluid Mech.
  104, 1981) with N collocation points over half a wavelength, solved by
  Newton's method with its Jacobian written out and height continuation.
- Stokes: Fenton's fifth-order theory (J. Waterway, Port, Coastal and Ocean
  Eng. 111(2), 1985, with the erratum to A44 / C2); the coefficient tables
  below are that paper's, as the program's ``ops/stokes.py`` also writes
  them.
"""
from __future__ import annotations

import math

import numpy as np

G = 9.81


def airy_k(omega, d, n_iter: int = 60):
    """Linear dispersion omega^2 = g k tanh(k d), Newton from deep water."""
    omega, d = np.asarray(omega, np.float64), np.asarray(d, np.float64)
    k = omega**2 / G
    for _ in range(n_iter):
        th = np.tanh(k * d)
        f = omega**2 - G * k * th
        df = -G * (th + k * d / np.cosh(k * d) ** 2)
        k = k - f / df
    return k


# --------------------------------------------------------------- Fenton --

def _fenton_system(q, d, H, omega, M: int):
    """The 2M + 5 collocation equations of unknowns q [C, 2M+5] =
    [eta_0..eta_M (from the bed), B_1..B_M, B0, k, Q, R] and their
    Jacobian [C, 2M+5, 2M+5], written out (float64)."""
    C, n = q.shape
    eta = q[:, :M + 1]
    B = q[:, M + 1:2 * M + 1]
    B0, k, Q, R = (q[:, 2 * M + 1 + i] for i in range(4))
    j = np.arange(1, M + 1)
    theta = np.pi * np.arange(M + 1) / M
    cjt = np.cos(np.outer(theta, j))                      # [M+1, M]
    sjt = np.sin(np.outer(theta, j))
    jk = j * k[:, None]                                   # [C, M]
    tdk = np.tanh(jk * d[:, None])[:, None, :]            # [C, 1, M]
    A = jk[:, None, :] * eta[:, :, None]                  # [C, M+1, M]
    ch_d = np.cosh(jk * d[:, None])[:, None, :]
    Cm = np.cosh(A) / ch_d
    Sm = np.sinh(A) / ch_d
    jk3 = jk[:, None, :]
    psi = B0[:, None] * eta + np.einsum("cmj,cj->cm", Sm * cjt, B) - Q[:, None]
    u = B0[:, None] + np.einsum("cmj,cj->cm", jk3 * Cm * cjt, B)
    w = np.einsum("cmj,cj->cm", jk3 * Sm * sjt, B)
    mean = (0.5 * eta[:, 0] + eta[:, 1:M].sum(1) + 0.5 * eta[:, M]) / M - d
    r = np.concatenate([psi, 0.5 * (u * u + w * w) + G * eta - R[:, None],
                        np.stack([mean, eta[:, 0] - eta[:, M] - H,
                                  -B0 * k - omega], 1)], 1)
    # d/dk of the profiles: j eta S - j d tanh(j k d) C and the like
    jv = j[None, None, :]
    dC_dk = jv * eta[:, :, None] * Sm - jv * d[:, None, None] * tdk * Cm
    dS_dk = jv * eta[:, :, None] * Cm - jv * d[:, None, None] * tdk * Sm
    J = np.zeros((C, n, n))
    m = np.arange(M + 1)
    # psi rows 0..M
    J[:, m, m] = u
    J[:, :M + 1, M + 1:2 * M + 1] = Sm * cjt
    J[:, :M + 1, 2 * M + 1] = eta
    J[:, :M + 1, 2 * M + 2] = np.einsum("cmj,cj->cm", dS_dk * cjt, B)
    J[:, :M + 1, 2 * M + 3] = -1.0
    # Bernoulli rows M+1..2M+1
    du_deta = np.einsum("cmj,cj->cm", jk3**2 * Sm * cjt, B)
    dw_deta = np.einsum("cmj,cj->cm", jk3**2 * Cm * sjt, B)
    du_dB = jk3 * Cm * cjt
    dw_dB = jk3 * Sm * sjt
    du_dk = np.einsum("cmj,cj->cm", (jv * Cm + jk3 * dC_dk) * cjt, B)
    dw_dk = np.einsum("cmj,cj->cm", (jv * Sm + jk3 * dS_dk) * sjt, B)
    rb = M + 1 + m
    J[:, rb, m] = u * du_deta + w * dw_deta + G
    J[:, M + 1:2 * M + 2, M + 1:2 * M + 1] = (u[:, :, None] * du_dB
                                               + w[:, :, None] * dw_dB)
    J[:, M + 1:2 * M + 2, 2 * M + 1] = u
    J[:, M + 1:2 * M + 2, 2 * M + 2] = u * du_dk + w * dw_dk
    J[:, M + 1:2 * M + 2, 2 * M + 4] = -1.0
    # mean depth, height, period
    wts = np.full(M + 1, 1.0 / M)
    wts[0] = wts[M] = 0.5 / M
    J[:, 2 * M + 2, :M + 1] = wts
    J[:, 2 * M + 3, 0], J[:, 2 * M + 3, M] = 1.0, -1.0
    J[:, 2 * M + 4, 2 * M + 1] = -k
    J[:, 2 * M + 4, 2 * M + 2] = -B0
    return r, J


def fenton_waves(H, T, d, U_c, N: int, n_cont: int = 10, n_newton: int = 12):
    """Fenton stream-function waves of heights ``H`` [C] (period ``T``,
    depth ``d``, current ``U_c`` scalars), N modes each: a dict of [C] and
    [C, N] float64 arrays.  Raises if a wave's collocation residual stays
    above 1e-9 g d."""
    H = np.atleast_1d(np.asarray(H, np.float64))
    C, M, n = H.size, int(N), 2 * int(N) + 5
    omega = 2.0 * math.pi / float(T)
    dd = np.full(C, float(d))
    k0 = airy_k(omega, float(d))
    theta = np.pi * np.arange(M + 1) / M
    q = np.zeros((C, n))
    a = H / n_cont / 2.0
    q[:, :M + 1] = float(d) + a[:, None] * np.cos(theta)
    q[:, M + 1] = a * omega / (k0 * np.tanh(k0 * float(d)))
    q[:, 2 * M + 1] = -omega / k0
    q[:, 2 * M + 2] = k0
    q[:, 2 * M + 3] = -omega / k0 * float(d)
    q[:, 2 * M + 4] = 0.5 * (omega / k0) ** 2 + G * float(d)
    om = np.full(C, omega)
    for i in range(n_cont):
        Hi = H * (i + 1.0) / n_cont
        for _ in range(n_newton):
            r, J = _fenton_system(q, dd, Hi, om, M)
            q = q - np.linalg.solve(J, r[..., None])[..., 0]
    r, _ = _fenton_system(q, dd, H, om, M)
    if not np.all(np.abs(r).max(axis=1) <= 1e-9 * G * float(d)):
        raise ValueError("reference Fenton solve did not converge")
    eta, B, k = q[:, :M + 1], q[:, M + 1:2 * M + 1], q[:, 2 * M + 2]
    j = np.arange(1, M + 1)
    wts = np.ones(M + 1)
    wts[0] = wts[M] = 0.5
    E = (2.0 / M) * ((wts * (eta - float(d))) @ np.cos(np.outer(theta, j)))
    E[:, -1] *= 0.5
    return dict(k=k, omega=np.full(C, omega), d=dd, U_c=np.full(C, U_c),
                T=np.full(C, float(T)), E=E, U=j * k[:, None] * B)


# --------------------------------------------------------------- Stokes --

def _stokes_tables(kd):
    """A_ij, B_ij and C_i of Fenton (1985), Table 1, in S = sech(2 k d)."""
    S = 1.0 / np.cosh(2.0 * kd)
    sh, th = np.sinh(kd), np.tanh(kd)
    cth, Sm = 1.0 / th, 1.0 - S
    A = {
        (1, 1): 1.0 / sh,
        (2, 2): 3.0 * S**2 / (2.0 * Sm**2),
        (3, 1): (-4.0 - 20.0 * S + 10.0 * S**2 - 13.0 * S**3)
        / (8.0 * sh * Sm**3),
        (3, 3): (-2.0 * S**2 + 11.0 * S**3) / (8.0 * sh * Sm**3),
        (4, 2): (12.0 * S - 14.0 * S**2 - 264.0 * S**3 - 45.0 * S**4
                 - 13.0 * S**5) / (24.0 * Sm**5),
        (4, 4): (10.0 * S**3 - 174.0 * S**4 + 291.0 * S**5 + 278.0 * S**6)
        / (48.0 * (3.0 + 2.0 * S) * Sm**5),
        (5, 1): (-1184.0 + 32.0 * S + 13232.0 * S**2 + 21712.0 * S**3
                 + 20940.0 * S**4 + 12554.0 * S**5 - 500.0 * S**6
                 - 3341.0 * S**7 - 670.0 * S**8)
        / (64.0 * sh * (3.0 + 2.0 * S) * (4.0 + S) * Sm**6),
        (5, 3): (4.0 * S + 105.0 * S**2 + 198.0 * S**3 - 1376.0 * S**4
                 - 1302.0 * S**5 - 117.0 * S**6 + 58.0 * S**7)
        / (32.0 * sh * (3.0 + 2.0 * S) * Sm**6),
        (5, 5): (-6.0 * S**3 + 272.0 * S**4 - 1552.0 * S**5 + 852.0 * S**6
                 + 2029.0 * S**7 + 430.0 * S**8)
        / (64.0 * sh * (3.0 + 2.0 * S) * (4.0 + S) * Sm**6),
    }
    B = {
        (2, 2): cth * (1.0 + 2.0 * S) / (2.0 * Sm),
        (3, 1): -3.0 * (1.0 + 3.0 * S + 3.0 * S**2 + 2.0 * S**3)
        / (8.0 * Sm**3),
        (4, 2): cth * (6.0 - 26.0 * S - 182.0 * S**2 - 204.0 * S**3
                       - 25.0 * S**4 + 26.0 * S**5)
        / (6.0 * (3.0 + 2.0 * S) * Sm**4),
        (4, 4): cth * (24.0 + 92.0 * S + 122.0 * S**2 + 66.0 * S**3
                       + 67.0 * S**4 + 34.0 * S**5)
        / (24.0 * (3.0 + 2.0 * S) * Sm**4),
        (5, 3): 9.0 * (132.0 + 17.0 * S - 2216.0 * S**2 - 5897.0 * S**3
                       - 6292.0 * S**4 - 2687.0 * S**5 + 194.0 * S**6
                       + 467.0 * S**7 + 82.0 * S**8)
        / (128.0 * (3.0 + 2.0 * S) * (4.0 + S) * Sm**6),
        (5, 5): 5.0 * (300.0 + 1579.0 * S + 3176.0 * S**2 + 2949.0 * S**3
                       + 1188.0 * S**4 + 675.0 * S**5 + 1326.0 * S**6
                       + 827.0 * S**7 + 130.0 * S**8)
        / (384.0 * (3.0 + 2.0 * S) * (4.0 + S) * Sm**6),
    }
    C0 = np.sqrt(th)
    C2 = C0 * (2.0 + 7.0 * S**2) / (4.0 * Sm**2)
    C4 = C0 * (4.0 + 32.0 * S - 116.0 * S**2 - 400.0 * S**3 - 71.0 * S**4
               + 146.0 * S**5) / (32.0 * Sm**5)
    return A, B, (C0, C2, C4)


def stokes5_waves(H, T, d, U_c, n_modes: int):
    """Fifth-order Stokes waves of heights ``H`` [C]: the dispersion
    omega / k = sqrt(g / k) (C0 + eps^2 C2 + eps^4 C4), eps = k H / 2, by
    Newton's method (complex-step derivative), then the surface and
    velocity series; coefficients zero-padded to ``n_modes``."""
    H = np.atleast_1d(np.asarray(H, np.float64))
    Cn = H.size
    omega = 2.0 * math.pi / float(T)
    d = float(d)

    def resid(k):
        _, _, (C0, C2, C4) = _stokes_tables(k * d)
        eps = k * H / 2.0
        return np.sqrt(G * k) * (C0 + eps**2 * C2 + eps**4 * C4) - omega

    k = np.full(Cn, airy_k(omega, d), dtype=np.float64)
    for _ in range(60):
        dr = resid(k + 1e-30j).imag / 1e-30
        k = k - resid(k) / dr
    kd, eps = k * d, k * H / 2.0
    A, B, (C0, _, _) = _stokes_tables(kd)
    E = np.stack([
        eps + eps**3 * B[3, 1] - eps**5 * (B[5, 3] + B[5, 5]),
        eps**2 * B[2, 2] + eps**4 * B[4, 2],
        -eps**3 * B[3, 1] + eps**5 * B[5, 3],
        eps**4 * B[4, 4],
        eps**5 * B[5, 5]], axis=-1) / k[:, None]
    P = np.stack([
        eps * A[1, 1] + eps**3 * A[3, 1] + eps**5 * A[5, 1],
        eps**2 * A[2, 2] + eps**4 * A[4, 2],
        eps**3 * A[3, 3] + eps**5 * A[5, 3],
        eps**4 * A[4, 4],
        eps**5 * A[5, 5]], axis=-1)
    j = np.arange(1, 6)
    U = (C0 * np.sqrt(G / k))[:, None] * j * P * np.cosh(j * kd[:, None])
    pad = np.zeros((Cn, n_modes - 5))
    return dict(k=k, omega=np.full(Cn, omega), d=np.full(Cn, d),
                U_c=np.full(Cn, U_c), T=np.full(Cn, float(T)),
                E=np.concatenate([E, pad], 1), U=np.concatenate([U, pad], 1))


def make_waves(theory: dict, H, T, d, U_c):
    """The waves of a configuration's ``wave`` entry for heights ``H``."""
    if theory["model"] == "fenton":
        return fenton_waves(H, T, d, U_c, theory["N"])
    if theory["model"] == "stokes":
        if theory["N"] != 5:
            raise ValueError("the reference's Stokes theory is fifth order")
        return stokes5_waves(H, T, d, U_c, theory["n_modes"])
    raise ValueError(f"unknown wave model {theory['model']!r}")


def select(waves: dict, idx) -> dict:
    """Waves ``idx`` of a batch."""
    return {n: v[idx] for n, v in waves.items()}
