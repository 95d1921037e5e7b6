"""Batched 12-DOF 3D Timoshenko beam elements (PyTorch counterpart of
``small_fem_solver_tpu/ops/beams.py``).

The local axes, local stiffness and global stiffness of all members are
stacked ``[M, 12, 12]`` tensors:

- local x along the member; vertical members (|l_x . z| > 0.999) use
  l_y = z x l_x (fallback (0, 1, 0) when degenerate), l_z = l_x x l_y;
  others l_z = normalize(l_x x z), l_y = l_z x l_x;
- Timoshenko shear parameters Phi_y = 12 E Iz / (G Az L^2),
  Phi_z = 12 E Iy / (G Ay L^2);
- lengths in mm (L_mm = 1000 L_m), E and G in MPa: K is N/mm per
  translation DOF.

Member end releases are not ported yet (ROADMAP.md, Queue A item 3).
"""
from __future__ import annotations

import numpy as np
import torch

from .sections import TubeSections

_VERTICAL_COS = 0.999


def local_axes(dL: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """Rotation matrices ``R[M, 3, 3]`` with rows (l_x, l_y, l_z)."""
    lx = dL / L[:, None]
    vertical = torch.abs(lx[:, 2]) > _VERTICAL_COS
    zhat = torch.zeros_like(lx)
    zhat[:, 2] = 1.0
    yhat = torch.zeros_like(lx)
    yhat[:, 1] = 1.0

    ly_v = torch.linalg.cross(zhat, lx)
    ly_v_n = torch.linalg.norm(ly_v, dim=-1)
    degen = ly_v_n <= 1e-10
    safe_n = torch.where(degen, torch.ones_like(ly_v_n), ly_v_n)
    ly_v = torch.where(degen[:, None], yhat, ly_v / safe_n[:, None])
    lz_v = torch.linalg.cross(lx, ly_v)

    lz_g = torch.linalg.cross(lx, zhat)
    lz_g_n = torch.linalg.norm(lz_g, dim=-1)
    lz_g = lz_g / torch.where(lz_g_n <= 1e-30, torch.ones_like(lz_g_n),
                              lz_g_n)[:, None]
    ly_g = torch.linalg.cross(lz_g, lx)

    ly = torch.where(vertical[:, None], ly_v, ly_g)
    lz = torch.where(vertical[:, None], lz_v, lz_g)
    return torch.stack([lx, ly, lz], dim=1)


def transformation_matrices(R: torch.Tensor) -> torch.Tensor:
    """Block-diagonal ``T[M, 12, 12]`` with R on the four 3x3 blocks."""
    T = R.new_zeros(R.shape[0], 12, 12)
    for b in range(4):
        T[:, 3 * b:3 * b + 3, 3 * b:3 * b + 3] = R
    return T


def _build_kpat() -> np.ndarray:
    """Constant [10, 144] pattern: K_local = sum_c coeff_c * pattern_c, one
    pattern per independent stiffness coefficient (axial; 12bz, 6bzL,
    (4+Phi_y)bzL^2, (2-Phi_y)bzL^2; the same for y-bending; torsion)."""
    P = np.zeros((10, 12, 12))

    def sym(c, i, j, v):
        P[c, i, j] = v
        P[c, j, i] = v

    sym(0, 0, 0, 1); sym(0, 6, 6, 1); sym(0, 0, 6, -1)
    sym(1, 1, 1, 1); sym(1, 7, 7, 1); sym(1, 1, 7, -1)
    sym(2, 1, 5, 1); sym(2, 1, 11, 1); sym(2, 7, 5, -1); sym(2, 7, 11, -1)
    sym(3, 5, 5, 1); sym(3, 11, 11, 1)
    sym(4, 5, 11, 1)
    sym(5, 2, 2, 1); sym(5, 8, 8, 1); sym(5, 2, 8, -1)
    sym(6, 2, 4, -1); sym(6, 2, 10, -1); sym(6, 8, 4, 1); sym(6, 8, 10, 1)
    sym(7, 4, 4, 1); sym(7, 10, 10, 1)
    sym(8, 4, 10, 1)
    sym(9, 3, 3, 1); sym(9, 9, 9, 1); sym(9, 3, 9, -1)
    return P.reshape(10, 144)


_KPAT = _build_kpat()


def stiffness_coeffs(L_mm: torch.Tensor, sec: TubeSections, sect_id, E, G,
                     include_shear: bool = True) -> torch.Tensor:
    """The 10 independent stiffness coefficients ``[M, 10]``."""
    L = L_mm
    A, Iy, Iz, Ix = (sec.Ax[sect_id], sec.Iy[sect_id], sec.Iz[sect_id],
                     sec.Ix[sect_id])
    Ay, Az = sec.Ay[sect_id], sec.Az[sect_id]
    if include_shear:
        # degenerate sections (zero shear area) fall back to Euler-Bernoulli
        Az_safe = torch.where(Az > 0, Az, torch.ones_like(Az))
        Ay_safe = torch.where(Ay > 0, Ay, torch.ones_like(Ay))
        Phi_y = torch.where(Az > 0, 12.0 * E * Iz / (G * Az_safe * L**2),
                            torch.zeros_like(L))
        Phi_z = torch.where(Ay > 0, 12.0 * E * Iy / (G * Ay_safe * L**2),
                            torch.zeros_like(L))
    else:
        Phi_y = Phi_z = torch.zeros_like(L)
    alpha = E * A / L
    bz = E * Iz / ((1.0 + Phi_y) * L**3)
    by = E * Iy / ((1.0 + Phi_z) * L**3)
    tors = G * Ix / L
    return torch.stack([
        alpha,
        12.0 * bz, 6.0 * bz * L, (4.0 + Phi_y) * bz * L**2,
        (2.0 - Phi_y) * bz * L**2,
        12.0 * by, 6.0 * by * L, (4.0 + Phi_z) * by * L**2,
        (2.0 - Phi_z) * by * L**2,
        tors,
    ], dim=-1)


def matvec12(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Batched matvec ``A[m] @ u[..., m, :]`` (``A``: [M, r, 12],
    ``u``: [..., M, 12]; result [..., M, r])."""
    return torch.einsum("mrj,...mj->...mr", A, u)


def element_stiffness(coords: torch.Tensor, conn: torch.Tensor,
                      sec: TubeSections, sect_id, E, G,
                      include_shear: bool = True, release=None):
    """All per-element matrices in one shot:
    (K_global [M,12,12], K_local [M,12,12], T [M,12,12], L_m [M]) with
    ``K_global = T^T K_local T``."""
    if release is not None:
        raise NotImplementedError(
            "member end releases are not ported yet (ROADMAP.md, Queue A "
            "item 3: model and load options)")
    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=-1)
    T = transformation_matrices(local_axes(dL, L))
    coeffs = stiffness_coeffs(L * 1000.0, sec, sect_id, E, G, include_shear)
    pat = torch.as_tensor(_KPAT, dtype=L.dtype, device=L.device)
    K_local = (coeffs @ pat).reshape(-1, 12, 12)
    return T.transpose(-1, -2) @ K_local @ T, K_local, T, L
