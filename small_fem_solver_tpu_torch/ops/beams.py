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
  translation DOF;
- member end releases (a 2-bit code per member: bit 0 pins the node-1
  end, bit 1 the node-2 end) statically condense the two local bending
  rotations of a pinned end out of K_local before the rotation to global
  axes.
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


def local_stiffness(L_mm: torch.Tensor, sec: TubeSections, sect_id, E, G,
                    include_shear: bool = True) -> torch.Tensor:
    """Stacked local stiffness ``K_local[M, 12, 12]`` in N/mm units."""
    coeffs = stiffness_coeffs(L_mm, sec, sect_id, E, G, include_shear)
    pat = torch.as_tensor(_KPAT, dtype=L_mm.dtype, device=L_mm.device)
    return (coeffs @ pat).reshape(-1, 12, 12)


def _rotate(R: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """``T^T K T`` of [M, 3b, 3b] matrices K with T block-diagonal in the
    member rotations R [M, 3, 3], block by block (no T is formed)."""
    b = K.shape[-1] // 3
    K5 = K.reshape(-1, b, 3, b, 3)
    return torch.einsum("mar,mAaBb,mbs->mArBs", R, K5, R).reshape(
        -1, 3 * b, 3 * b)


def global_stiffness_direct(R: torch.Tensor,
                            coeffs: torch.Tensor) -> torch.Tensor:
    """``K_global[M, 12, 12]`` from the local axes R [M, 3, 3] and the
    stiffness coefficients [M, 10]: every 3x3 node block of T^T K_local T
    is R^T K_local[B1, B2] R, formed without T."""
    pat = torch.as_tensor(_KPAT, dtype=coeffs.dtype, device=coeffs.device)
    return _rotate(R, (coeffs @ pat).reshape(-1, 12, 12))


def quadrant_stack(K: torch.Tensor) -> torch.Tensor:
    """[M, 12, 12] element matrices -> their (ii, ij, ji, jj)-major
    quadrant stack [4M, 6, 6], the contribution layout of
    :func:`.assembly.assemble_bcsr`."""
    Q = K.reshape(-1, 2, 6, 2, 6)
    return torch.cat([Q[:, 0, :, 0], Q[:, 0, :, 1], Q[:, 1, :, 0],
                      Q[:, 1, :, 1]])


def global_stiffness_quadrants(R: torch.Tensor,
                               coeffs: torch.Tensor) -> torch.Tensor:
    """The element stiffness as the quadrant stack [4M, 6, 6] in
    (ii, ij, ji, jj)-major order (:func:`quadrant_stack`)."""
    return quadrant_stack(global_stiffness_direct(R, coeffs))


def element_global_stiffness(coords: torch.Tensor, conn: torch.Tensor,
                             sec: TubeSections, sect_id, E, G,
                             include_shear: bool = True) -> torch.Tensor:
    """``K_global[M, 12, 12]`` only, the assembly fast path: no T and no
    K_local are kept (:func:`global_stiffness_direct`).  No releases."""
    dL = coords[conn[:, 1]] - coords[conn[:, 0]]
    L = torch.linalg.norm(dL, dim=-1)
    return global_stiffness_direct(
        local_axes(dL, L),
        stiffness_coeffs(L * 1000.0, sec, sect_id, E, G, include_shear))


def lane_quadrants(c1: torch.Tensor, c2: torch.Tensor, scale,
                   sec: TubeSections, sect_id, E, G,
                   quad: torch.Tensor) -> torch.Tensor:
    """Global-axes quadrants [L, 6, 6] of the members with end coordinates
    c1 / c2 [L, 3] (m; times ``scale`` when given), each lane's own
    quadrant ``quad`` [L] (0 ii, 1 ij, 2 ji, 3 jj): the per-lane form of
    :func:`global_stiffness_quadrants` that the direct-write assembly
    emits in block order."""
    d = c2 - c1 if scale is None else (c2 - c1) * scale
    L = torch.linalg.norm(d, dim=-1)
    Kl = local_stiffness(L * 1000.0, sec, sect_id, E, G).reshape(
        -1, 2, 6, 2, 6)
    lanes = torch.arange(Kl.shape[0], device=Kl.device)
    return _rotate(local_axes(d, L), Kl[lanes, quad // 2, :, quad % 2, :])


def matvec12(A: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Batched matvec ``A[m] @ u[..., m, :]`` (``A``: [M, r, 12],
    ``u``: [..., M, 12]; result [..., M, r])."""
    return torch.einsum("mrj,...mj->...mr", A, u)


# Member end releases: bit 0 pins the node-1 end, bit 1 the node-2 end.  A
# pinned end releases its two local bending rotations (ry, rz); axial,
# shear and torsion stay connected.
RELEASE_NONE, RELEASE_PIN1, RELEASE_PIN2, RELEASE_PIN_BOTH = 0, 1, 2, 3
_REL_MASKS = np.zeros((4, 12))
_REL_MASKS[1, [4, 5]] = 1.0
_REL_MASKS[2, [10, 11]] = 1.0
_REL_MASKS[3, [4, 5, 10, 11]] = 1.0


def _release_mask(release, ref: torch.Tensor) -> torch.Tensor:
    """[M, 12] mask, 1 on the released DOFs of each member."""
    masks = torch.as_tensor(_REL_MASKS, dtype=ref.dtype, device=ref.device)
    return masks[torch.as_tensor(release, device=ref.device).long()]


def release_transform(K_local: torch.Tensor, release) -> torch.Tensor:
    """Kept-DOF expansion ``W [M, 12, 12]`` of the end releases:
    ``u_full = W u_kept`` gives the released rotations their zero-moment
    values ``u_r = -K_rr^{-1} K_rk u_k`` (exact static condensation), so
    ``W^T K_local W`` is the released element stiffness and ``W^T K_G W``
    the consistent projection of any other element matrix.

    ``A = P K P + (I - P)`` is SPD for bending-rotation releases, so the
    batched solve is a Cholesky."""
    m = _release_mask(release, K_local)
    eye = torch.eye(12, dtype=K_local.dtype, device=K_local.device)
    A = K_local * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[:, :, None]
    X = torch.cholesky_solve(K_local * m[:, :, None],
                             torch.linalg.cholesky(A))       # A^-1 P K
    return (eye - X) * (1.0 - m)[:, None, :]                 # released cols 0


def apply_releases(K_local: torch.Tensor, release, W=None) -> torch.Tensor:
    """Released local stiffness ``W^T K W`` with exact zeros on the released
    rows and columns (the congruence leaves roundoff there)."""
    if W is None:
        W = release_transform(K_local, release)
    keep = 1.0 - _release_mask(release, K_local)
    return (W.mT @ K_local @ W) * keep[:, :, None] * keep[:, None, :]


def release_W(coords: torch.Tensor, conn: torch.Tensor, sec: TubeSections,
              sect_id, E, G, release) -> torch.Tensor:
    """Local-frame release expansion ``W`` from the raw (uncondensed)
    element stiffness, for projecting companion element matrices (the
    geometric stiffness) consistently: ``K_G_released = W^T K_G W``."""
    L = torch.linalg.norm(coords[conn[:, 1]] - coords[conn[:, 0]], dim=-1)
    return release_transform(local_stiffness(L * 1000.0, sec, sect_id, E, G),
                             release)


def element_stiffness(coords: torch.Tensor, conn: torch.Tensor,
                      sec: TubeSections, sect_id, E, G,
                      include_shear: bool = True, release=None):
    """All per-element matrices in one shot:
    (K_global [M,12,12], K_local [M,12,12], T [M,12,12], L_m [M]) with
    ``K_global = T^T K_local T``.  ``release`` ([M] codes, ``None``: all
    rigid) condenses pinned end rotations out of K_local before the
    rotation, so assembly, condensation chains and force recovery all see
    the released element."""
    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=-1)
    T = transformation_matrices(local_axes(dL, L))
    K_local = local_stiffness(L * 1000.0, sec, sect_id, E, G, include_shear)
    if release is not None:
        K_local = apply_releases(K_local, release)
    return T.transpose(-1, -2) @ K_local @ T, K_local, T, L


def internal_forces(K_local: torch.Tensor, T: torch.Tensor,
                    u_elem: torch.Tensor):
    """Local end forces of every member from ``u_elem`` [..., M, 12]
    (global element displacements, mm / rad): (F1 [..., M, 6],
    F2 [..., M, 6]) in N and N*mm, with the reference's sign convention
    (node-1 forces negated)."""
    F_local = matvec12(K_local, matvec12(T, u_elem))
    return -F_local[..., :6], F_local[..., 6:]
