"""Dense LU and factor-once Cholesky solves (PyTorch counterpart of the
dense path of ``small_fem_solver_tpu/ops/solve.py``).

``solve_dense`` is the reference's LU solve of the free-free block, with
an optional minimum-norm least-squares fallback for a singular block.  For
the Cholesky path the free-free block is symmetrically Jacobi-scaled
before the factorization (beam stiffness entries span ~8 orders of
magnitude between axial and rotational DOFs), and ``solve_factored`` runs
iterative refinement rounds so float32 solves recover near-working
precision.  ``ground_with_springs`` grounds K through foundation springs
for the dynamics paths.  PCG and the matrix-free operators are not ported
yet (ROADMAP.md, Queue A item 5).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def free_fixed_dofs(fixed_mask) -> tuple[np.ndarray, np.ndarray]:
    """(free_dofs, fixed_dofs) int arrays from a boolean node mask; all 6
    DOFs of a fixed node are clamped."""
    fixed = np.asarray(torch.as_tensor(fixed_mask).cpu())
    dof_fixed = np.repeat(fixed, 6)
    all_dofs = np.arange(dof_fixed.shape[0])
    return all_dofs[~dof_fixed], all_dofs[dof_fixed]


def dof_free_mask(fixed_mask: torch.Tensor) -> torch.Tensor:
    """[n_dof] bool mask: True on free DOFs."""
    return torch.logical_not(fixed_mask).repeat_interleave(6)


def support_spring_nodes(fixed_mask, support_stiffness) -> np.ndarray:
    """Validated foundation-spring diagonal per node ([n_nodes, 6] numpy,
    zero off the supports), shared by every spring-supported path.

    ``support_stiffness`` is [6] (every support alike) or [n_fixed, 6], in
    N/mm for translations and N*mm/rad for rotations.  Negative or
    non-finite entries raise (a non-SPD system would give silent Cholesky
    NaNs), and so does zero total translational stiffness in a direction
    (a rigid-body mode).  Zero rotational springs (pinned pile heads) pass
    unless there is a single support node.  Collinear supports with zero
    rotational springs are not detected here.
    """
    fixed = np.asarray(torch.as_tensor(fixed_mask).cpu())
    fixed_nodes = np.where(fixed)[0]
    if fixed_nodes.size == 0:
        raise ValueError("support_stiffness needs at least one support node")
    k = np.broadcast_to(np.asarray(support_stiffness, np.float64),
                        (fixed_nodes.size, 6))
    if not (np.all(k >= 0) and np.isfinite(k).all()):  # negatives, NaN, inf
        raise ValueError("support_stiffness entries must be finite and "
                         f">= 0 (got {np.asarray(support_stiffness)!r})")
    if np.any(k[:, :3].sum(axis=0) == 0):
        raise ValueError(
            "support_stiffness has zero total translational stiffness in "
            "at least one direction: the structure would float (singular "
            "system). Use a stiff spring (e.g. 1e13 N/mm) for a rigid "
            "direction.")
    if fixed_nodes.size == 1 and np.any(k[0, 3:] == 0):
        raise ValueError(
            "a SINGLE support node with a zero rotational spring leaves a "
            "rigid-body rotation about that point (singular system); "
            "pinned (zero-rotation) pile heads need >= 2 NON-COLLINEAR "
            "support nodes or a stiff rotational spring")
    ks = np.zeros((fixed.shape[0], 6))
    ks[fixed_nodes] = k
    return ks


def ground_with_springs(K: torch.Tensor, fixed_mask, support_stiffness,
                        dtype: torch.dtype):
    """(K + diag(k), free = all DOFs): ground an assembled K through
    validated foundation springs (:func:`support_spring_nodes`), the
    grounding step of the spring-supported eigen and response paths.
    Reaction-recovering paths keep K springless and add the diagonal only
    inside the factorization (``api._spring_dfac``)."""
    ks = support_spring_nodes(fixed_mask, support_stiffness)
    k = torch.as_tensor(ks.reshape(-1), dtype=dtype, device=K.device)
    return K + torch.diag(k), torch.arange(K.shape[0], device=K.device)


def _min_norm_lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution of the symmetric system A x = b.

    Rows and columns that are exactly zero (a DOF no element touches) are
    decoupled: their unknowns are 0 in the minimum-norm solution, whatever
    b holds there, and are set so exactly.  The rest is solved through
    ``eigh`` with LAPACK ``gelsd``'s default cutoff, eigenvalues at most
    eps * n * max |lambda| dropped.  ``torch.linalg.lstsq`` is not used: on
    CUDA it offers only the full-rank ``gels`` routine.
    """
    live = torch.nonzero(torch.any(A != 0, dim=1)).reshape(-1)
    A_l = A[live][:, live]
    lam, V = torch.linalg.eigh(A_l)
    cut = torch.finfo(A.dtype).eps * A.shape[0] * lam.abs().max()
    inv = torch.where(lam.abs() > cut, 1.0 / torch.where(lam == 0, 1.0, lam),
                      0.0)
    x = torch.zeros_like(b)
    x[live] = V @ (inv * (V.mT @ b[live]))
    return x


def solve_dense(K: torch.Tensor, F: torch.Tensor, free_dofs,
                lstsq_fallback: bool = False) -> torch.Tensor:
    """U (full length, zeros at fixed DOFs) from dense K and the load vector
    F: LU solve of the free-free block, as the reference's solver does.

    With ``lstsq_fallback`` a singular block (the LU reports a zero pivot or
    gives a non-finite solution) is solved instead by the minimum-norm
    least squares of :func:`_min_norm_lstsq`; that check reads the LU's
    status on the host.
    """
    free = torch.as_tensor(free_dofs, device=K.device)
    K_ff = K[free][:, free]
    F_f = F[free]
    U_f, info = torch.linalg.solve_ex(K_ff, F_f)
    if lstsq_fallback and (int(info) != 0
                           or not bool(torch.isfinite(U_f).all())):
        U_f = _min_norm_lstsq(K_ff, F_f)
    U = torch.zeros_like(F)
    U[free] = U_f
    return U


def reactions_dense(K: torch.Tensor, U: torch.Tensor, F: torch.Tensor,
                    fixed_dofs) -> torch.Tensor:
    """R = K U - F at the fixed DOFs, shaped [..., n_fixed_nodes, 6] for
    ``U``/``F`` of shape [..., n_dof]."""
    R = U @ K.mT - F
    fixed = torch.as_tensor(fixed_dofs, device=K.device)
    return R[..., fixed].reshape(*U.shape[:-1], -1, 6)


class DenseFactor(NamedTuple):
    chol: torch.Tensor       # lower Cholesky factor of the SCALED K_ff
    scale: torch.Tensor      # d = diag(K_ff)^(-1/2) symmetric scaling
    K_ff: torch.Tensor       # unscaled free-free block (for refinement)
    free_dofs: torch.Tensor
    n_dof: int


def factor_dense(K: torch.Tensor, free_dofs) -> DenseFactor:
    """Cholesky-factor the Jacobi-scaled free-free block once."""
    free = torch.as_tensor(free_dofs, device=K.device)
    K_ff = K[free][:, free]
    d = 1.0 / torch.sqrt(torch.diagonal(K_ff))
    L = torch.linalg.cholesky(K_ff * d[:, None] * d[None, :])
    return DenseFactor(chol=L, scale=d, K_ff=K_ff, free_dofs=free,
                       n_dof=K.shape[0])


def _solve_scaled(fac: DenseFactor, F_f: torch.Tensor) -> torch.Tensor:
    """Solve K_ff X = F_f via the scaled factor; F_f is [n_free, B]."""
    y = fac.scale[:, None] * F_f
    y = torch.linalg.solve_triangular(fac.chol, y, upper=False)
    y = torch.linalg.solve_triangular(fac.chol.mT, y, upper=True)
    return fac.scale[:, None] * y


def solve_factored(fac: DenseFactor, F: torch.Tensor,
                   refine_steps: int = 1) -> torch.Tensor:
    """Solve for one RHS [n_dof] or a batch [B, n_dof] with one factor,
    plus ``refine_steps`` rounds of iterative refinement."""
    Fb = F if F.ndim == 2 else F[None]
    F_f = Fb[:, fac.free_dofs].T                      # [n_free, B]
    U_f = _solve_scaled(fac, F_f)
    for _ in range(refine_steps):
        U_f = U_f + _solve_scaled(fac, F_f - fac.K_ff @ U_f)
    U = torch.zeros_like(Fb)
    U[:, fac.free_dofs] = U_f.T
    return U if F.ndim == 2 else U[0]
