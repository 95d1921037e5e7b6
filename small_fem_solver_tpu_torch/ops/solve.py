"""Dense factor-once Cholesky solve (PyTorch counterpart of the dense path
of ``small_fem_solver_tpu/ops/solve.py``).

The free-free block is symmetrically Jacobi-scaled before the Cholesky
(beam stiffness entries span ~8 orders of magnitude between axial and
rotational DOFs), and ``solve_factored`` runs iterative refinement rounds
so float32 solves recover near-working precision.  PCG and the
matrix-free operators are not ported yet (ROADMAP.md, Queue A item 5).
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
