"""Symmetric eigensolvers (PyTorch counterpart of
``small_fem_solver_tpu/ops/eigen.py``).

The JAX package wrote these as cyclic Jacobi and Bathe subspace iteration
only because its TPU backend has no ``eigh`` (``ops/eigen.py:3-7``).
LAPACK and cuSOLVER have it, so here the four functions keep their JAX
signatures and sit on ``torch.linalg.eigh``, with a batched Cholesky for
the generalized pencils: ``jacobi_eigh`` and ``eigh_general_small`` are
exact to roundoff, and ``subspace_largest`` / ``subspace_eigh`` return the
exact largest / lowest pairs (the JAX iterations converge to them; they
differ by their convergence error).  The iteration controls (``sweeps``,
``n_iter``, ``n_extra``) are accepted for the signature and unused.
"""
from __future__ import annotations

import torch


def jacobi_eigh(A: torch.Tensor, sweeps: int = 12):
    """Eigendecomposition of symmetric ``A [..., m, m]``: ``(w, V)`` with
    ascending eigenvalues and the eigenvectors in the columns of V."""
    return torch.linalg.eigh(A)


def eigh_general_small(A: torch.Tensor, B: torch.Tensor, sweeps: int = 12):
    """Generalized symmetric ``A v = lam B v`` for small dense blocks
    ([..., m, m], B SPD): ``(lam ascending, V)`` with V B-orthonormal.

    As in the JAX package, B is symmetrically diagonal-scaled and given a
    dtype-relative ridge (32 m eps) before its Cholesky: subspace callers
    pass Gram matrices whose condition number is the square of the
    pencil's, and the ridge only moves directions below the dtype's noise
    floor (their lam go to the top of the spectrum)."""
    m = B.shape[-1]
    d = torch.diagonal(B, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.where(d > 0, d, torch.ones_like(d)))
    Bs = B * s[..., :, None] * s[..., None, :]
    As = A * s[..., :, None] * s[..., None, :]
    ridge = 32.0 * m * torch.finfo(B.dtype).eps
    Bs = Bs + ridge * torch.eye(m, dtype=B.dtype, device=B.device)
    L = torch.linalg.cholesky(Bs)
    Y = torch.linalg.solve_triangular(L, As, upper=False)
    C = torch.linalg.solve_triangular(L, Y.mT, upper=False)
    lam, Vt = torch.linalg.eigh(0.5 * (C + C.mT))
    V = s[..., :, None] * torch.linalg.solve_triangular(L.mT, Vt, upper=True)
    return lam, V


def subspace_largest(A: torch.Tensor, n_modes: int,
                     n_extra: int | None = None, n_iter: int = 60,
                     sweeps: int = 12):
    """The largest ``n_modes`` eigenpairs of symmetric ``A [..., n, n]``:
    ``(lam descending, V orthonormal)``."""
    lam, V = torch.linalg.eigh(A)
    return (lam.flip(-1)[..., :n_modes], V.flip(-1)[..., :n_modes])


def subspace_eigh(K: torch.Tensor, M: torch.Tensor, n_modes: int,
                  n_extra: int | None = None, n_iter: int = 24,
                  sweeps: int = 12):
    """The lowest ``n_modes`` generalized eigenpairs of SPD ``(K, M)``
    ([..., n, n]): ``(lam [..., n_modes], V [..., n, n_modes])`` with V
    M-orthonormal."""
    lam, V = eigh_general_small(K, M)
    return lam[..., :n_modes], V[..., :n_modes]
