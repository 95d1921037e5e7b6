"""Dense LU and factor-once Cholesky solves, and matrix-free PCG (PyTorch
counterpart of ``small_fem_solver_tpu/ops/solve.py``).

``solve_dense`` is the reference's LU solve of the free-free block, with
an optional minimum-norm least-squares fallback for a singular block.  For
the Cholesky path the free-free block is symmetrically Jacobi-scaled
before the factorization (beam stiffness entries span ~8 orders of
magnitude between axial and rotational DOFs), and ``solve_factored`` runs
iterative refinement rounds so float32 solves recover near-working
precision.  ``ground_with_springs`` grounds K through foundation springs
for the dynamics paths.

:func:`pcg` is preconditioned conjugate gradients on a BC-projected
operator (:func:`projected_operator`) with the 6x6 block-Jacobi
(:func:`block_jacobi_preconditioner`) or scalar Jacobi preconditioner;
``ops/coarse.py`` adds the two-level one.  Its loop runs on the host: the
CG body is enqueued ``check_every`` iterations at a time, each iteration
frozen on the device (``torch.where`` on a "still running" flag) once the
relative residual meets the tolerance, and the host reads the flag only
between chunks, so the card is not stalled every iteration and the
result does not depend on the chunk length.  The JAX package runs the
same loop as a device ``while_loop``, and its ``pcg_chunk`` segments
exist because one long TPU program trips the TPU runtime's watchdog
(``small_fem_solver_tpu/ops/solve.py:217-224``); here the chunk length is
only how often the host looks.  Dot products are ``torch.dot`` (no
atomics), so two runs on the card give bit-equal iterates; the stop test
is the JAX package's distributed one, ``sqrt(r.r) / ||b||``, so the
row-sharded solve (``parallel/pcg_dist.py``) runs this same loop with its
own reduction of the dot products.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

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


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each SPD matrix in ``A`` [..., n, n]; a
    matrix that is not positive definite gets an all-NaN factor, as
    ``jnp.linalg.cholesky`` gives (a second-order system past buckling),
    instead of an error.  The host is not synchronised on the card.  The
    factor is filled in place (no second n x n buffer) unless autograd
    records the call: ``cholesky_ex``'s backward reads its output, so a
    differentiated factor is filled out of place."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0)[..., None, None]
    if L.requires_grad:
        return L.masked_fill(bad, float("nan"))
    return L.masked_fill_(bad, float("nan"))


def factor_dense(K: torch.Tensor, free_dofs) -> DenseFactor:
    """Cholesky-factor the Jacobi-scaled free-free block once (NaN when it
    is not positive definite: :func:`cholesky_or_nan`).  ``K`` may carry
    leading batch axes [..., n_dof, n_dof]: one factor each, in one
    batched factorization (the JAX package vmaps the single factor)."""
    free = torch.as_tensor(free_dofs, device=K.device)
    K_ff = K[..., free, :][..., free]
    d = 1.0 / torch.sqrt(torch.diagonal(K_ff, dim1=-2, dim2=-1))
    L = cholesky_or_nan(K_ff * d[..., :, None] * d[..., None, :])
    return DenseFactor(chol=L, scale=d, K_ff=K_ff, free_dofs=free,
                       n_dof=K.shape[-1])


def _solve_scaled(fac: DenseFactor, F_f: torch.Tensor) -> torch.Tensor:
    """Solve K_ff X = F_f via the scaled factor; F_f is [..., n_free, B]
    (the factor's batch axes leading)."""
    y = fac.scale[..., :, None] * F_f
    y = torch.linalg.solve_triangular(fac.chol, y, upper=False)
    y = torch.linalg.solve_triangular(fac.chol.mT, y, upper=True)
    return fac.scale[..., :, None] * y


def solve_factored(fac: DenseFactor, F: torch.Tensor,
                   refine_steps: int = 1) -> torch.Tensor:
    """Solve for one RHS [n_dof] or a batch [B, n_dof] with one factor,
    plus ``refine_steps`` rounds of iterative refinement.  A batch of
    factors (:func:`factor_dense` of [..., n_dof, n_dof]) takes one
    right-hand side each, [..., n_dof], or one [n_dof] shared by all."""
    if fac.chol.ndim > 2:
        return _solve_factored_batch(fac, F, refine_steps)
    Fb = F if F.ndim == 2 else F[None]
    F_f = Fb[:, fac.free_dofs].T                      # [n_free, B]
    U_f = _solve_scaled(fac, F_f)
    for _ in range(refine_steps):
        U_f = U_f + _solve_scaled(fac, F_f - fac.K_ff @ U_f)
    U = torch.zeros_like(Fb)
    U[:, fac.free_dofs] = U_f.T
    return U if F.ndim == 2 else U[0]


def _solve_factored_batch(fac: DenseFactor, F: torch.Tensor,
                          refine_steps: int) -> torch.Tensor:
    """:func:`solve_factored` for a batch of factors, one right-hand side
    each: the JAX package's vmap of the single solve."""
    Fb = F.expand(*fac.scale.shape[:-1], fac.n_dof)
    F_f = Fb[..., fac.free_dofs, None]                # [..., n_free, 1]
    U_f = _solve_scaled(fac, F_f)
    n = F_f.shape[-2]
    K_ff = fac.K_ff.reshape(-1, n, n)
    for _ in range(refine_steps):
        # the residual product matrix by matrix, as the single solve forms
        # it: a batched product rounds differently, and each solve of the
        # batch is to equal its single-matrix solve bit for bit
        KU = torch.stack([K @ u for K, u in zip(K_ff,
                                                U_f.reshape(-1, n, 1))])
        U_f = U_f + _solve_scaled(fac, F_f - KU.reshape(U_f.shape))
    U = Fb.new_zeros(Fb.shape)
    U[..., fac.free_dofs] = U_f[..., 0]
    return U


# ---------------------------------------------------------------------------
# Matrix-free PCG (for BCSR / large meshes)
# ---------------------------------------------------------------------------

PCG_CHECK_EVERY = 50     # iterations between the host's convergence reads


class PCGResult(NamedTuple):
    x: torch.Tensor
    n_iter: torch.Tensor         # 0-d int64, on the device
    residual: torch.Tensor       # ||r|| / ||b||, 0-d, on the device


def local_dots(*pairs) -> tuple:
    """The dot products ``a . b`` of the ``(a, b)`` pairs on one device:
    the default reduction of the CG loop.  A sharded solve passes its own,
    which sums the ranks' partials (``parallel/pcg_dist.py``)."""
    return tuple(torch.dot(a, b) for a, b in pairs)


def pcg_init(matvec: Callable, b: torch.Tensor, precond: Callable,
             x0=None, dots: Callable = local_dots) -> tuple:
    """Initial CG state ``(x, r, p, rz, rr, it)``; ``rr`` = r.r carries
    the stop test's residual norm."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    rz, rr = dots((r, z), (r, r))
    return x, r, z, rz, rr, torch.zeros((), dtype=torch.int64,
                                        device=b.device)


def pcg_bnorm(b: torch.Tensor, dots: Callable = local_dots) -> torch.Tensor:
    """||b||, floored at the dtype's smallest normal number (an all-zero
    right-hand side would otherwise report a residual of 0/0)."""
    return torch.clamp(torch.sqrt(dots((b, b))[0]),
                       min=torch.finfo(b.dtype).tiny)


def _pcg_running(state, bnorm, tol: float, it_stop: int) -> torch.Tensor:
    """The device-side "still running" flag: ``it < it_stop`` and the
    relative residual ``sqrt(r.r) / bnorm`` above ``tol``."""
    return torch.logical_and(state[5] < it_stop,
                             torch.sqrt(state[4]) / bnorm > tol)


def _pcg_step(matvec: Callable, precond: Callable, state, bnorm, tol,
              it_stop, dots: Callable) -> tuple:
    """One CG iteration, applied only where the running flag holds (the
    state is left bit for bit as it was once CG has stopped)."""
    x, r, p, rz, rr, it = state
    go = _pcg_running(state, bnorm, tol, it_stop)
    Ap = matvec(p)
    alpha = rz / dots((p, Ap))[0]
    r_new = r - alpha * Ap
    z = precond(r_new)
    rz_new, rr_new = dots((r_new, z), (r_new, r_new))
    return (torch.where(go, x + alpha * p, x), torch.where(go, r_new, r),
            torch.where(go, z + (rz_new / rz) * p, p),
            torch.where(go, rz_new, rz), torch.where(go, rr_new, rr), it + go)


def pcg_run(matvec: Callable, precond: Callable, state, bnorm, tol: float,
            it_stop: int, check_every: int = PCG_CHECK_EVERY,
            dots: Callable = local_dots) -> tuple:
    """Run CG from ``state`` until the relative residual
    ``sqrt(r.r) / bnorm`` is at most ``tol`` or ``it`` reaches
    ``it_stop``.  The host enqueues ``check_every`` iterations, then reads
    the running flag once (the only synchronisation); iterations past the
    stop are frozen on the device, so the returned state is the same for
    every ``check_every``.  ``dots``: the dot-product reduction
    (:func:`local_dots`, or a sharded solve's).  The state is
    re-enterable."""
    check_every = max(int(check_every), 1)
    while bool(_pcg_running(state, bnorm, tol, it_stop)):
        for _ in range(check_every):
            state = _pcg_step(matvec, precond, state, bnorm, tol, it_stop,
                              dots)
    return state


def pcg(matvec: Callable, b: torch.Tensor, precond: Callable | None = None,
        x0=None, tol: float = 1e-10, maxiter: int = 1000,
        check_every: int = PCG_CHECK_EVERY,
        dots: Callable = local_dots) -> PCGResult:
    """Preconditioned conjugate gradients on an SPD ``matvec`` (a closure
    over an already BC-projected operator, :func:`projected_operator`),
    converging on the relative residual ||r|| / ||b|| <= ``tol`` or after
    ``maxiter`` iterations; ``check_every`` and ``dots``: see
    :func:`pcg_run`."""
    if precond is None:
        def precond(r):
            return r
    state = pcg_init(matvec, b, precond, x0, dots)
    bnorm = pcg_bnorm(b, dots)
    x, _, _, _, rr, it = pcg_run(matvec, precond, state, bnorm, tol,
                                 maxiter, check_every, dots)
    return PCGResult(x=x, n_iter=it, residual=torch.sqrt(rr) / bnorm)


def projected_operator(matvec: Callable,
                       free_mask: torch.Tensor) -> Callable:
    """U = 0 on the fixed DOFs by projection: A_c x = P A P x + (I - P) x
    (``free_mask`` [n_dof], 1 on free DOFs).  A_c stays SPD; the solution
    of A_c x = P b has exact zeros on the fixed DOFs and equals the
    partitioned solve on the free ones."""
    def op(x):
        return free_mask * matvec(free_mask * x) + (1.0 - free_mask) * x
    return op


def spd_block_inv(D: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small SPD blocks [..., k, k]: batched Cholesky of
    the symmetrically Jacobi-scaled blocks (the ~1e10 spread between axial
    and bending stiffness needs the scaling), then ``cholesky_inverse``.
    The JAX package inverts through two triangular solves
    (``small_fem_solver_tpu/ops/solve.py:278-297``) because the TPU has no
    float64 LU; that workaround is not needed here."""
    d = torch.diagonal(D, dim1=-2, dim2=-1)
    s = 1.0 / torch.sqrt(torch.where(d > 0, d, torch.ones_like(d)))
    scale = s[..., :, None] * s[..., None, :]
    L, _ = torch.linalg.cholesky_ex(D * scale)
    return torch.cholesky_inverse(L) * scale


def block_jacobi_inverse(diag_blocks: torch.Tensor,
                         free_mask: torch.Tensor) -> torch.Tensor:
    """Masked block-diagonal inverse [n, 6, 6] (identity at fixed DOFs):
    the data of the block-Jacobi preconditioner, computed once a solve."""
    n = diag_blocks.shape[0]
    mask = free_mask.reshape(n, 6)
    eye = torch.eye(6, dtype=diag_blocks.dtype, device=diag_blocks.device)
    D = (diag_blocks * mask[:, :, None] * mask[:, None, :]
         + eye * (1.0 - mask)[:, :, None])
    return spd_block_inv(D)


def block_jacobi_apply(D_inv: torch.Tensor) -> Callable:
    """Preconditioner callable from a precomputed block inverse."""
    n = D_inv.shape[0]

    def precond(r):
        return (D_inv @ r.reshape(n, 6, 1)).reshape(-1)
    return precond


def block_jacobi_preconditioner(diag_blocks: torch.Tensor,
                                free_mask: torch.Tensor) -> Callable:
    """6x6 block-Jacobi preconditioner from the BCSR diagonal blocks
    [n_nodes, 6, 6]; fixed DOFs get identity rows so the projected system
    stays well-posed."""
    return block_jacobi_apply(block_jacobi_inverse(diag_blocks, free_mask))


def jacobi_preconditioner(diag: torch.Tensor,
                          free_mask: torch.Tensor) -> Callable:
    """Scalar Jacobi preconditioner; fixed DOFs (and zero diagonals)
    use 1."""
    d = torch.where(free_mask > 0, diag, torch.ones_like(diag))
    inv = 1.0 / torch.where(d == 0, torch.ones_like(d), d)

    def precond(r):
        return inv * r
    return precond
