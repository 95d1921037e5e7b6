"""Buckling checks: member Euler screening and global linearized buckling
(PyTorch counterpart of ``small_fem_solver_tpu/ops/buckling.py``).

1. :func:`euler_member_screen`: per-member axial force against the Euler
   critical load pi^2 E I / (K L)^2 (a code-style slenderness screen,
   effective-length factor selectable).
2. :func:`buckling_analysis`: linearized (eigenvalue) buckling.  The
   consistent geometric stiffness K_G(N) is assembled from the linear
   solution's member axial forces, and the critical load factors come from
   K phi = lambda K_G phi, solved as the symmetric eigenproblem of
   L^-1 K_G L^-T with K_ff = L L^T (``torch.linalg.eigh``: LAPACK on the
   CPU, cuSOLVER on the card; the JAX package's TPU subspace route is not
   needed).  lambda_cr > 1 means the applied load case is below the
   elastic buckling load.  :func:`buckling_analysis_condensed` projects
   K_G through the Craig-Bampton basis of a chain-refined mesh.

Geometric element stiffness: the standard consistent 12x12 beam matrix
(lateral 6/5, coupling L/10, rotary 2L^2/15 / -L^2/30 terms in both bending
planes, with the elastic matrix's theta_y sign pattern), as one [M, 4] x
[4, 144] pattern contraction, as in ``ops/beams.py``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .assembly import assemble_dense
from .beams import (element_stiffness, local_axes, release_W,
                    transformation_matrices)
from .solve import free_fixed_dofs, ground_with_springs


def _build_gpat() -> np.ndarray:
    """Constant patterns: K_g_local = (N/L) P0 + N P1 + N L P2 + N L P3."""
    P = np.zeros((4, 12, 12))

    def sym(c, i, j, v):
        P[c, i, j] += v
        if i != j:
            P[c, j, i] += v

    # lateral terms 6/5 (both planes): v = dofs 1/7, w = dofs 2/8
    for a, b in [(1, 7), (2, 8)]:
        sym(0, a, a, 1.2)
        sym(0, b, b, 1.2)
        sym(0, a, b, -1.2)
    # coupling N/10: v-theta_z (1,5 | 7,11) plane, sign like elastic K
    sym(1, 1, 5, 0.1)
    sym(1, 1, 11, 0.1)
    sym(1, 7, 5, -0.1)
    sym(1, 7, 11, -0.1)
    # w-theta_y (2,4 | 8,10) plane: theta_y = -w' sign pattern
    sym(1, 2, 4, -0.1)
    sym(1, 2, 10, -0.1)
    sym(1, 8, 4, 0.1)
    sym(1, 8, 10, 0.1)
    # rotary 2 L^2 / 15 on theta^2 diagonals
    for a, b in [(5, 11), (4, 10)]:
        sym(2, a, a, 2.0 / 15.0)
        sym(2, b, b, 2.0 / 15.0)
        sym(3, a, b, -1.0 / 30.0)
    return P.reshape(4, 144)


_GPAT = _build_gpat()


def element_geometric_stiffness(coords: torch.Tensor, conn: torch.Tensor,
                                N_axial: torch.Tensor,
                                W: torch.Tensor | None = None):
    """Stacked global-frame geometric stiffness [M, 12, 12] (N/mm blocks,
    like the elastic K).

    ``N_axial``: [M] member axial force in N, positive in compression, so
    the assembled K_G is the destabilizing matrix of K phi = lambda K_G
    phi.  ``W`` ([M, 12, 12], :func:`.beams.release_W`): the consistent
    projection for members with pinned end releases, so K_G lives on the
    released elastic K's kept-DOF subspace (else the zeroed elastic
    rotation rows against nonzero K_G rows give spurious near-zero
    buckling factors)."""
    dL = coords[conn[:, 1]] - coords[conn[:, 0]]
    L = torch.linalg.norm(dL, dim=-1)
    L_mm = L * 1000.0
    coeffs = torch.stack([N_axial / L_mm, N_axial, N_axial * L_mm,
                          N_axial * L_mm], dim=-1)          # [M, 4]
    pat = torch.as_tensor(_GPAT, dtype=coords.dtype, device=coords.device)
    Kg_local = (coeffs @ pat).reshape(-1, 12, 12)
    if W is not None:
        Kg_local = W.mT @ Kg_local @ W
    T = transformation_matrices(local_axes(dL, L))
    return T.mT @ Kg_local @ T


class BucklingResults(NamedTuple):
    load_factor: torch.Tensor       # [n_modes] lambda_cr (ascending, >0)
    mode_shapes: torch.Tensor       # [n_modes, n_dof]
    member_axial_N: torch.Tensor    # [M] axial force used (+ compression)


class EulerScreen(NamedTuple):
    axial_N: torch.Tensor           # [M] axial force (+ compression)
    P_euler_N: torch.Tensor         # [M] pi^2 E I / (K L)^2
    utilization: torch.Tensor       # [M] axial / P_euler (0 for tension)


def member_axial_forces(results) -> torch.Tensor:
    """[M] axial force, positive in compression, from an AnalysisResults:
    ``F1_local`` carries the node-1 end force with the reference's sign
    flip, under which a member in pure compression has F1_x = -P."""
    return -results.F1_local[..., 0]


def euler_member_screen(model, results, E: float = 210000.0,
                        k_factor: float = 1.0,
                        n_seg: int = 1) -> EulerScreen:
    """Member-level Euler buckling screen (pin-ended by default).

    ``k_factor``: effective-length factor (1.0 pinned-pinned; jacket
    braces are commonly checked with 0.8).  On a ``refine_model(coarse,
    n_seg)`` mesh pass that ``n_seg``: each parent member's chain is
    screened as one physical member (its full length, the worst segment's
    axial force), one row per physical member; segment lengths would
    inflate P_euler by n_seg^2 and hide every real failure."""
    L = model.member_geometry()[3]
    N = member_axial_forces(results)
    sect_id = model.sect_id
    if n_seg > 1:
        Mc = model.n_members // n_seg
        L = torch.sum(L.reshape(Mc, n_seg), dim=1)
        N = torch.amax(N.reshape(Mc, n_seg), dim=1)
        sect_id = sect_id.reshape(Mc, n_seg)[:, 0]
    L_mm = L * 1000.0
    Imin = torch.minimum(model.sections.Iy, model.sections.Iz)[sect_id]
    P_cr = math.pi ** 2 * E * Imin / (k_factor * L_mm) ** 2
    util = torch.where(N > 0, N / P_cr, torch.zeros_like(N))
    return EulerScreen(axial_N=N, P_euler_N=P_cr, utilization=util)


def model_release_W(model, E, nu):
    """The end-release expansion W of ``model`` (:func:`.beams.release_W`;
    None without releases), for K_G's consistent projection."""
    if model.release is None:
        return None
    return release_W(model.coords, model.conn, model.sections, model.sect_id,
                     E, E / (2.0 * (1.0 + nu)), model.release)


def _geometric_stiffness(model, N, E: float, nu: float):
    """Element K_G of ``model`` for axial forces ``N``, projected onto
    the released subspace where the model has end releases."""
    return element_geometric_stiffness(model.coords, model.conn, N,
                                       W=model_release_W(model, E, nu))


def buckling_analysis(model, results, E: float = 210000.0, nu: float = 0.3,
                      n_modes: int = 4,
                      support_stiffness=None) -> BucklingResults:
    """Linearized global buckling factors of the applied load case: K phi
    = lambda K_G(N) phi on the free DOFs (dense; the coarse model or mild
    refinements), N the member axial forces of the linear solution
    ``results``; lambda_cr multiplies the whole load case.

    ``support_stiffness`` puts the supports on 6-DOF foundation springs
    (see ``api.analyze_ssi``): the eigenproblem runs over all DOFs with K
    + diag(k), and foundation flexibility lowers the factors."""
    from ..api import _full_f32_matmul

    dtype = model.dtype
    with _full_f32_matmul():
        Kg = element_stiffness(model.coords, model.conn, model.sections,
                               model.sect_id, E, E / (2.0 * (1.0 + nu)),
                               release=model.release)[0]
        N = member_axial_forces(results).to(dtype)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        KG = assemble_dense(_geometric_stiffness(model, N, E, nu),
                            model.conn, model.n_dof)
        if support_stiffness is not None:
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        else:
            free = torch.as_tensor(free_fixed_dofs(model.fixed_mask)[0],
                                   device=K.device)
        lam, phi_f = _buckling_pencil(K[free][:, free], KG[free][:, free],
                                      n_modes)
        shapes = K.new_zeros(n_modes, model.n_dof)
        shapes[:, free] = phi_f.mT
    return BucklingResults(load_factor=lam, mode_shapes=shapes,
                           member_axial_N=N)


def _buckling_pencil(K_ff, KG_ff, n_modes: int):
    """Lowest buckling factors of K phi = lambda K_G phi (shared by the
    dense and Craig-Bampton paths): Jacobi-scaled Cholesky of K, the
    largest eigenvalues mu of L^-1 K_G L^-T give lambda = 1 / mu."""
    d = 1.0 / torch.sqrt(torch.diagonal(K_ff))
    Lc = torch.linalg.cholesky(K_ff * d[:, None] * d[None, :])
    B = KG_ff * d[:, None] * d[None, :]
    Y = torch.linalg.solve_triangular(Lc, B, upper=False)
    A = torch.linalg.solve_triangular(Lc, Y.mT, upper=False)
    mu, V = torch.linalg.eigh(0.5 * (A + A.mT))
    mu_top = mu.flip(0)[:n_modes]
    phi_y = V.flip(1)[:, :n_modes]
    lam = torch.where(mu_top > 1e-12, 1.0 / mu_top,
                      torch.full_like(mu_top, math.inf))
    phi_f = d[:, None] * torch.linalg.solve_triangular(Lc.mT, phi_y,
                                                       upper=True)
    return lam, phi_f


def buckling_analysis_condensed(coarse, refined, n_seg: int, results,
                                E: float = 210000.0, nu: float = 0.3,
                                n_modes: int = 4, n_chain_modes: int = 12,
                                support_stiffness=None) -> BucklingResults:
    """Global buckling of a chain-refined mesh on the Craig-Bampton basis.

    ``results`` is a condensed analysis of the refined mesh
    (``api.analyze_condensed``), so the axial state lives on every refined
    element.  K_G is projected through the reduction of
    :func:`.dynamics.modal_analysis_condensed`:

        KG_bb_r = KG_bb + KG_ib^T Psi + Psi^T KG_ib + Psi^T KG_ii Psi
        KG_bq   = (KG_ib^T + Psi^T KG_ii) Phi,   KG_qq = Phi^T KG_ii Phi

    With all interior modes kept the basis is complete and the factors
    equal the dense refined solution; truncated fixed-interface modes
    approximate member-level buckling shapes (keep ``n_chain_modes`` at or
    above the wavelengths expected in the governing mode).  Mode shapes
    are expanded to the full refined mesh."""
    from ..api import _full_f32_matmul
    from .dynamics import _cb_expand, _cb_reduce, _chain_blocks, _chain_dense

    dtype = refined.dtype
    N = member_axial_forces(results).to(dtype)
    if N.shape[0] != refined.n_members:
        raise ValueError(
            f"results carry {N.shape[0]} member forces but the refined "
            f"mesh has {refined.n_members} elements: pass a condensed "
            "analysis of the refined mesh (api.analyze_condensed)")
    cb = _cb_reduce(coarse, refined, n_seg, E, nu, 0.0, n_chain_modes,
                    support_stiffness=support_stiffness)
    with _full_f32_matmul():
        KGg = _geometric_stiffness(refined, N, E, nu)
        X_ii, X_ib, X_bb = _chain_dense(*_chain_blocks(KGg, n_seg), n_seg)
        PsiT, PhiT = cb.Psi.mT, cb.Phi.mT
        X_bb_r = X_bb + X_ib.mT @ cb.Psi + PsiT @ X_ib + PsiT @ (X_ii
                                                               @ cb.Psi)
        X_bq = (X_ib.mT + PsiT @ X_ii) @ cb.Phi
        X_qq = PhiT @ (X_ii @ cb.Phi)

        nc, Mc, m = cb.nc, cb.Mc, cb.m
        KG_red = KGg.new_zeros(cb.n_red, cb.n_red)
        KG_red[:6 * nc, :6 * nc] = assemble_dense(X_bb_r, coarse.conn, 6 * nc)
        # each (bdof, qdof) and (qdof, qdof) entry belongs to one member
        b, q = cb.bdof, cb.qdof
        KG_red[b[:, :, None].expand(Mc, 12, m),
               q[:, None, :].expand(Mc, 12, m)] = X_bq
        KG_red[q[:, :, None].expand(Mc, m, 12),
               b[:, None, :].expand(Mc, m, 12)] = X_bq.mT
        KG_red[q[:, :, None].expand(Mc, m, m),
               q[:, None, :].expand(Mc, m, m)] = X_qq

        free = cb.free
        lam, phi_f = _buckling_pencil(cb.K_red[free][:, free],
                                      KG_red[free][:, free], n_modes)
        shapes_r = KG_red.new_zeros(n_modes, cb.n_red)
        shapes_r[:, free] = phi_f.mT
        shapes = _cb_expand(cb, shapes_r)
    return BucklingResults(load_factor=lam, mode_shapes=shapes,
                           member_axial_N=N)
