"""Structural dynamics: consistent mass, natural frequencies, Craig-Bampton
reduction, harmonic and transient response (PyTorch counterpart of
``small_fem_solver_tpu/ops/dynamics.py``).

Natural periods are the first thing a jacket designer checks against the
wave period; the dynamic amplification of the design storm comes next.

- Mass: stacked consistent element mass matrices (Euler-Bernoulli
  translational, axial and torsional terms), the transverse hydrodynamic
  added mass and drag damping of wetted members, congruence-transformed and
  assembled like K.  ``modal_analysis`` solves ``K phi = omega^2 M phi``
  through the Cholesky factor of M_ff (LAPACK on the CPU, cuSOLVER on the
  card).
- Craig-Bampton: every member chain of a refined jacket is reduced to its
  12 interface DOFs (constraint modes: the exact static condensation of
  ``ops/condense.py``) plus its lowest fixed-interface modes, found by
  subspace iteration whose stiffness solves are chain sweeps (on the card
  the chain-sweep kernel, one launch an iteration).
- Harmonic response: the Morison loads of one wave period (the
  phase-batch engine, K1 on the card, in the model's dtype) are Fourier
  decomposed and each harmonic solved through (K + i w C - w^2 M) with
  Rayleigh damping; complex solves exist on both devices, so the JAX
  package's real-pair realification (a TPU workaround) is not ported.
- Transient response: Newmark-beta on the reduced basis, one factorization
  and a march over the steps on the device; optional relative-velocity
  drag, free vibration, ramps and ground acceleration.

Unit system: K is N/mm, displacements mm / rad, so M carries tonnes
(1 t = 1 N s^2/mm) and t*mm^2 for rotary terms; omega is in rad/s.
Repeated-index sums (assembly, the reduced mass coupling, the projection
of loads onto shared interface DOFs, the relative-drag nodal sums) run in
a fixed order, so results on the card are bit-repeatable.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..api import LoadCase, _full_f32_matmul, assemble_loads
from .assembly import (assemble_dense, element_dof_indices,
                       node_gather_table, node_sum_ordered)
from .beams import (element_stiffness, internal_forces, local_axes,
                    transformation_matrices)
from .condense import condense_loads, factor_chains
from .eigen import eigh_general_small
from .hopper_kernels import (cast_operands, kernel_route,
                             morison_phase_batch_cuda)
from .morison import (gauss_legendre_01, hydro_diameter_m, hydro_members,
                      morison_phase_batch)
from .sections import TubeSections, von_mises_8pt
from .spectrum import SpectralSea, morison_sea_batch, sea_kinematics
from .solve import (factor_dense, free_fixed_dofs, ground_with_springs,
                    solve_factored, support_spring_nodes)
from .waves import FourierWave
from .waves import kinematics as wave_kinematics


def _sym_patterns(entries, n_coeffs: int) -> np.ndarray:
    """[n_coeffs, 144] constant patterns from (coefficient, i, j, value)
    entries, mirrored to (j, i)."""
    P = np.zeros((n_coeffs, 12, 12))
    for c, i, j, v in entries:
        P[c, i, j] += v
        if i != j:
            P[c, j, i] += v
    return P.reshape(n_coeffs, 144)


def _bending_entries(c0: int, c1: int, c2: int) -> list:
    """Consistent bending mass entries of both local planes: coefficient
    c0 multiplies rho A L (translations), c1 rho A L^2 (coupling), c2
    rho A L^3 (rotations), each /420."""
    b = 1.0 / 420.0
    return [
        # local y: v = 1, 7; theta_z = 5, 11
        (c0, 1, 1, 156 * b), (c0, 7, 7, 156 * b), (c0, 1, 7, 54 * b),
        (c1, 1, 5, 22 * b), (c1, 7, 11, -22 * b),
        (c1, 1, 11, -13 * b), (c1, 5, 7, 13 * b),
        (c2, 5, 5, 4 * b), (c2, 11, 11, 4 * b), (c2, 5, 11, -3 * b),
        # local z: w = 2, 8; theta_y = 4, 10 (theta_y = -w')
        (c0, 2, 2, 156 * b), (c0, 8, 8, 156 * b), (c0, 2, 8, 54 * b),
        (c1, 2, 4, -22 * b), (c1, 8, 10, 22 * b),
        (c1, 2, 10, 13 * b), (c1, 4, 8, -13 * b),
        (c2, 4, 4, 4 * b), (c2, 10, 10, 4 * b), (c2, 4, 10, -3 * b),
    ]


def _build_mass_patterns() -> np.ndarray:
    """M_local = rho A L P0 + rho Ix L P1 + rho A L^2 P2 + rho A L^3 P3:
    axial (dofs 0, 6) and torsion (3, 9) as (1/6) [[2, 1], [1, 2]], then
    the bending terms split by their power of L."""
    axial = [(c, a, a, 2.0 / 6.0) for c, (i, j) in ((0, (0, 6)), (1, (3, 9)))
             for a in (i, j)]
    axial += [(0, 0, 6, 1.0 / 6.0), (1, 3, 9, 1.0 / 6.0)]
    return _sym_patterns(axial + _bending_entries(0, 2, 3), 4)


def _build_lateral_mass_patterns() -> np.ndarray:
    """Transverse-only consistent patterns (the two bending planes, no
    axial or torsion): added mass and drag damping act perpendicular to a
    slender member."""
    return _sym_patterns(_bending_entries(0, 1, 2), 3)


_MPAT = _build_mass_patterns()
_MPAT_LAT = _build_lateral_mass_patterns()


def _to_global(coeffs: torch.Tensor, pattern: np.ndarray, dL, L):
    """Global-frame element matrices T^T (coeffs @ pattern) T [M, 12, 12]."""
    pat = torch.as_tensor(pattern, dtype=coeffs.dtype, device=coeffs.device)
    local = (coeffs @ pat).reshape(-1, 12, 12)
    T = transformation_matrices(local_axes(dL, L))
    return T.mT @ local @ T


def _member_vectors(coords, conn):
    """(node-1 coordinates, axis vectors dL, lengths L in m)."""
    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    return c1, dL, torch.linalg.norm(dL, dim=-1)


def element_added_mass(coords, conn, D_m, rho_water=1025.0, Ca=1.0):
    """Hydrodynamic added mass matrices [M, 12, 12] (tonnes).

    The Morison inertia force on a moving member carries a rho Ca pi D^2/4
    term proportional to the structure's own acceleration, the added mass
    (it lengthens jacket periods by ~5-15%).  Transverse-only consistent
    formulation, scaled by each member's still-water wetted length
    fraction (z < 0).  ``Ca`` is the added-mass coefficient (Cm - 1; 1.0
    for a cylinder)."""
    c1, dL, L = _member_vectors(coords, conn)
    L_mm = L * 1000.0
    z1, z2 = c1[:, 2], coords[conn[:, 1], 2]
    zlo, zhi = torch.minimum(z1, z2), torch.maximum(z1, z2)
    span = torch.clamp(zhi - zlo, min=1e-12)
    frac = torch.clip((0.0 - zlo) / span, 0.0, 1.0)
    frac = torch.where(zhi - zlo < 1e-9, (zhi < 0.0).to(coords.dtype), frac)
    # rho Ca pi D^2 / 4 [kg/m] -> [t/mm]
    ma = (rho_water * Ca * math.pi * D_m**2 / 4.0) * 1e-6 * frac
    mL = ma * L_mm                                   # t per element
    return _to_global(torch.stack([mL, mL * L_mm, mL * L_mm**2], dim=-1),
                      _MPAT_LAT, dL, L)


def element_hydro_damping(coords, conn, c_damp):
    """Consistent transverse hydrodynamic damping matrices [M, 12, 12].

    ``c_damp``: per-member linearized drag-damping coefficient per unit
    length [N s/m per m]; the same transverse pattern as
    :func:`element_added_mass`, converted to the FEM's N, mm, s system."""
    _, dL, L = _member_vectors(coords, conn)
    L_mm = L * 1000.0
    cu = torch.as_tensor(c_damp, dtype=coords.dtype,
                         device=coords.device) * 1e-6
    cL = cu * L_mm                                   # N s/mm per element
    return _to_global(torch.stack([cL, cL * L_mm, cL * L_mm**2], dim=-1),
                      _MPAT_LAT, dL, L)


def element_mass(coords, conn, sec: TubeSections, sect_id):
    """Stacked global-frame consistent mass matrices [M, 12, 12]
    (tonnes)."""
    _, dL, L = _member_vectors(coords, conn)
    L_mm = L * 1000.0
    rho_t = sec.rho_steel[sect_id] * 1e-12           # t/mm^3
    mAL = rho_t * sec.Ax[sect_id] * L_mm             # t
    mIx = rho_t * sec.Ix[sect_id] * L_mm             # t mm^2
    return _to_global(torch.stack([mAL, mIx, mAL * L_mm, mAL * L_mm**2],
                                  dim=-1), _MPAT, dL, L)


class ModalResults(NamedTuple):
    frequencies_hz: torch.Tensor   # [n_modes]
    omega: torch.Tensor            # [n_modes] rad/s
    periods_s: torch.Tensor        # [n_modes]
    mode_shapes: torch.Tensor      # [n_modes, n_dof] (zeros at fixed DOFs
                                   #  when clamped; nonzero there on springs)
    total_mass_t: torch.Tensor     # structural mass [tonnes]


def _lump_topside(M: torch.Tensor, top_mask, topside_mass_t: float):
    """M with the topside mass split equally onto the top nodes'
    translational diagonal entries (distinct entries: no repeated index)."""
    top = torch.nonzero(top_mask.to(M.device)).reshape(-1)
    per = topside_mass_t / max(int(top.numel()), 1)
    idx = (6 * top[:, None] + torch.arange(3, device=M.device)).reshape(-1)
    M = M.clone()
    M[idx, idx] += per
    return M


def _build_km(model, E, nu, topside_mass_t, added_mass_Ca=None,
              rho_water=1025.0):
    """Assembled (K, M, free DOFs, (K_local, T, L_m)) shared by the modal
    and harmonic paths: the topside lumping and the added mass."""
    G = E / (2.0 * (1.0 + nu))
    Kg, K_local, T, L_m = element_stiffness(model.coords, model.conn,
                                            model.sections, model.sect_id,
                                            E, G, release=model.release)
    Mg = element_mass(model.coords, model.conn, model.sections, model.sect_id)
    if added_mass_Ca is not None:
        Mg = Mg + element_added_mass(
            model.coords, model.conn,
            hydro_diameter_m(model.sections, model.sect_id),
            rho_water=rho_water, Ca=added_mass_Ca)
    K = assemble_dense(Kg, model.conn, model.n_dof)
    M = assemble_dense(Mg, model.conn, model.n_dof)
    if topside_mass_t:
        M = _lump_topside(M, model.top_mask, topside_mass_t)
    free, _ = free_fixed_dofs(model.fixed_mask)
    return (K, M, torch.as_tensor(free, device=K.device), (K_local, T, L_m))


def _modal_from_ff(K_ff, M_ff, free, n_dof, n_modes, dtype):
    """Lowest generalized eigenpairs of (K_ff, M_ff) through the Cholesky
    factor of M_ff and ``eigh`` (LAPACK on the CPU, cuSOLVER on the card;
    the JAX package's TPU subspace route is not needed), expanded to
    full-DOF mode shapes: (omega [n_modes], shapes [n_modes, n_dof])."""
    Lm = torch.linalg.cholesky(M_ff)
    Y = torch.linalg.solve_triangular(Lm, K_ff, upper=False)
    A = torch.linalg.solve_triangular(Lm, Y.mT, upper=False)
    w2, V = torch.linalg.eigh(0.5 * (A + A.mT))
    phi_f = torch.linalg.solve_triangular(Lm.mT, V[:, :n_modes], upper=True)
    omega = torch.sqrt(torch.clamp(w2[:n_modes], min=0.0))
    shapes = K_ff.new_zeros(n_modes, n_dof, dtype=dtype)
    shapes[:, free] = phi_f.mT.to(dtype)
    return omega, shapes


def _modal_results(omega, shapes, total_mass) -> ModalResults:
    return ModalResults(
        frequencies_hz=omega / (2.0 * math.pi), omega=omega,
        periods_s=torch.where(omega > 0, 2.0 * math.pi / omega,
                              torch.full_like(omega, math.inf)),
        mode_shapes=shapes, total_mass_t=total_mass)


def modal_analysis(model, n_modes: int = 10, E: float = 210000.0,
                   nu: float = 0.3, topside_mass_t: float = 0.0,
                   support_stiffness=None, added_mass_Ca=None,
                   rho_water: float = 1025.0) -> ModalResults:
    """Natural frequencies and mode shapes of the (supported) structure, on
    the model's device in its dtype (dense: a few thousand DOF).

    ``topside_mass_t`` lumps a deck mass equally onto the top nodes'
    translations; ``support_stiffness`` ([6] or [n_fixed, 6], N/mm and
    N*mm/rad) replaces the clamp with foundation springs, solved over all
    DOFs with ``K + diag(k)``; ``added_mass_Ca`` adds the hydrodynamic
    added mass of the wetted members."""
    dtype = model.dtype
    with _full_f32_matmul():
        K, M, free, (_, _, L_m) = _build_km(model, E, nu, topside_mass_t,
                                            added_mass_Ca, rho_water)
        if support_stiffness is not None:
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        omega, shapes = _modal_from_ff(K[free][:, free], M[free][:, free],
                                       free, model.n_dof, n_modes, dtype)
    mass_per_m = model.sections.mass_per_m[model.sect_id]
    return _modal_results(omega, shapes,
                          torch.sum(mass_per_m * L_m) / 1000.0
                          + topside_mass_t)


# ---------------------------------------------------------------------------
# Craig-Bampton reduction of chain-refined jackets
# ---------------------------------------------------------------------------

def _chain_blocks(Xe: torch.Tensor, n_seg: int):
    """Member-major element matrices [Mc * n_seg, 12, 12] as chain blocks
    (A, B, C, E), each [Mc, n_seg, 6, 6]."""
    X = Xe.reshape(Xe.shape[0] // n_seg, n_seg, 12, 12)
    return (X[:, :, 0:6, 0:6], X[:, :, 0:6, 6:12],
            X[:, :, 6:12, 0:6], X[:, :, 6:12, 6:12])


def _chain_dense(A, B, C, E, n_seg: int):
    """Dense per-chain interior operator and interface coupling of a
    chain-structured matrix from its element blocks: (X_ii [Mc, 6 n_int,
    6 n_int], X_ib [Mc, 6 n_int, 12], X_bb [Mc, 12, 12]), n_int = n_seg -
    1; each block diagonal is placed with one indexed assignment."""
    Mc, n_int = A.shape[0], n_seg - 1
    N = 6 * n_int
    p = torch.arange(n_int, device=A.device)
    r6 = torch.arange(6, device=A.device)
    rows = 6 * p[:, None, None] + r6[None, :, None]      # [n_int, 6, 6]
    cols = 6 * p[:, None, None] + r6[None, None, :]
    X_ii = A.new_zeros(Mc, N, N)
    # interior node p + 1 joins elements p and p + 1
    X_ii[:, rows, cols] = E[:, :n_int] + A[:, 1:n_int + 1]
    if n_int > 1:
        X_ii[:, rows[:-1], cols[1:]] = B[:, 1:n_int]
        X_ii[:, rows[1:], cols[:-1]] = C[:, 1:n_int]
    X_ib = A.new_zeros(Mc, N, 12)
    X_ib[:, 0:6, 0:6] = C[:, 0]
    X_ib[:, N - 6:N, 6:12] = B[:, -1]
    X_bb = A.new_zeros(Mc, 12, 12)
    X_bb[:, 0:6, 0:6] = A[:, 0]
    X_bb[:, 6:12, 6:12] = E[:, -1]
    return X_ii, X_ib, X_bb


@dataclasses.dataclass(frozen=True)
class CBReduction:
    """Craig-Bampton reduction of a chain-refined jacket (see
    :func:`modal_analysis_condensed`)."""

    K_red: torch.Tensor     # [n_red, n_red]
    M_red: torch.Tensor     # [n_red, n_red]
    free: torch.Tensor      # free reduced DOFs (fixed coarse nodes clamped)
    Psi: torch.Tensor       # [Mc, N, 12] constraint modes
    Phi: torch.Tensor       # [Mc, N, m] fixed-interface modes
    bdof: torch.Tensor      # [Mc, 12] interface DOF ids per member
    qdof: torch.Tensor      # [Mc, m] generalized DOF ids per member
    btable: torch.Tensor    # fixed-order gather table of bdof onto 6 nc
    L_m: torch.Tensor       # [Mr] refined member lengths
    K_local: torch.Tensor   # [Mr, 12, 12] for stress recovery
    T: torch.Tensor         # [Mr, 12, 12]
    n_red: int
    nc: int
    Mc: int
    m: int


def _chain_modes(fac, Kg, MA, MB, MC, ME, n_seg: int, m: int, mass_mv):
    """(lam [Mc, m], Phi [Mc, N, m]): the lowest fixed-interface modes of
    every chain.  Subspace iteration (10 rounds of K_ii^-1 M_ii V, each
    one chain sweep, then Rayleigh-Ritz) with a guard block of max(4,
    m / 2); short chains whose guard block would span the whole interior
    space take one dense Rayleigh-Ritz on it instead (exact)."""
    Mc, n_int = MA.shape[0], n_seg - 1
    N_chain = 6 * n_int
    dtype, device = MA.dtype, MA.device
    msub = min(m + max(4, m // 2), N_chain)
    if msub >= N_chain:
        K_ii = _chain_dense(*_chain_blocks(Kg, n_seg), n_seg)[0]
        M_ii = _chain_dense(MA, MB, MC, ME, n_seg)[0]
        lam, Phi_f = eigh_general_small(K_ii, M_ii)
        return torch.clamp(lam[:, :m], min=0.0), Phi_f[:, :, :m]
    kk = torch.arange(1, msub + 1, dtype=dtype, device=device)
    pos = torch.arange(1, N_chain + 1, dtype=dtype, device=device)
    V0 = torch.sin(kk[:, None] * pos[None, :] * 2.399963)
    Vk = (V0[:, None, :].expand(msub, Mc, N_chain)
          .reshape(msub, Mc, n_int, 6).movedim(2, 1))     # [k, n_int, Mc, 6]
    for _ in range(10):
        MV = mass_mv(Vk)
        W = condense_loads(fac, MV)[2]                    # K_ii^-1 M V
        MW = mass_mv(W)
        Ar = torch.einsum("apmi,bpmi->mab", W, MV)        # W^T K W
        Br = torch.einsum("apmi,bpmi->mab", W, MW)
        lam, Q = eigh_general_small(0.5 * (Ar + Ar.mT), 0.5 * (Br + Br.mT))
        Vk = torch.einsum("apmi,mab->bpmi", W, Q)         # M-orthonormal
    # (k, p, m, i) -> (m, p, i, k) -> [Mc, N, m]
    Phi = Vk[:m].permute(2, 1, 3, 0).reshape(Mc, N_chain, m)
    return torch.clamp(lam[:, :m], min=0.0), Phi


def _cb_reduce(coarse, refined, n_seg: int, E: float, nu: float,
               topside_mass_t: float, n_chain_modes: int,
               support_stiffness=None, added_mass_Ca=None,
               rho_water: float = 1025.0) -> CBReduction:
    """The reduced (K, M) and the member transformation blocks.

    Matrix-free: the interior operators are block-tridiagonal along each
    chain, so the block-Thomas factorization (``ops.condense.
    factor_chains``) gives the constraint modes Psi = [-Z0 | -Zn] and the
    condensed interface stiffness; the fixed-interface modes come from
    :func:`_chain_modes`; the mass enters through banded products and the
    two 6x6 interface coupling blocks."""
    dtype, device = refined.dtype, refined.device
    G = E / (2.0 * (1.0 + nu))
    with _full_f32_matmul():
        Kg, K_local, T, L_m = element_stiffness(
            refined.coords, refined.conn, refined.sections, refined.sect_id,
            E, G, release=refined.release)
        Mg = element_mass(refined.coords, refined.conn, refined.sections,
                          refined.sect_id)
        if added_mass_Ca is not None:
            Mg = Mg + element_added_mass(
                refined.coords, refined.conn,
                hydro_diameter_m(refined.sections, refined.sect_id),
                rho_water=rho_water, Ca=added_mass_Ca)
        MA, MB, MC, ME = _chain_blocks(Mg, n_seg)
        Mc = Mg.shape[0] // n_seg
        nc, n_int = coarse.n_nodes, n_seg - 1
        N_chain = 6 * n_int
        m = min(n_chain_modes, N_chain)

        fac = factor_chains(Kg, n_seg)
        Z0m = fac.Z0.movedim(0, 1).reshape(Mc, N_chain, 6)
        Znm = fac.Zn.movedim(0, 1).reshape(Mc, N_chain, 6)
        Psi = -torch.cat([Z0m, Znm], dim=-1)              # [Mc, N, 12]

        # banded interior mass operator (the block layout of _chain_dense)
        DM = ME[:, :-1] + MA[:, 1:]                       # [Mc, n_int, 6, 6]
        UM = MB[:, 1:n_int]                               # (row p, col p+1)
        LM = MC[:, 1:n_int]                               # (row p+1, col p)

        def mass_mv(Vk):
            """M_ii V for V [k, n_int, Mc, 6] (the chain-sweep layout)."""
            Vm = Vk.movedim(2, 1)                         # [k, Mc, n_int, 6]
            y = torch.einsum("mpij,kmpj->kmpi", DM, Vm)
            if n_int > 1:
                y[:, :, :-1] += torch.einsum("mpij,kmpj->kmpi", UM,
                                             Vm[:, :, 1:])
                y[:, :, 1:] += torch.einsum("mpij,kmpj->kmpi", LM,
                                            Vm[:, :, :-1])
            return y.movedim(1, 2)

        lam, Phi = _chain_modes(fac, Kg, MA, MB, MC, ME, n_seg, m, mass_mv)

        # reduced member blocks through the banded mass operator and the
        # sparse interface coupling (M_ib has two 6x6 blocks: rows 0:6 x
        # cols 0:6 = MC[:, 0], rows N-6: x cols 6:12 = MB[:, -1]; M_bb is
        # block-diag(MA[:, 0], ME[:, -1])); the 12 interface columns ride
        # the batch axis of the banded product
        Psi_k = Psi.reshape(Mc, n_int, 6, 12).permute(3, 1, 0, 2)
        MPsi = mass_mv(Psi_k).permute(2, 1, 3, 0).reshape(Mc, N_chain, 12)

        def mib_t(X):
            """M_ib^T X for X [Mc, N, c] -> [Mc, 12, c]."""
            top = torch.einsum("mij,mic->mjc", MC[:, 0], X[:, :6])
            bot = torch.einsum("mij,mic->mjc", MB[:, -1], X[:, N_chain - 6:])
            return torch.cat([top, bot], dim=1)

        mibT_psi = mib_t(Psi)
        M_bb = Mg.new_zeros(Mc, 12, 12)
        M_bb[:, :6, :6] = MA[:, 0]
        M_bb[:, 6:, 6:] = ME[:, -1]
        M_bb_r = (M_bb + mibT_psi + mibT_psi.mT
                  + torch.einsum("mnc,mnd->mcd", Psi, MPsi))
        M_bq = mib_t(Phi) + torch.einsum("mnc,mnq->mcq", MPsi, Phi)

        # global reduced assembly: interface DOFs, then per-member modes
        n_red = 6 * nc + Mc * m
        K_red = Mg.new_zeros(n_red, n_red)
        M_red = Mg.new_zeros(n_red, n_red)
        K_red[:6 * nc, :6 * nc] = assemble_dense(fac.K_super, coarse.conn,
                                                 6 * nc)
        M_red[:6 * nc, :6 * nc] = assemble_dense(M_bb_r, coarse.conn, 6 * nc)
        qdof = 6 * nc + torch.arange(Mc * m, device=device).reshape(Mc, m)
        q = qdof.reshape(-1)
        K_red[q, q] = lam.reshape(-1)
        M_red[q, q] = 1.0
        bdof = torch.cat([6 * coarse.conn[:, 0:1] + torch.arange(6,
                                                                 device=device),
                          6 * coarse.conn[:, 1:2] + torch.arange(6,
                                                                 device=device)],
                         dim=-1)                          # [Mc, 12]
        # each (bdof, qdof) pair belongs to one member: no repeated entry
        M_red.index_put_((bdof[:, :, None].expand(Mc, 12, m),
                          qdof[:, None, :].expand(Mc, 12, m)), M_bq,
                         accumulate=True)
        M_red.index_put_((qdof[:, :, None].expand(Mc, m, 12),
                          bdof[:, None, :].expand(Mc, m, 12)), M_bq.mT,
                         accumulate=True)
        if topside_mass_t:
            M_red = _lump_topside(M_red, coarse.top_mask, topside_mass_t)

        # clamp the fixed coarse nodes (every q DOF free), or ground the
        # support interface DOFs through diag(k) and free every DOF
        if support_stiffness is not None:
            ks = support_spring_nodes(coarse.fixed_mask, support_stiffness)
            idx = torch.arange(6 * nc, device=device)
            K_red[idx, idx] += torch.as_tensor(ks.reshape(-1), dtype=dtype,
                                               device=device)
            free = torch.arange(n_red, device=device)
        else:
            free_b, _ = free_fixed_dofs(coarse.fixed_mask)
            free = torch.cat([torch.as_tensor(free_b, device=device),
                              6 * nc + torch.arange(Mc * m, device=device)])
    return CBReduction(K_red=K_red, M_red=M_red, free=free, Psi=Psi, Phi=Phi,
                       bdof=bdof, qdof=qdof,
                       btable=node_gather_table(bdof.reshape(-1), 6 * nc),
                       L_m=L_m, K_local=K_local, T=T, n_red=n_red, nc=nc,
                       Mc=Mc, m=m)


def _cb_expand(cb: CBReduction, shapes_r: torch.Tensor) -> torch.Tensor:
    """Reduced-coordinate vectors [..., n_red] on the refined mesh layout
    [..., n_dof_refined]: v = Psi u_b + Phi q per member (interior layout
    member-major [Mc, n_int, 6], the order of ``refine_model``)."""
    lead = shapes_r.shape[:-1]
    u_b = shapes_r[..., :6 * cb.nc]
    q = shapes_r[..., 6 * cb.nc:].reshape(*lead, cb.Mc, cb.m)
    ub_e = u_b[..., cb.bdof.reshape(-1)].reshape(*lead, cb.Mc, 12)
    v = (torch.einsum("mnj,...mj->...mn", cb.Psi, ub_e)
         + torch.einsum("mnq,...mq->...mn", cb.Phi, q))
    return torch.cat([u_b, v.reshape(*lead, -1)], dim=-1)


def _reduced_ff(cb: CBReduction):
    return (cb.K_red[cb.free][:, cb.free], cb.M_red[cb.free][:, cb.free])


def modal_analysis_condensed(coarse, refined, n_seg: int, n_modes: int = 10,
                             E: float = 210000.0, nu: float = 0.3,
                             topside_mass_t: float = 0.0,
                             n_chain_modes: int = 12,
                             support_stiffness=None, added_mass_Ca=None,
                             rho_water: float = 1025.0) -> ModalResults:
    """Craig-Bampton reduced modal analysis of a chain-refined jacket
    (``refined = refine_model(coarse, n_seg)``): every member chain is
    reduced to its 12 interface DOFs plus its ``n_chain_modes`` lowest
    fixed-interface modes, so the eigenproblem has ``6 n_coarse_nodes +
    Mc n_chain_modes`` DOF (738 for the default jacket with 12 modes a
    chain) whatever n_seg.  Global modes converge quickly below the lowest
    truncated chain frequency (16 modes a chain: the first ~12 jacket
    modes within ~1e-6 of the dense solution at n_seg = 8).  Mode shapes
    are expanded onto the refined mesh."""
    cb = _cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                    n_chain_modes, support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca, rho_water=rho_water)
    with _full_f32_matmul():
        omega, shapes_r = _modal_from_ff(*_reduced_ff(cb), cb.free, cb.n_red,
                                         n_modes, refined.dtype)
        shapes = _cb_expand(cb, shapes_r)
    mass_per_m = refined.sections.mass_per_m[refined.sect_id]
    return _modal_results(omega, shapes,
                          torch.sum(mass_per_m * cb.L_m) / 1000.0
                          + topside_mass_t)


# ---------------------------------------------------------------------------
# Harmonic (steady-state, frequency-domain) response
# ---------------------------------------------------------------------------

class HarmonicResponse(NamedTuple):
    """Steady-state wave-frequency dynamic response (one wave period)."""

    ts: torch.Tensor              # [S] sample times
    U_time: torch.Tensor          # [S, n_dof] dynamic displacements (mm/rad)
    U_static: torch.Tensor        # [S, n_dof] quasi-static displacements
    utilization: torch.Tensor     # [S, M] dynamic von Mises utilization
    utilization_static: torch.Tensor
    daf: torch.Tensor             # [] max dynamic / max static displacement
    omega: torch.Tensor           # wave angular frequency
    rayleigh_alpha: torch.Tensor
    rayleigh_beta: torch.Tensor


def _chol_scaled(S: torch.Tensor):
    """Jacobi-scaled Cholesky: the factor of d S d, d = diag(S)^(-1/2)."""
    d = 1.0 / torch.sqrt(torch.diagonal(S))
    return torch.linalg.cholesky(S * d[:, None] * d[None, :]), d


def _cho_solve_scaled(L, d, B):
    """Solve S X = B through the scaled factor; B is [n] or [n, k]."""
    vec = B.ndim == 1
    y = d[:, None] * (B[:, None] if vec else B)
    y = torch.linalg.solve_triangular(L, y, upper=False)
    y = d[:, None] * torch.linalg.solve_triangular(L.mT, y, upper=True)
    return y[:, 0] if vec else y


def harmonic_solve(K_ff, M_ff, F_hat_f, omega, alpha, beta):
    """Frequency-domain solves (K + i w_j C - w_j^2 M) U_j = F_j, w_j =
    j omega, with Rayleigh damping C = alpha M + beta K.

    ``F_hat_f``: [n_h + 1, n_free] complex one-sided Fourier coefficients
    (j = 0 is the mean, taken as real, as in the JAX package: a real
    signal's mean).  Returns the complex U_hat_f of the same shape: one
    Jacobi-scaled Cholesky solve for the mean and one batched complex LU
    solve for the harmonics (the JAX package's real Schur-complement form
    exists because its TPU backend has no complex solve)."""
    dtype = K_ff.dtype
    cdtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    F_hat_f = F_hat_f.to(cdtype)
    U0 = _cho_solve_scaled(*_chol_scaled(K_ff), F_hat_f[0].real.to(dtype))
    n_h = F_hat_f.shape[0] - 1
    if n_h == 0:
        return U0[None].to(cdtype)
    w = torch.arange(1, n_h + 1, dtype=dtype, device=K_ff.device) * omega
    C = alpha * M_ff + beta * K_ff
    A = (K_ff[None] - (w**2)[:, None, None] * M_ff[None]).to(cdtype) \
        + 1j * (w[:, None, None] * C[None]).to(cdtype)
    # symmetric Jacobi scaling by diag(K)^(-1/2), as the real factors
    d = (1.0 / torch.sqrt(torch.diagonal(K_ff))).to(cdtype)
    y = torch.linalg.solve(A * d[:, None] * d[None, :],
                           (d * F_hat_f[1:])[..., None])[..., 0]
    return torch.cat([U0[None].to(cdtype), d * y])


def harmonic_solve_real(K_ff, M_ff, F_re, F_im, omega, alpha, beta):
    """:func:`harmonic_solve` on a real coefficient pair: ``(U_re, U_im)``,
    each [n_h + 1, n_free] (the JAX package's real-pair signature)."""
    U = harmonic_solve(K_ff, M_ff, torch.complex(F_re, F_im), omega, alpha,
                       beta)
    return U.real.contiguous(), U.imag.contiguous()


def real_dft_coeffs(F_t: torch.Tensor, n_h: int):
    """One-sided Fourier coefficients of a real [S, n] history as a real
    pair ``(c_re [n_h+1, n], c_im)``, matching ``rfft(F, dim=0) / S`` with
    bins 1..n_h doubled (an even-length Nyquist bin halved back)."""
    S, dtype, dev = F_t.shape[0], F_t.dtype, F_t.device
    j = torch.arange(n_h + 1, dtype=dtype, device=dev)[:, None]
    s = torch.arange(S, dtype=dtype, device=dev)[None, :]
    ang = 2.0 * math.pi * j * s / S
    scale = torch.full((n_h + 1, 1), 2.0 / S, dtype=dtype, device=dev)
    scale[0] = 1.0 / S
    if S % 2 == 0 and n_h == S // 2:
        scale[-1] = 1.0 / S
    return (torch.cos(ang) * scale) @ F_t, (-torch.sin(ang) * scale) @ F_t


def real_harmonic_reconstruct(U_re, U_im, omega, ts):
    """u(t) = Re sum_j U_j e^{+i j w t} from the real coefficient pair."""
    j = torch.arange(U_re.shape[0], dtype=U_re.dtype, device=U_re.device)
    ang = j[None, :] * omega * ts[:, None]               # [S, n_h+1]
    return torch.cos(ang) @ U_re - torch.sin(ang) @ U_im


def _rayleigh(K_ff, M_ff, damping_ratio, dtype):
    """(w1, alpha, beta): Rayleigh damping calibrated to ``damping_ratio``
    at the first two distinct natural frequencies (a symmetric jacket's
    sway pair is degenerate: the second is the first above 1.01 w1)."""
    n = K_ff.shape[0]
    omega_n, _ = _modal_from_ff(K_ff, M_ff, torch.arange(n,
                                                         device=K_ff.device),
                                n, 6, dtype)
    om = omega_n.cpu().numpy()
    w1 = float(om[0])
    w2 = next((float(w) for w in om[1:] if w > 1.01 * w1), 3.0 * w1)
    return (w1, damping_ratio * 2.0 * w1 * w2 / (w1 + w2),
            damping_ratio * 2.0 / (w1 + w2))


def _check_dynamics_loading(case: LoadCase, wave, periodic: bool = False):
    """Slamming is pointwise-path only; the harmonic paths (``periodic``)
    need a steady wave, the transient takes a random sea too."""
    if case.slam_cs:
        raise ValueError("dynamics loading uses the separable phase "
                         "matmul; slamming (slam_cs > 0) is pointwise-"
                         "path only")
    kinds = (FourierWave,) if periodic else (FourierWave, SpectralSea)
    if wave is not None and not isinstance(wave, kinds):
        raise TypeError(
            f"{type(wave).__name__} is not a wave this path takes: the "
            "harmonic response needs a FourierWave; a SpectralSea goes "
            "through transient_response_condensed or the spectral paths")


def _phase_loads(model, wave, case: LoadCase, ts, n_gauss,
                 stretching="none", Cd=None):
    """Phase-batch Morison loads of a model in its dtype for a steady wave
    or a random sea: on the card one launch of the Morison kernel (its
    harmonic or general-mode instance of that dtype), on the CPU the plain
    version; on the card past the kernel's limits (more than 32 modes or
    ``n_gauss`` > 16) the plain version too, with no launch and one plain
    route counted (``hopper_kernels.kernel_route``), as the JAX package's
    separable engine takes any size."""
    dtype, dev = model.dtype, model.device
    conn_h, D_m, Cd_h, Cm_h = hydro_members(
        model, case.marine_growth_mm, case.Cd if Cd is None else Cd,
        case.Cm)
    wk, xyz, *rest = cast_operands(
        dtype, dev, wave, model.coords, D_m, case.wave_dir_deg,
        case.current_dir_deg, Cd_h, Cm_h, case.rho_water, ts)
    if isinstance(wave, SpectralSea):
        batch = morison_sea_batch        # routes by n_gauss itself
    elif kernel_route(dev, n_gauss, wave.n_modes):
        batch = morison_phase_batch_cuda
    else:
        batch = morison_phase_batch
    return batch(wk, xyz, conn_h, *rest, n_gauss=n_gauss,
                 stretching=stretching)


def _recover_util(sections, sect_id, conn, K_local, T, U, fy):
    """Von Mises utilization [S, M] from displacements [S, n_dof]."""
    F1, _ = internal_forces(K_local, T, U[:, element_dof_indices(conn)])
    return von_mises_8pt(sections, sect_id,
                         *(F1[..., c] for c in range(6))) / fy


def _max_translation(U: torch.Tensor) -> torch.Tensor:
    """max over the leading axis and the nodes of |(u_x, u_y, u_z)|."""
    return torch.amax(torch.linalg.norm(
        U.reshape(*U.shape[:-1], -1, 6)[..., :3], dim=-1))


def _harmonic_response(K_ff, M_ff, F_f, expand, util_of, wave, ts, n_h,
                       alpha, beta, dtype) -> HarmonicResponse:
    """The post-calibration half of both harmonic paths: DFT of the free
    load history, harmonic and quasi-static solves, reconstruction
    (``expand``: free-DOF vectors [S, n_free] -> [S, n_dof]), recovery."""
    c_re, c_im = real_dft_coeffs(F_f, n_h)
    omega = torch.as_tensor(wave.omega, dtype=dtype, device=ts.device)
    U_re, U_im = harmonic_solve_real(K_ff, M_ff, c_re, c_im, omega, alpha,
                                     beta)
    LKs, dKs = _chol_scaled(K_ff)
    Us_re = _cho_solve_scaled(LKs, dKs, c_re.mT).mT
    Us_im = _cho_solve_scaled(LKs, dKs, c_im.mT).mT
    U_time = expand(real_harmonic_reconstruct(U_re, U_im, omega, ts))
    U_static = expand(real_harmonic_reconstruct(Us_re, Us_im, omega, ts))
    return HarmonicResponse(
        ts=ts, U_time=U_time, U_static=U_static,
        utilization=util_of(U_time), utilization_static=util_of(U_static),
        daf=_max_translation(U_time)
        / torch.clamp(_max_translation(U_static), min=1e-30),
        omega=omega,
        rayleigh_alpha=torch.tensor(alpha, dtype=dtype, device=ts.device),
        rayleigh_beta=torch.tensor(beta, dtype=dtype, device=ts.device))


def dynamic_response(model, wave, case: LoadCase, n_harmonics: int = 6,
                     damping_ratio: float = 0.02, n_steps: int = 72,
                     n_gauss: int = 15, topside_mass_t: float | None = None,
                     support_stiffness=None,
                     added_mass_Ca=None) -> HarmonicResponse:
    """Steady-state dynamic response to the (nonlinear) Morison loading of
    one wave period, on the dense model (a few thousand DOF).

    The load history (drag super-harmonics included) is Fourier
    decomposed and each harmonic solved through (K + i w C - w^2 M) with
    Rayleigh damping calibrated to ``damping_ratio`` at the first two
    natural frequencies; the quasi-static response to the same loads gives
    the dynamic amplification factor (DAF).  ``topside_mass_t`` defaults
    to the case's custom self-weight tonnage."""
    dtype, dev = model.dtype, model.device
    case = case.cast(dtype, dev)
    _check_dynamics_loading(case, wave, periodic=True)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    with _full_f32_matmul():
        K, M, free, (K_local, T, L_m) = _build_km(
            model, case.E, case.nu, topside_mass_t, added_mass_Ca,
            case.rho_water)
        if support_stiffness is not None:
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        K_ff, M_ff = K[free][:, free], M[free][:, free]
        _, alpha, beta = _rayleigh(K_ff, M_ff, damping_ratio, dtype)
        ts = torch.arange(n_steps, dtype=dtype, device=dev) \
            * wave.T.to(dtype) / n_steps
        mb = _phase_loads(model, wave, case, ts, n_gauss)
        F_f = assemble_loads(model, case, mb.nodal_forces, L_m)[:, free]

        def expand(u):
            U = u.new_zeros(n_steps, model.n_dof)
            U[:, free] = u
            return U
        return _harmonic_response(
            K_ff, M_ff, F_f, expand,
            lambda U: _recover_util(model.sections, model.sect_id,
                                    model.conn, K_local, T, U, case.fy),
            wave, ts, min(n_harmonics, n_steps // 2), alpha, beta, dtype)


def _cb_reduce_forces(cb: CBReduction, F: torch.Tensor, nc: int,
                      n_seg: int, dtype) -> torch.Tensor:
    """Work-conjugate projection of full-mesh load vectors [..., n_dof_ref]
    to CB coordinates [..., n_red]: interface loads plus Psi^T of each
    chain's interior loads (summed onto the shared interface DOFs in a
    fixed order), then Phi^T of them."""
    lead = F.shape[:-1]
    Fn = F.reshape(*lead, -1, 6)
    F_b = Fn[..., :nc, :].reshape(*lead, -1)
    F_i = Fn[..., nc:, :].reshape(*lead, cb.Mc, (n_seg - 1) * 6)
    psi = torch.einsum("mnj,...mn->...mj", cb.Psi, F_i)
    F_b = F_b + node_sum_ordered(psi.reshape(*lead, -1, 1), cb.btable)[..., 0]
    F_q = torch.einsum("mnq,...mn->...mq", cb.Phi, F_i)
    return torch.cat([F_b, F_q.reshape(*lead, -1)], dim=-1).to(dtype)


def _cb_reduced_loads(cb: CBReduction, refined, case: LoadCase,
                      nodal_forces, nc: int, n_seg: int, dtype):
    """Full-mesh nodal force batches [S, n, 3] as CB loads [S, n_red],
    with the interface, self-weight, buoyancy and wind terms of
    :func:`..api.assemble_loads`."""
    return _cb_reduce_forces(cb, assemble_loads(refined, case, nodal_forces,
                                                cb.L_m), nc, n_seg, dtype)


def _cb_expand_free(cb: CBReduction, u_f: torch.Tensor) -> torch.Tensor:
    """Free reduced vectors [S, n_free] on the refined mesh [S, n_dof]."""
    U_red = u_f.new_zeros(u_f.shape[0], cb.n_red)
    U_red[:, cb.free] = u_f
    return _cb_expand(cb, U_red)


def _cb_util(cb: CBReduction, refined, fy):
    return lambda U: _recover_util(refined.sections, refined.sect_id,
                                   refined.conn, cb.K_local, cb.T, U, fy)


def dynamic_response_condensed(coarse, refined, n_seg: int, wave,
                               case: LoadCase, n_harmonics: int = 6,
                               damping_ratio: float = 0.02,
                               n_steps: int = 72, n_gauss: int = 15,
                               topside_mass_t: float | None = None,
                               n_chain_modes: int = 12,
                               support_stiffness=None,
                               added_mass_Ca=None) -> HarmonicResponse:
    """:func:`dynamic_response` of a refined jacket on the Craig-Bampton
    basis: the harmonic systems live in the refinement-independent reduced
    space, loads are evaluated on the full refined mesh (one launch of the
    Morison kernel on the card) and projected work-conjugately, responses
    are expanded back for full-field stress recovery."""
    dtype, dev = refined.dtype, refined.device
    case = case.cast(dtype, dev)
    _check_dynamics_loading(case, wave, periodic=True)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    cb = _cb_reduce(coarse, refined, n_seg, float(case.E), float(case.nu),
                    topside_mass_t, n_chain_modes,
                    support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca,
                    rho_water=float(case.rho_water))
    with _full_f32_matmul():
        K_ff, M_ff = _reduced_ff(cb)
        _, alpha, beta = _rayleigh(K_ff, M_ff, damping_ratio, dtype)
        ts = torch.arange(n_steps, dtype=dtype, device=dev) \
            * wave.T.to(dtype) / n_steps
        mb = _phase_loads(refined, wave, case, ts, n_gauss)
        F_f = _cb_reduced_loads(cb, refined, case, mb.nodal_forces, cb.nc,
                                n_seg, dtype)[:, cb.free]
        return _harmonic_response(
            K_ff, M_ff, F_f, lambda u: _cb_expand_free(cb, u),
            _cb_util(cb, refined, case.fy), wave, ts,
            min(n_harmonics, n_steps // 2), alpha, beta, dtype)


# ---------------------------------------------------------------------------
# Transient (time-domain) response
# ---------------------------------------------------------------------------

class TransientResponse(NamedTuple):
    """Direct time integration on the Craig-Bampton reduced basis."""

    ts: torch.Tensor              # [S] sample times
    U_time: torch.Tensor          # [S, n_dof_ref] displacements (mm/rad)
    utilization: torch.Tensor     # [S, M_ref] von Mises utilization
    tip_displacement_mm: torch.Tensor  # [S] max nodal translation per step
    omega1: torch.Tensor          # first natural frequency [rad/s]
    rayleigh_alpha: torch.Tensor
    rayleigh_beta: torch.Tensor


def _relative_drag_fn(refined, case: LoadCase, wave, n_gauss: int,
                      stretching: str, dtype):
    """Per-step relative-velocity Morison drag: ``drag_at(t, v_nodal) ->
    nodal [n, 3]`` (N) with U_rel = U_wave + U_current - v_structure
    (``v_nodal`` in m/s), whose velocity-coupled part is the hydrodynamic
    drag damping.  Equals :func:`..morison.morison_loads`' drag term at
    v = 0 (uniform current, analytic acceleration path); ``wave`` is a
    steady wave, a long-crested :class:`..spectrum.SpectralSea` (a spread
    sea raises ``ValueError``: its headings live in the phase batch, not
    pointwise) or None, still water (drag from the structure's motion
    alone).  Nodal sums run in a fixed order."""
    if isinstance(wave, SpectralSea) and wave.dir_deg is not None:
        raise ValueError("relative_drag supports long-crested seas only "
                         "(spread seas resolve per-mode headings in the "
                         "precomputed batch, not pointwise)")
    dev = refined.device
    conn_h, D_m, Cd_h, _ = hydro_members(refined, case.marine_growth_mm,
                                         case.Cd, case.Cm)
    theta_w = torch.deg2rad(90.0 - case.wave_dir_deg)
    theta_c = torch.deg2rad(90.0 - case.current_dir_deg)
    cos_w, sin_w = torch.cos(theta_w), torch.sin(theta_w)
    cos_c, sin_c = torch.cos(theta_c), torch.sin(theta_c)
    c1, dL, L = _member_vectors(refined.coords, conn_h)
    e = dL / L[:, None]
    s_np, w_np = gauss_legendre_01(n_gauss)
    s = torch.as_tensor(s_np, dtype=dtype, device=dev)
    w = torch.as_tensor(w_np, dtype=dtype, device=dev)
    pos = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [Mh, Q, 3]
    x_wave = pos[..., 0] * cos_w + pos[..., 1] * sin_w
    z = pos[..., 2]
    Cd = torch.as_tensor(Cd_h, dtype=dtype, device=dev)
    if Cd.ndim == 1:
        Cd = Cd[:, None]
    D, Lw, rho = D_m[:, None], L[:, None] * w[None, :], case.rho_water
    table = node_gather_table(torch.cat([conn_h[:, 0], conn_h[:, 1]]),
                              refined.n_nodes)
    if wave is not None:
        wave = wave.to(dtype, dev)

    def drag_at(t, v_nodal):
        if wave is None:                                  # still water
            sub = z <= 0.0
            subf = sub.to(dtype)
            U = torch.zeros_like(pos)
        else:
            kin = (sea_kinematics(wave, x_wave, z, t)
                   if isinstance(wave, SpectralSea)
                   else wave_kinematics(wave, x_wave, z, t,
                                        accel="analytic",
                                        stretching=stretching))
            sub = kin.submerged
            subf = sub.to(dtype)
            u_wave_only = kin.u - wave.U_c * subf
            U = torch.stack([u_wave_only * cos_w + wave.U_c * subf * cos_c,
                             u_wave_only * sin_w + wave.U_c * subf * sin_c,
                             kin.w], dim=-1)              # [Mh, Q, 3]
        v1, v2 = v_nodal[conn_h[:, 0]], v_nodal[conn_h[:, 1]]
        v_pt = ((1.0 - s)[None, :, None] * v1[:, None, :]
                + s[None, :, None] * v2[:, None, :])
        U_rel = U - v_pt * subf[..., None]
        eb = e[:, None, :]
        U_perp = U_rel - torch.sum(U_rel * eb, dim=-1, keepdim=True) * eb
        U_sq = torch.sum(U_perp * U_perp, dim=-1)
        U_mag = torch.where(U_sq > 0, torch.sqrt(torch.where(
            U_sq > 0, U_sq, torch.ones_like(U_sq))), torch.zeros_like(U_sq))
        drag_on = torch.logical_and(sub, U_mag > 1e-10).to(dtype)
        f = ((0.5 * rho * Cd * D * U_mag * Lw)[..., None] * U_perp
             * drag_on[..., None])
        F1 = torch.sum((1.0 - s)[None, :, None] * f, dim=1)
        F2 = torch.sum(s[None, :, None] * f, dim=1)
        return node_sum_ordered(torch.cat([F1, F2], dim=0), table)

    return drag_at


def _cb_project(cb: CBReduction, U_full: torch.Tensor) -> torch.Tensor:
    """A full refined displacement vector [n_dof_ref] in CB coordinates
    [n_red]: interface DOFs copy over; the generalized coordinates are the
    least-squares projection of v - Psi u_b onto span(Phi) (exact when it
    lies in that span)."""
    nc = cb.nc
    u_b = U_full[:6 * nc]
    v = U_full[6 * nc:].reshape(cb.Mc, -1)                # [Mc, N]
    ub_e = u_b[cb.bdof.reshape(-1)].reshape(cb.Mc, 12)
    resid = v - torch.einsum("mnj,mj->mn", cb.Psi, ub_e)
    G = torch.einsum("mnq,mnr->mqr", cb.Phi, cb.Phi)      # [Mc, m, m]
    b = torch.einsum("mnq,mn->mq", cb.Phi, resid)
    q = torch.linalg.solve(G, b[..., None])[..., 0]
    return torch.cat([u_b, q.reshape(-1)])


def transient_response_condensed(coarse, refined, n_seg: int, wave,
                                 case: LoadCase, dt: float, n_steps: int,
                                 damping_ratio: float = 0.02,
                                 n_gauss: int = 15,
                                 topside_mass_t: float | None = None,
                                 n_chain_modes: int = 12,
                                 support_stiffness=None,
                                 ramp_periods: float = 0.0,
                                 u0=None, zero_loads: bool = False,
                                 stretching: str = "none",
                                 added_mass_Ca=None,
                                 relative_drag: bool = False,
                                 drag_iterations: int = 1,
                                 ground_accel=None,
                                 ground_dir=(1.0, 0.0, 0.0),
                                 newmark=(0.25, 0.5)) -> TransientResponse:
    """Transient response on the Craig-Bampton reduced basis: Newmark-beta
    (average acceleration by default), the reduced effective matrix
    (K + a0 M + a1 C) factored once, then a march over the steps on the
    model's device.  The loads of all steps are evaluated up front (on the
    card one launch of the Morison kernel with S = ``n_steps``) and
    projected to the reduced basis.

    ``ramp_periods`` ramps the loading linearly over that many wave
    periods; ``u0`` (a full refined displacement vector, e.g. a scaled
    mode shape) sets the initial state; ``zero_loads=True`` integrates free
    vibration.  Rayleigh damping is calibrated to ``damping_ratio`` at the
    first two distinct natural frequencies.  ``relative_drag=True`` takes
    the drag term out of the precomputed loads and evaluates the
    relative-velocity Morison drag inside the march from the previous
    step's velocity (``drag_iterations=2`` adds a corrected pass at the new
    velocity): its velocity-coupled part is the hydrodynamic damping.
    ``ground_accel`` ([n_steps] m/s^2 along ``ground_dir``) adds seismic
    excitation F_eff = -M iota a_g; displacements are then relative to the
    ground.  ``wave`` may be a random sea (:class:`..spectrum.SpectralSea`:
    its loads are one launch of the kernel's general-mode instance on the
    card, the ramp counts peak periods Tp; relative drag takes a
    long-crested sea).
    """
    dtype, dev = refined.dtype, refined.device
    case = case.cast(dtype, dev)
    if not zero_loads:
        if wave is None:
            raise ValueError("transient_response_condensed needs a wave or "
                             "SpectralSea unless zero_loads=True (free "
                             "vibration)")
        _check_dynamics_loading(case, wave)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    cb = _cb_reduce(coarse, refined, n_seg, float(case.E), float(case.nu),
                    topside_mass_t, n_chain_modes,
                    support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca,
                    rho_water=float(case.rho_water))
    nc = cb.nc
    with _full_f32_matmul():
        K_ff, M_ff = _reduced_ff(cb)
        w1, alpha, beta_r = _rayleigh(K_ff, M_ff, damping_ratio, dtype)
        nf = K_ff.shape[0]
        ts = torch.arange(n_steps, dtype=dtype, device=dev) * dt
        ramp = torch.ones(n_steps, dtype=dtype, device=dev)
        if zero_loads:
            F_f = K_ff.new_zeros(n_steps, nf)
        else:
            # with relative drag the drag term is state-dependent and
            # evaluated inside the march: precompute the inertia (+ static)
            # loads only, with Cd = 0
            mb = _phase_loads(refined, wave, case, ts, n_gauss, stretching,
                              Cd=0.0 if relative_drag else None)
            F_f = _cb_reduced_loads(cb, refined, case, mb.nodal_forces, nc,
                                    n_seg, dtype)[:, cb.free]
            if ramp_periods > 0:
                T_ramp = float(wave.Tp if isinstance(wave, SpectralSea)
                               else wave.T)
                ramp = torch.clamp(ts / (ramp_periods * T_ramp), max=1.0)
                F_f = F_f * ramp[:, None]
        if ground_accel is not None:
            ag = torch.as_tensor(ground_accel, dtype=dtype, device=dev)
            if ag.shape[0] != n_steps:
                raise ValueError(f"ground_accel has {ag.shape[0]} samples "
                                 f"but n_steps = {n_steps}")
            gd = np.asarray(ground_dir, np.float64)
            gd = gd / np.linalg.norm(gd)
            # consistent-mass rigid influence vector on the reduced basis:
            # interface translations (supports included), zero modal coords
            iota = K_ff.new_zeros(cb.n_red)
            for c in range(3):
                iota[c:6 * nc:6] = float(gd[c])
            b = (cb.M_red @ iota)[cb.free]                # tonnes
            # F_eff = -M iota a_g; m/s^2 -> mm/s^2, so t mm/s^2 = N
            F_f = F_f - b[None, :] * (ag * 1e3)[:, None]

        C_ff = alpha * M_ff + beta_r * K_ff
        bN, gN = newmark
        a0, a1, a2 = 1.0 / (bN * dt * dt), gN / (bN * dt), 1.0 / (bN * dt)
        a3, a4 = 1.0 / (2.0 * bN) - 1.0, gN / bN - 1.0
        a5 = dt / 2.0 * (gN / bN - 2.0)
        every = torch.arange(nf, device=dev)
        fac = factor_dense(K_ff + a0 * M_ff + a1 * C_ff, every)

        drag_reduced = None
        if relative_drag:
            drag_at = _relative_drag_fn(refined, case,
                                        None if zero_loads else wave,
                                        n_gauss, stretching, dtype)

            def drag_reduced(t, v_free):
                v_nodal = _cb_expand_free(cb, v_free[None])[0] \
                    .reshape(-1, 6)[:, :3] / 1e3          # mm/s -> m/s
                F_full = K_ff.new_zeros(refined.n_nodes, 6)
                F_full[:, :3] = drag_at(t, v_nodal)
                return _cb_reduce_forces(cb, F_full.reshape(-1), nc, n_seg,
                                         dtype)[cb.free]

        u = (_cb_project(cb, torch.as_tensor(u0, dtype=dtype,
                                             device=dev))[cb.free]
             if u0 is not None else K_ff.new_zeros(nf))
        v = K_ff.new_zeros(nf)
        # consistent initial acceleration: M a = F0 - C v0 - K u0
        F0 = F_f[0]
        if relative_drag:   # the wave-drag action ramps like the loads
            F0 = F0 + ramp[0] * drag_reduced(ts[0], v)
        acc = solve_factored(factor_dense(M_ff, every),
                             F0 - K_ff @ u - C_ff @ v)

        def newmark_update(u1, u, v, acc):
            acc1 = a0 * (u1 - u) - a2 * v - a3 * acc
            return acc1, v + dt * ((1.0 - gN) * acc + gN * acc1)

        passes = max(int(drag_iterations), 1) if relative_drag else 1
        u_hist = [u]
        for i in range(1, n_steps):
            hist = (M_ff @ (a0 * u + a2 * v + a3 * acc)
                    + C_ff @ (a1 * u + a4 * v + a5 * acc))
            v_drag = v              # the lagged velocity, then corrector passes
            for _ in range(passes):
                if relative_drag:
                    Fd = ramp[i] * drag_reduced(ts[i], v_drag)
                    u1 = solve_factored(fac, F_f[i] + Fd + hist)
                else:
                    u1 = solve_factored(fac, F_f[i] + hist)
                acc1, v1 = newmark_update(u1, u, v, acc)
                v_drag = v1
            u, v, acc = u1, v1, acc1
            u_hist.append(u)

        U_time = _cb_expand_free(cb, torch.stack(u_hist))  # [S, n_dof_ref]
        return TransientResponse(
            ts=ts, U_time=U_time,
            utilization=_cb_util(cb, refined, case.fy)(U_time),
            tip_displacement_mm=torch.amax(torch.linalg.norm(
                U_time.reshape(n_steps, -1, 6)[:, :, :3], dim=-1), dim=-1),
            omega1=torch.tensor(w1, dtype=dtype, device=dev),
            rayleigh_alpha=torch.tensor(alpha, dtype=dtype, device=dev),
            rayleigh_beta=torch.tensor(beta_r, dtype=dtype, device=dev))


def mac(shapes_a, shapes_b) -> torch.Tensor:
    """Modal Assurance Criterion matrix between two mode-shape sets
    [n_modes, n_dof] on the same DOF layout: MAC_ij = (a_i . b_j)^2 /
    (|a_i|^2 |b_j|^2) in [0, 1] (1: the same shape up to scale)."""
    A, B = torch.as_tensor(shapes_a), torch.as_tensor(shapes_b)
    num = (A @ B.mT) ** 2
    den = torch.sum(A * A, dim=1)[:, None] * torch.sum(B * B, dim=1)[None, :]
    return num / torch.clamp(den, min=1e-300)
