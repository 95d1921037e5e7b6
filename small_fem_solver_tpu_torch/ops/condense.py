"""Exact substructure condensation for refined jacket models (PyTorch
counterpart of ``small_fem_solver_tpu/ops/condense.py``).

``refine_model(m, n_seg)`` subdivides every member into a chain of
``n_seg`` elements whose interior nodes couple only along the chain.
Eliminating the interior DOFs exactly (block-tridiagonal Gaussian
elimination, the block Thomas algorithm) reduces the refined system to a
superelement problem on the original interface nodes — 126 DOF for the
default jacket at any refinement.  The factorization is batched over
members (a Python loop over chain levels, all Mc chains per step).  The
load sweep is multi-RHS (all wave phases ride one sweep): on the card it is
one launch of the hand-written kernel ``csrc/chain_sweep.cu``
(``ops/hopper_kernels.py::chain_sweep_cuda``), on the CPU its plain version
:func:`chain_sweep_plain`.

Chain block structure for one member (n = n_seg elements, chain nodes
0..n where 0 and n are interface nodes): element p has K = [[A_p, B_p],
[C_p, E_p]]; interior diagonal D_p = E_{p-1} + A_p; off-diagonals
T[p, p+1] = B_p, T[p+1, p] = C_p; interface coupling row 1 <- C_0 u_I,
row n-1 <- B_{n-1} u_J.  The Schur complement onto (u_I, u_J) is

    K_super = [[A_0, 0], [0, E_{n-1}]]
              - [[B_0 Z0_1, B_0 Zn_1], [C_{n-1} Z0_{n-1}, C_{n-1} Zn_{n-1}]]

with Z0 = T^{-1} [C_0; 0; ...], Zn = T^{-1} [...; 0; B_{n-1}].

Every 6x6 pivot is symmetrically Jacobi-scaled before its Cholesky: the
rotational and translational DOFs differ by ~L^2 in magnitude, and the
unscaled Schur blocks lose definiteness to float32 rounding.  A pivot
that is not positive definite (a chain past buckling in a P-delta round)
gives NaN, as in the JAX package, not an error.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .hopper_kernels import chain_sweep_cuda
from .solve import cholesky_or_nan


def node_sum(values: torch.Tensor, nodes: torch.Tensor,
             n_nodes: int) -> torch.Tensor:
    """``values`` [..., E, c] summed onto ``nodes`` [E] -> [..., n_nodes, c].

    A contraction with the dense [n_nodes, E] incidence matrix instead of
    an atomic scatter, so sums run in a fixed order (bit-repeatable on the
    card); the condensed paths use it only for interface nodes, where
    n_nodes and E are small.
    """
    inc = (nodes[None, :] == torch.arange(n_nodes, device=nodes.device)
           [:, None]).to(values.dtype)
    return torch.einsum("ne,...ec->...nc", inc, values)


class ChainFactor(NamedTuple):
    """Factorized interior chains + superelement matrices (Mc chains,
    n_int = n_seg - 1 interior nodes each)."""

    K_super: torch.Tensor   # [Mc, 12, 12] condensed superelement stiffness
    Cprime: torch.Tensor    # [n_int, Mc, 6, 6] Thomas upper factors
    DinvL: torch.Tensor     # [n_int, Mc, 6, 6] denom^{-1} L_p
    Dinv: torch.Tensor      # [n_int, Mc, 6, 6] denom^{-1}
    Z0: torch.Tensor        # [n_int, Mc, 6, 6] T^{-1} L0 columns
    Zn: torch.Tensor        # [n_int, Mc, 6, 6] T^{-1} Ln columns
    B0: torch.Tensor        # [Mc, 6, 6] element-0 coupling (K_01)
    Cn: torch.Tensor        # [Mc, 6, 6] element-(n-1) coupling (K_10)


def factor_chains(K_elems: torch.Tensor, n_seg: int) -> ChainFactor:
    """Factor all member chains at once.  ``K_elems``: [Mc * n_seg, 12, 12]
    refined-element global stiffness in ``refine_model``'s member-major
    order."""
    Mc = K_elems.shape[0] // n_seg
    Ke = K_elems.reshape(Mc, n_seg, 12, 12)
    A, B = Ke[:, :, :6, :6], Ke[:, :, :6, 6:]
    C, E = Ke[:, :, 6:, :6], Ke[:, :, 6:, 6:]
    n_int = n_seg - 1

    D_t = (E[:, :-1] + A[:, 1:]).movedim(1, 0)    # [n_int, Mc, 6, 6]
    U_t = B[:, 1:].movedim(1, 0)
    L_t = C[:, 1:].movedim(1, 0)
    # interior row p couples right via B_p (p < n_int; the last row's B
    # couples to u_J through Ln_last) and left via C_{p-1} (p >= 2)
    U_pad = torch.cat([U_t[:-1], torch.zeros_like(U_t[:1])])
    L_pad = torch.cat([torch.zeros_like(L_t[:1]), L_t[:-1]])
    L0_first = C[:, 0]
    Ln_last = B[:, -1]

    zeros = K_elems.new_zeros(Mc, 6, 6)
    eye = torch.eye(6, dtype=K_elems.dtype,
                    device=K_elems.device).expand(Mc, 6, 6)
    cprime, z0, zn = zeros, zeros, zeros
    Cp, DinvL, Dinv, Z0f, Znf = [], [], [], [], []
    for p in range(n_int):
        Lp = L_pad[p]
        denom = D_t[p] - Lp @ cprime
        rhs0 = (L0_first if p == 0 else 0.0) - Lp @ z0
        rhs = torch.cat([U_pad[p], rhs0, -Lp @ zn, Lp, eye], dim=-1)
        dd = 1.0 / torch.sqrt(torch.abs(torch.diagonal(denom, dim1=-2,
                                                       dim2=-1)))
        Ld = cholesky_or_nan(denom * dd[..., :, None] * dd[..., None, :])
        x = dd[..., :, None] * torch.cholesky_solve(dd[..., :, None] * rhs,
                                                    Ld)
        cprime, z0, zn, dinvl, dinv = x.split(6, dim=-1)
        Cp.append(cprime)
        DinvL.append(dinvl)
        Dinv.append(dinv)
        Z0f.append(z0)
        Znf.append(zn)
    # Ln enters the RHS of the last interior row
    Znf[-1] = Znf[-1] + Dinv[-1] @ Ln_last

    v0, vn = zeros, zeros
    Z0b, Znb = [None] * n_int, [None] * n_int
    for p in reversed(range(n_int)):
        v0 = Z0f[p] - Cp[p] @ v0
        vn = Znf[p] - Cp[p] @ vn
        Z0b[p], Znb[p] = v0, vn

    # contiguous, so the sweep kernel takes them without a per-call copy
    B0, Cn = B[:, 0].contiguous(), C[:, -1].contiguous()
    K_super = torch.cat([
        torch.cat([A[:, 0] - B0 @ Z0b[0], -B0 @ Znb[0]], dim=-1),
        torch.cat([-Cn @ Z0b[-1], E[:, -1] - Cn @ Znb[-1]], dim=-1),
    ], dim=-2)
    return ChainFactor(K_super=K_super, Cprime=torch.stack(Cp),
                       DinvL=torch.stack(DinvL), Dinv=torch.stack(Dinv),
                       Z0=torch.stack(Z0b), Zn=torch.stack(Znb), B0=B0,
                       Cn=Cn)


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A[m] @ x[..., m, :]`` for A [Mc, 6, 6], x [..., Mc, 6]."""
    return torch.einsum("mij,...mj->...mi", A, x)


def chain_sweep_plain(fac: ChainFactor, g: torch.Tensor):
    """Plain PyTorch version of the chain-sweep kernel: forward sweep
    y_l = Dinv_l g_l - DinvL_l y_{l-1}, backward substitution
    v_l = y_l - C'_l v_{l+1}, interface extras fI = -B0 v_0,
    fJ = -Cn v_{n_int-1}.  ``g``: [..., n_int, Mc, 6]; returns
    (fI [..., Mc, 6], fJ [..., Mc, 6], v [..., n_int, Mc, 6])."""
    g_t = g.movedim(-3, 0)
    n_int = g_t.shape[0]
    y = torch.zeros_like(g_t[0])
    ys = []
    for p in range(n_int):
        y = _bmv(fac.Dinv[p], g_t[p]) - _bmv(fac.DinvL[p], y)
        ys.append(y)
    v = torch.zeros_like(y)
    vs = [None] * n_int
    for p in reversed(range(n_int)):
        v = ys[p] - _bmv(fac.Cprime[p], v)
        vs[p] = v
    return (-_bmv(fac.B0, vs[0]), -_bmv(fac.Cn, vs[-1]),
            torch.stack(vs, dim=-3))


def condense_loads(fac: ChainFactor, g: torch.Tensor, split: bool = False):
    """Condense interior loads ``g`` [..., n_int, Mc, 6] onto the
    interfaces.  Returns (f_I_extra, f_J_extra, v) where the extras
    [..., Mc, 6] are ADDED to the interface loads and ``v`` = T^{-1} g is
    the particular interior solution for back-substitution.  With
    ``split``, ``g`` is a view [..., n_int, Mc', Q, 6] of the chains
    c = m' Q + q (the nested level-1 layout).

    CUDA tensors go through the chain-sweep kernel (one launch, reading
    ``g`` in its own layout), CPU tensors through :func:`chain_sweep_plain`."""
    if g.is_cuda:
        return chain_sweep_cuda(fac, g, split)
    if split:
        g = g.reshape(*g.shape[:-3], g.shape[-3] * g.shape[-2], 6)
    return chain_sweep_plain(fac, g)


def back_substitute(fac: ChainFactor, v_g, u_I, u_J):
    """Interior displacements v = v_g - Z0 u_I - Zn u_J from the interface
    solution (``u_I``, ``u_J``: [..., Mc, 6]; result [..., n_int, Mc, 6])."""
    return (v_g - torch.einsum("pmij,...mj->...pmi", fac.Z0, u_I)
            - torch.einsum("pmij,...mj->...pmi", fac.Zn, u_J))


def chain_matvec(K_elems: torch.Tensor, n_seg: int, conn_coarse, U_I_nodes,
                 v):
    """K @ U for the refined chain system, computed in the condensed
    layout (used for the iterative-refinement residual).

    ``U_I_nodes``: [S, nc, 6] interface displacements; ``v``:
    [S, n_int, Mc, 6] interior displacements.  Each element's 12-term end
    force dot is formed in one accumulator (element end forces cancel
    inside it; summing pre-rounded 6x6 block products loses float32
    residual accuracy).  Returns (y_I [S, nc, 6], y_int [S, n_int, Mc, 6]).
    """
    Mc = K_elems.shape[0] // n_seg
    Ke = K_elems.reshape(Mc, n_seg, 12, 12)
    u1 = U_I_nodes[:, conn_coarse[:, 0]]
    u2 = U_I_nodes[:, conn_coarse[:, 1]]
    vext = torch.cat([u1[:, None], v, u2[:, None]], dim=1)
    u_e = torch.cat([vext[:, :-1], vext[:, 1:]], dim=-1)  # [S, n_seg, Mc, 12]
    f_e = torch.einsum("mpij,spmj->spmi", Ke, u_e)
    y_int = f_e[:, :-1, :, 6:] + f_e[:, 1:, :, :6]
    ends = torch.cat([f_e[:, 0, :, :6], f_e[:, -1, :, 6:]], dim=1)
    nodes = torch.cat([conn_coarse[:, 0], conn_coarse[:, 1]])
    return node_sum(ends, nodes, U_I_nodes.shape[1]), y_int


# ---------------------------------------------------------------------------
# Nested (two-level) condensation
# ---------------------------------------------------------------------------

class NestedChainFactor(NamedTuple):
    """Two-level chain factorization, n_seg = n_outer * n_sub: level 1
    condenses every sub-chain of ``n_sub`` elements onto its end nodes,
    level 2 the resulting chain of ``n_outer`` superelements onto the
    member interfaces.  Each level's chains are shallow (better float32
    conditioning) and the sequential depth drops to n_outer + n_sub."""

    K_super: torch.Tensor    # [Mc, 12, 12]
    fac1: ChainFactor        # level 1: Mc * n_outer chains of n_sub elements
    fac2: ChainFactor        # level 2: Mc chains of n_outer superelements


def nested_split(n_seg: int) -> int:
    """n_sub | n_seg with both factors near sqrt(n_seg); raises if n_seg
    has no divisor pair with both factors >= 2."""
    best = None
    for d in range(2, int(np.sqrt(n_seg)) + 1):
        if n_seg % d == 0:
            best = d
    if best is None:
        raise ValueError(
            f"n_seg={n_seg} has no balanced two-level split (prime); "
            "choose a composite refinement level (e.g. 324 = 18*18, "
            "336 = 16*21)")
    return n_seg // best


def factor_chains_nested(K_elems: torch.Tensor, n_seg: int,
                         n_sub: int | None = None) -> NestedChainFactor:
    """Two-level factorization; same inputs and meaning as
    :func:`factor_chains`."""
    if n_sub is None:
        n_sub = nested_split(n_seg)
    if n_seg % n_sub != 0:
        raise ValueError(f"n_sub={n_sub} must divide n_seg={n_seg}")
    n_outer = n_seg // n_sub
    if n_outer < 2 or n_sub < 2:
        raise ValueError("nested condensation needs n_outer, n_sub >= 2")
    fac1 = factor_chains(K_elems, n_sub)
    fac2 = factor_chains(fac1.K_super, n_outer)
    return NestedChainFactor(K_super=fac2.K_super, fac1=fac1, fac2=fac2)


def _nested_dims(fac: NestedChainFactor):
    Mc = fac.fac2.K_super.shape[0]
    n_outer = fac.fac1.K_super.shape[0] // Mc
    n_sub = fac.fac1.Cprime.shape[0] + 1
    return Mc, n_outer, n_sub


def condense_loads_nested(fac: NestedChainFactor, g: torch.Tensor):
    """Nested :func:`condense_loads` (the particular solution is the
    (v_g1, v_g2) pair); ``g``: [..., n_int, Mc, 6] in chain-position order."""
    Mc, n_outer, n_sub = _nested_dims(fac)
    batch = g.shape[:-3]
    # chain position k = q * n_sub + p (k = 1..n_seg-1) is g[..., k - 1]
    # level 1: interiors p = 1..n_sub-1 of sub-chain q, chain index
    # c = m * n_outer + q, as a strided view of g (no copy on the card)
    sP, sM, sK = g.stride()[-3:]
    g1 = g.as_strided((*batch, n_sub - 1, Mc, n_outer, 6),
                      (*g.stride()[:-3], sP, sM, n_sub * sP, sK),
                      g.storage_offset())
    fI1, fJ1, v_g1 = condense_loads(fac.fac1, g1, split=True)
    fI1 = fI1.reshape(*batch, Mc, n_outer, 6)
    fJ1 = fJ1.reshape(*batch, Mc, n_outer, 6)

    # level 2: sub-chain boundaries j = 1..n_outer-1 (positions j * n_sub)
    # take their direct load plus both neighbours' condensates
    g2 = (g[..., n_sub - 1::n_sub, :, :] + fJ1[..., :-1, :].movedim(-2, -3)
          + fI1[..., 1:, :].movedim(-2, -3))
    fI2, fJ2, v_g2 = condense_loads(fac.fac2, g2)
    return fI1[..., 0, :] + fI2, fJ1[..., -1, :] + fJ2, (v_g1, v_g2)


def back_substitute_nested(fac: NestedChainFactor, v_g, u_I, u_J):
    """Nested :func:`back_substitute` (same contract)."""
    Mc, n_outer, n_sub = _nested_dims(fac)
    v_g1, v_g2 = v_g
    batch = u_I.shape[:-2]
    v2 = back_substitute(fac.fac2, v_g2, u_I, u_J)   # [..., n_outer-1, Mc, 6]

    # sub-chain boundary table j = 0..n_outer: u_I, v2..., u_J
    vb = torch.cat([u_I[..., None, :, :], v2, u_J[..., None, :, :]], dim=-3)
    u_sub_I = vb[..., :-1, :, :].movedim(-3, -2).reshape(
        *batch, Mc * n_outer, 6)
    u_sub_J = vb[..., 1:, :, :].movedim(-3, -2).reshape(
        *batch, Mc * n_outer, 6)
    v1 = back_substitute(fac.fac1, v_g1, u_sub_I, u_sub_J)

    # back to chain-position order k = q * n_sub + p
    v1qp = v1.reshape(*batch, n_sub - 1, Mc, n_outer, 6).movedim(-2, -4)
    heads = torch.cat([v1.new_zeros(*batch, 1, 1, Mc, 6),
                       v2[..., :, None, :, :]], dim=-4)
    vfull = torch.cat([heads, v1qp], dim=-3).reshape(
        *batch, n_outer * n_sub, Mc, 6)
    return vfull[..., 1:, :, :]
