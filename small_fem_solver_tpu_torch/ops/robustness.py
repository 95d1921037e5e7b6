"""Damage-tolerance (member-removal) robustness screen (PyTorch
counterpart of ``small_fem_solver_tpu/ops/robustness.py``).

ISO 19902 / NORSOK N-001 accidental-limit-state practice: the structure is
to survive the loss of any single member.  Every single-member-removed
configuration is one state of a batch: the damaged stiffnesses K_intact -
(member m's assembled block) [M, n_dof, n_dof], one batched Jacobi-scaled
Cholesky (:func:`.solve.factor_dense`) and one batched solve with the
shared intact load vector; the JAX module runs the same as a ``vmap``
over the member axis.

Simplifications (the JAX module's): the removed member keeps its
hydrodynamic load share, and the loads are the intact case's (pass a
reduced ALS environment as the case).  A removal that leaves a mechanism
makes the damaged stiffness singular: its Cholesky gives NaN (or, when
roundoff keeps it barely positive, a huge displacement) and the state is
flagged unstable, not raised.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .assembly import assemble_dense, element_dof_indices
from .beams import element_stiffness, internal_forces
from .morison import hydro_members, morison_loads
from .sections import von_mises_8pt
from .solve import (factor_dense, free_fixed_dofs, solve_factored,
                    support_spring_nodes)

_MECHANISM_MM = 1e7      # a damaged state displacing this far is unstable


class RemovalScreen(NamedTuple):
    """One row per removed member (the damage axis)."""

    max_util: torch.Tensor            # [M] peak utilization of the OTHERS
    max_displacement_mm: torch.Tensor  # [M]
    stable: torch.Tensor              # [M] bool: finite, solvable state
    critical: torch.Tensor            # [M] bool: unstable OR utilization > 1
    governing_member: torch.Tensor    # [M] int: worst OTHER member
    intact_util: torch.Tensor         # [] intact-state peak utilization


def member_removal_screen(model, wave, case, n_gauss: int = 15,
                          accel: str = "analytic",
                          support_stiffness=None) -> RemovalScreen:
    """Single-member-removal screen over every member: all M damaged
    states in one batched factorization and solve, on the model's device.

    ``critical[m]`` marks members whose loss makes the damaged state
    unstable (singular stiffness, displacement past 1e7 mm) or drives
    another member past yield (utilization > 1).
    """
    from ..api import _full_f32_matmul, assemble_loads

    dtype, device = model.dtype, model.device
    case = case.cast(dtype, device)
    G = case.E / (2.0 * (1.0 + case.nu))
    with _full_f32_matmul():
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id, case.E,
            G, release=model.release)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                                case.Cd, case.Cm)
        mor = morison_loads(wave, model.coords, conn_h, D_m,
                            case.wave_dir_deg, case.current_dir_deg, Cd_h,
                            Cm_h, case.rho_water, case.t_analysis,
                            n_gauss=n_gauss, accel=accel,
                            slam_cs=case.slam_cs)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        if support_stiffness is not None:
            K = K + torch.diag(torch.as_tensor(support_spring_nodes(
                model.fixed_mask, support_stiffness).reshape(-1),
                dtype=dtype, device=device))
            free = np.arange(model.n_dof)
        else:
            free = free_fixed_dofs(model.fixed_mask)[0]

        dofs = element_dof_indices(model.conn)
        M = model.n_members
        # damaged stiffness of every removal: K minus member m's block (the
        # 12 DOFs of a member are distinct, so each entry is written once)
        Kd = K.expand(M, -1, -1).clone()
        m = torch.arange(M, device=device)[:, None, None]
        Kd[m, dofs[:, :, None], dofs[:, None, :]] -= Kg
        U = solve_factored(factor_dense(Kd, free), F)          # [M, n_dof]

        def utilization(U):
            F1, _ = internal_forces(K_local, T, U[..., dofs])
            return von_mises_8pt(model.sections, model.sect_id,
                                 *(F1[..., c] for c in range(6))) / case.fy

        util = utilization(U) * (1.0 - torch.eye(M, dtype=dtype,
                                                 device=device))
        util_d = torch.max(util, dim=-1).values                # not itself
        disp_d = torch.max(torch.linalg.norm(U.reshape(M, -1, 6)[..., :3],
                                             dim=-1), dim=-1).values
        intact = torch.max(utilization(solve_factored(factor_dense(K, free),
                                                      F)))
    stable = torch.isfinite(util_d) & torch.isfinite(disp_d) \
        & (disp_d < _MECHANISM_MM)
    return RemovalScreen(
        max_util=util_d, max_displacement_mm=disp_d, stable=stable,
        critical=torch.logical_or(~stable, util_d > 1.0),
        governing_member=torch.argmax(util, dim=-1), intact_util=intact)
