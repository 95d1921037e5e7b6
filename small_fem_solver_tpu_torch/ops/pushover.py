"""Pushover analysis and Reserve Strength Ratio (RSR) (PyTorch counterpart
of ``small_fem_solver_tpu/ops/pushover.py``).

Gravity is held and the environmental actions (wave, current, wind,
topside shear and overturning moment) are scaled by lambda; members yield
axially, elastic-perfectly-plastic: tension capacity A fy, compression
min(A fy, pi^2 E I / (K L)^2) (Euler with ``k_factor``, no post-buckling
loss unless ``residual`` < 1).  Bending stays elastic, so a leg-bending
mechanism is not captured (check ``n_yielded`` at the RSR).

Solution: the secant (load-shedding) iteration of the JAX module.  Each
member's axial stiffness is scaled by s_m, the damped update s <- (s +
min(1, cap / |N_trial|)) / 2 runs ``n_iter`` times, and convergence is
judged on the capacity violation.  The JAX module runs it as a ``vmap``
over lambda of a ``lax.scan``; here every step is three batched pieces
of work over the whole lambda grid (and, in :func:`pushover_rose`, every
heading): the stiffness [B, n_dof, n_dof], one batched Jacobi-scaled
Cholesky (:func:`.solve.factor_dense`) and one batched solve.  The axial
term separates from the element (K_local = K_rest + (EA/L) P0), so the
stiffness of a state is the assembled K_rest plus a sum of rank-one
member terms: K(s) = K_rest + B diag(s EA/L) B^T with B's column m the
member's axial direction on its end translations (-l_x, +l_x), one
batched product a step.

Practical collapse: the first lambda whose displacement tangent exceeds
``collapse_ratio`` times the elastic slope, or the first state that does
not converge or is not finite (:func:`_rsr_from_curve`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .assembly import assemble_dense, element_dof_indices
from .beams import element_stiffness, matvec12
from .morison import hydro_members, morison_loads
from .sections import von_mises_8pt
from .solve import (factor_dense, free_fixed_dofs, solve_factored,
                    support_spring_nodes)


class PushoverResults(NamedTuple):
    """Pushover curve over the lambda grid."""

    lambdas: torch.Tensor        # [L] environmental load factors
    converged: torch.Tensor      # [L] bool: secant fixed point reached
    max_displacement_mm: torch.Tensor  # [L]
    n_yielded: torch.Tensor      # [L] members at capacity
    max_util: torch.Tensor       # [L] peak von Mises utilization (capped)
    axial_N: torch.Tensor        # [L, M] member axial force (+ compression)
    capacity_N: torch.Tensor     # [M] axial capacity (+ compression side)
    first_yield_lambda: torch.Tensor  # first lambda with a yielded member
    rsr: torch.Tensor            # reserve strength ratio
    F_perm: torch.Tensor         # [n_dof] constant (gravity) loads
    F_env: torch.Tensor          # [n_dof] unit environmental loads


def _split_loads(model, wave, case, n_gauss, accel):
    """(F_perm, F_env): permanent vs environmental actions.

    Environmental (scaled by lambda): Morison wave + current, wind
    (members and topside block), topside shear and overturning moment.
    Permanent: topside axial load, self-weight, buoyancy.
    """
    from ..api import assemble_loads

    case = case.cast(model.dtype, model.device)
    conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                            case.Cd, case.Cm)
    mor = morison_loads(wave, model.coords, conn_h, D_m, case.wave_dir_deg,
                        case.current_dir_deg, Cd_h, Cm_h, case.rho_water,
                        case.t_analysis, n_gauss=n_gauss, accel=accel,
                        slam_cs=case.slam_cs)
    L = torch.linalg.norm(model.coords[model.conn[:, 1]]
                          - model.coords[model.conn[:, 0]], dim=-1)
    perm_case = dataclasses.replace(case, F_shear_kN=0.0, M_moment_kNm=0.0,
                                    M_torsion_kNm=0.0, wind_speed_ms=0.0,
                                    wind_topside_area_m2=0.0)
    env_case = dataclasses.replace(case, F_axial_kN=0.0, sw_mode="none",
                                   buoyancy="none")
    F_perm = assemble_loads(model, perm_case.cast(model.dtype, model.device),
                            torch.zeros_like(mor.nodal_forces), L)
    F_env = assemble_loads(model, env_case.cast(model.dtype, model.device),
                           mor.nodal_forces, L)
    return F_perm, F_env


def _make_curves_fn(model, case, n_iter, k_factor, residual, tol,
                    support_stiffness):
    """(curves(F_perm, F_env, lambdas) -> per-state tensors, cap_c).

    Element data, capacities and boundary conditions are set up once;
    ``curves`` takes ``lambdas`` [B] and ``F_env`` [n_dof] or [B, n_dof]
    (one environmental load a state: the rose's headings)."""
    dtype, device = model.dtype, model.device
    case = case.cast(dtype, device)
    G = case.E / (2.0 * (1.0 + case.nu))
    Kg, K_local, T, L_m = element_stiffness(
        model.coords, model.conn, model.sections, model.sect_id, case.E, G,
        release=model.release)

    # axial split: K_local = K_rest + (EA/L) P0 (releases leave the axial
    # rows untouched, so the split commutes with them)
    P0 = torch.zeros(12, 12, dtype=dtype, device=device)
    P0[0, 0] = P0[6, 6] = 1.0
    P0[0, 6] = P0[6, 0] = -1.0
    k_ax = K_local[:, 0, 0]                           # EA/L [N/mm]
    K_rest = K_local - k_ax[:, None, None] * P0
    K_rest_g = assemble_dense(T.mT @ K_rest @ T, model.conn, model.n_dof)
    # B [n_dof, M]: member m's axial direction on its end translations
    dofs = element_dof_indices(model.conn)
    lx = T[:, 0, :3]
    Bax = K_local.new_zeros(model.n_dof, model.n_members)
    cols = torch.arange(model.n_members, device=device)
    Bax[dofs[:, 0:3], cols[:, None]] = -lx
    Bax[dofs[:, 6:9], cols[:, None]] = lx

    # capacities [N]: tension A fy; compression min(A fy, Euler)
    A = model.sections.Ax[model.sect_id]
    Iy = model.sections.Iy[model.sect_id]
    P_y = A * case.fy
    P_e = math.pi**2 * case.E * Iy / (k_factor * L_m * 1000.0) ** 2
    cap_t = P_y
    cap_c = torch.minimum(P_y, P_e)

    if support_stiffness is not None:
        ks = torch.as_tensor(support_spring_nodes(
            model.fixed_mask, support_stiffness).reshape(-1), dtype=dtype,
            device=device)
        K_rest_g = K_rest_g + torch.diag(ks)
        free = np.arange(model.n_dof)
    else:
        free = free_fixed_dofs(model.fixed_mask)[0]

    def solve_state(F, s):
        """States' secant solves: U [B, n_dof], u_elem [B, M, 12] and the
        elastic trial axial force [B, M] (+ tension) that the update
        drives to capacity."""
        K = K_rest_g + (Bax * (s * k_ax)[:, None, :]) @ Bax.T
        U = solve_factored(factor_dense(K, free), F)
        u_elem = U[:, dofs]
        u_loc = matvec12(T, u_elem)
        return U, u_elem, k_ax * (u_loc[..., 6] - u_loc[..., 0])

    def curves(F_perm, F_env, lambdas):
        F = F_perm + lambdas[:, None] * F_env
        s = torch.ones(lambdas.shape[0], model.n_members, dtype=dtype,
                       device=device)
        for _ in range(n_iter):
            _, _, N_trial = solve_state(F, s)
            cap = torch.where(N_trial >= 0, cap_t, cap_c) * residual
            absN = torch.abs(N_trial)
            s_new = torch.where(absN > cap,
                                cap / torch.clamp(absN, min=1e-30), 1.0)
            # damped update stabilizes alternating load shedding
            s = 0.5 * (s + s_new)
        U, u_elem, N_trial = solve_state(F, s)
        cap = torch.where(N_trial >= 0, cap_t, cap_c) * residual
        carried = torch.abs(N_trial) * s
        viol = torch.max(torch.clamp(carried - cap, min=0.0) / cap, dim=-1)
        # end forces of K_local(s) = K_rest + s (EA/L) P0, node 1 negated
        u_loc = matvec12(T, u_elem)
        F1 = -(matvec12(K_rest, u_loc)
               + (s * k_ax)[..., None] * (u_loc @ P0.T))[..., :6]
        vm = von_mises_8pt(model.sections, model.sect_id,
                           *(F1[..., c] for c in range(6)))
        disp = torch.max(torch.linalg.norm(
            U.reshape(U.shape[0], -1, 6)[..., :3], dim=-1), dim=-1).values
        conv = torch.logical_and(viol.values < tol, torch.isfinite(disp))
        n_yield = torch.sum(s < 1.0 - 1e-9, dim=-1)
        return (conv, disp, n_yield, torch.max(vm, dim=-1).values / case.fy,
                -carried * torch.sign(N_trial))

    return curves, cap_c


def _lambda_grid(lambda_max: float, n_lambda: int, dtype, device):
    """``jnp.linspace(0, lambda_max, n_lambda)`` bit for bit (XLA forms
    i * (lambda_max * (1 / (n - 1))), the last point lambda_max): the RSR
    is a point of this grid."""
    i = np.arange(n_lambda - 1, dtype=np.float64)
    grid = np.append(i * (lambda_max * (1.0 / (n_lambda - 1))), lambda_max)
    return torch.as_tensor(grid, dtype=dtype, device=device)


def _check_pushover(lambda_max, n_lambda, residual) -> None:
    if lambda_max <= 0 or n_lambda < 2:
        raise ValueError("pushover needs lambda_max > 0 and n_lambda >= 2 "
                         f"(got {lambda_max}, {n_lambda})")
    if not 0.0 < residual <= 1.0:
        raise ValueError(f"residual must be in (0, 1] (got {residual})")


def _results(lambdas, curve, cap_c, F_perm, F_env, collapse_ratio,
             dtype) -> PushoverResults:
    conv, disp, n_yield, util, axial = curve
    first_yield, rsr = _rsr_from_curve(
        lambdas.cpu().numpy(), conv.cpu().numpy(), disp.cpu().numpy(),
        n_yield.cpu().numpy(), collapse_ratio)
    return PushoverResults(
        lambdas=lambdas, converged=conv, max_displacement_mm=disp,
        n_yielded=n_yield, max_util=util, axial_N=axial, capacity_N=cap_c,
        first_yield_lambda=torch.as_tensor(first_yield, dtype=dtype,
                                           device=lambdas.device),
        rsr=torch.as_tensor(float(rsr), dtype=dtype, device=lambdas.device),
        F_perm=F_perm,
        F_env=F_env)


def pushover(model, wave, case, lambda_max: float = 4.0, n_lambda: int = 33,
             n_iter: int = 100, k_factor: float = 1.0,
             residual: float = 1.0, n_gauss: int = 15,
             accel: str = "analytic", support_stiffness=None,
             collapse_ratio: float = 20.0,
             tol: float = 1e-2) -> PushoverResults:
    """Pushover of gravity + lambda * environment with EPP axial yield,
    every lambda of the grid in one batched secant iteration on the
    model's device.

    ``residual``: capacity a member keeps after reaching it (1.0 =
    elastic-perfectly-plastic; < 1 approximates post-buckling loss);
    ``support_stiffness``: foundation springs (``analyze_ssi``'s); ``tol``:
    the allowed relative capacity violation at convergence;
    ``collapse_ratio``: the practical-collapse tangent ratio.  Returns the
    curve and the RSR."""
    _check_pushover(lambda_max, n_lambda, residual)
    from ..api import _full_f32_matmul
    with _full_f32_matmul():
        curves, cap_c = _make_curves_fn(model, case, n_iter, k_factor,
                                        residual, tol, support_stiffness)
        F_perm, F_env = _split_loads(model, wave, case, n_gauss, accel)
        lambdas = _lambda_grid(lambda_max, n_lambda, model.dtype,
                               model.device)
        curve = curves(F_perm, F_env, lambdas)
    return _results(lambdas, curve, cap_c, F_perm, F_env, collapse_ratio,
                    model.dtype)


def _rsr_from_curve(lam_np, conv_np, disp_np, ny_np, collapse_ratio):
    """(first_yield, rsr) from one pushover curve (host numpy): practical
    collapse is the first interval whose tangent d(disp)/d(lambda)
    exceeds collapse_ratio x the elastic slope, or the first
    non-converged or non-finite state."""
    yielded = ny_np > 0
    first_yield = lam_np[yielded][0] if yielded.any() else np.inf
    slopes = np.diff(disp_np) / np.maximum(np.diff(lam_np), 1e-12)
    s_el = slopes[0] if len(slopes) and slopes[0] > 0 else np.inf
    rsr = lam_np[-1]
    for i in range(len(lam_np)):
        if not conv_np[i] or not np.isfinite(disp_np[i]):
            rsr = lam_np[max(i - 1, 0)]
            break
        if i < len(slopes) and np.isfinite(s_el) \
                and slopes[i] > collapse_ratio * s_el:
            rsr = lam_np[i]
            break
    return first_yield, rsr


def pushover_rose(model, wave, case, headings_deg, mesh=None, **kw):
    """Directional pushover: the RSR for every storm heading (wave and
    current rotate together, their relative angle kept); the design
    reserve is the minimum over headings.

    Every heading's lambda grid runs as one batched secant iteration of
    [headings x lambdas] states.  ``mesh=None``: returns ``(headings_deg,
    rsr[n], first_yield[n], results)`` with ``results`` the per-heading
    :class:`PushoverResults` list, as the JAX module's host loop.  ``mesh``
    (a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh`; every rank
    makes the same call): the heading axis is split into equal contiguous
    rank blocks, each rank runs its block and the curves are gathered in
    rank order (``parallel.comm.all_gather_cat``), so ``results`` is the
    stacked ``(converged, max_displacement_mm, n_yielded, max_util,
    axial_N)`` [n_headings, n_lambda, ...], as the JAX module's sharded
    path returns; a heading count the mesh does not divide raises
    ``ValueError``, as the JAX package's placement does.  Other keywords
    are :func:`pushover`'s.
    """
    headings = np.asarray(headings_deg, dtype=np.float64)
    rel = case.current_dir_deg - case.wave_dir_deg
    opts = dict(lambda_max=4.0, n_lambda=33, n_iter=100, k_factor=1.0,
                residual=1.0, n_gauss=15, accel="analytic",
                support_stiffness=None, collapse_ratio=20.0, tol=1e-2)
    unknown = set(kw) - set(opts)
    if unknown:
        raise TypeError(f"unknown pushover_rose options {sorted(unknown)}")
    opts.update(kw)
    _check_pushover(opts["lambda_max"], opts["n_lambda"], opts["residual"])
    H = len(headings)
    mine = slice(0, H)
    if mesh is not None:
        from ..api import _mesh_cases
        mine, sizes = _mesh_cases(mesh, H, "pushover_rose headings")
    from ..api import _full_f32_matmul
    dtype, device = model.dtype, model.device
    with _full_f32_matmul():
        curves, cap_c = _make_curves_fn(
            model, case, opts["n_iter"], opts["k_factor"], opts["residual"],
            opts["tol"], opts["support_stiffness"])
        loads = [_split_loads(model, wave, dataclasses.replace(
            case, wave_dir_deg=float(h), current_dir_deg=float(h) + rel),
            opts["n_gauss"], opts["accel"]) for h in headings[mine]]
        lambdas = _lambda_grid(opts["lambda_max"], opts["n_lambda"], dtype,
                               device)
        # states heading-major: [headings of this rank x lambdas]
        n_l, h_mine = lambdas.shape[0], len(loads)
        F_env = torch.stack([f[1] for f in loads]).repeat_interleave(n_l, 0)
        curve = curves(loads[0][0], F_env, lambdas.repeat(h_mine))
        curve = tuple(c.reshape(h_mine, n_l, *c.shape[1:]) for c in curve)
    if mesh is not None:
        from ..parallel import comm
        curve = tuple(comm.all_gather_cat(c, mesh, sizes) for c in curve)
    per = [_results(lambdas, tuple(c[i] for c in curve), cap_c,
                    *(loads[i] if mesh is None else (None, None)),
                    opts["collapse_ratio"], dtype) for i in range(H)]
    rsr = np.array([float(r.rsr) for r in per])
    fy = np.array([float(r.first_yield_lambda) for r in per])
    return headings, rsr, fy, (per if mesh is None else curve)
