"""Seismic response-spectrum analysis: modal superposition with CQC
(PyTorch counterpart of ``small_fem_solver_tpu/ops/seismic.py``).

1. real modes of the (spring-supported, added-mass) structure, through
   the dynamics paths' :func:`.dynamics._build_km` / :func:`.dynamics.
   _modal_from_ff` (mass-orthonormal shapes: every modal mass is 1 t), or
   the Craig-Bampton reduction for chain-refined meshes;
2. an elastic design acceleration spectrum: the Eurocode 8 Type-1 shape
   with ground classes A-E (damping correction eta = sqrt(10 / (5 + xi%))
   >= 0.55), its vertical form, or a site (T, Sa) table;
3. peak modal responses q_i = Gamma_i Sa(T_i) / omega_i^2 per excitation
   direction, Gamma_i = phi_i^T M r;
4. CQC (Der Kiureghian, equal damping) or SRSS over the modes, applied to
   displacements, member end forces and base shear;
5. SRSS or the 100/40/40 rule over the directions.

The JAX module's ``vmap`` over modes and directions are leading tensor
axes here: member end forces of every mode in one batched recovery
[n_modes, M, 6], and every direction's combination in one contraction.
K in N/mm and M in tonnes give omega^2 in 1/s^2; spectral accelerations
go from m/s^2 to mm/s^2 so that modal displacements are in mm.  The
eigensolve runs on the model's device in its dtype (the JAX module sends
float64 eigensolves to the host CPU; ``torch.linalg.eigh`` runs on the
card).

Mode shapes are defined up to sign, and inside a degenerate eigenspace
(the 3-leg jacket's bending pairs) up to a rotation that differs between
eigensolvers: CQC is invariant to that choice (rho = 1 for equal
frequencies); SRSS and 100/40/40 of member forces are not.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .assembly import element_dof_indices
from .beams import internal_forces
from .interp import interp
from .sections import von_mises_8pt

# Eurocode 8 Type-1 horizontal elastic spectrum parameters per ground
# class: (S, T_B, T_C, T_D) [s].
_EC8_TYPE1 = {
    "A": (1.00, 0.15, 0.4, 2.0),
    "B": (1.20, 0.15, 0.5, 2.0),
    "C": (1.15, 0.20, 0.6, 2.0),
    "D": (1.35, 0.20, 0.8, 2.0),
    "E": (1.40, 0.15, 0.5, 2.0),
}
# EC8 vertical elastic spectrum: avg/ag ratio and corner periods
# (Type 1), ground-class independent.
_EC8_VERTICAL = (0.90, 0.05, 0.15, 1.0)

_G = 9.80665  # m/s^2 per g


def ec8_spectrum(T, pga_g: float, ground: str = "A", zeta: float = 0.05,
                 vertical: bool = False) -> torch.Tensor:
    """Elastic design acceleration spectrum Sa(T) [m/s^2], EC8 Type-1 shape.

    ``T``: periods [s] (a tensor keeps its dtype and device; anything else
    becomes a float64 CPU tensor).  ``pga_g``: design peak ground
    acceleration on rock in g; ``ground`` picks S and the corner periods;
    ``zeta``: damping ratio of eta = sqrt(10 / (5 + 100 zeta)) >= 0.55;
    ``vertical=True``: the vertical spectrum (a_vg = 0.9 a_g, S = 1).
    """
    if ground not in _EC8_TYPE1:
        raise ValueError(f"ground must be one of {sorted(_EC8_TYPE1)} "
                         f"(got {ground!r})")
    if pga_g < 0 or zeta <= 0:
        raise ValueError("ec8_spectrum needs pga_g >= 0 and zeta > 0 "
                         f"(got pga_g={pga_g}, zeta={zeta})")
    if vertical:
        ratio, T_B, T_C, T_D = _EC8_VERTICAL
        S = 1.0
        ag = ratio * pga_g * _G
    else:
        S, T_B, T_C, T_D = _EC8_TYPE1[ground]
        ag = pga_g * _G
    eta = max(np.sqrt(10.0 / (5.0 + 100.0 * zeta)), 0.55)
    T = torch.as_tensor(T, dtype=None if torch.is_tensor(T)
                        else torch.float64)
    plateau = 2.5 * eta
    Tc = torch.clamp(T, min=1e-9)
    Sa = torch.where(
        T <= T_B, 1.0 + T / T_B * (plateau - 1.0),
        torch.where(T <= T_C, torch.full_like(T, plateau),
                    torch.where(T <= T_D, plateau * T_C / Tc,
                                plateau * T_C * T_D / Tc ** 2)))
    return ag * S * Sa


def table_spectrum(T, T_table, Sa_table) -> torch.Tensor:
    """Site-specific spectrum: linear interpolation of a (T, Sa) table
    [s, m/s^2], clamped at the table ends."""
    T = torch.as_tensor(T, dtype=None if torch.is_tensor(T)
                        else torch.float64)
    return interp(T, np.asarray(T_table, np.float64),
                  np.asarray(Sa_table, np.float64))


def cqc_correlation(omega: torch.Tensor, zeta: float) -> torch.Tensor:
    """Der Kiureghian CQC correlation matrix rho_ij for equal damping:
    8 zeta^2 (1 + b) b^1.5 / ((1 - b^2)^2 + 4 zeta^2 b (1 + b)^2), b =
    omega_i / omega_j; zero-frequency modes get the identity row."""
    w = omega
    safe = torch.where(w > 0, w, torch.ones_like(w))
    b = safe[:, None] / safe[None, :]
    num = 8.0 * zeta**2 * (1.0 + b) * b**1.5
    den = (1.0 - b**2) ** 2 + 4.0 * zeta**2 * b * (1.0 + b) ** 2
    live = w > 0
    eye = torch.eye(w.shape[0], dtype=w.dtype, device=w.device)
    return torch.where(live[:, None] & live[None, :], num / den, eye)


class SpectrumResults(NamedTuple):
    """Peak (unsigned) seismic demands from the response-spectrum run."""

    periods_s: torch.Tensor        # [n_modes]
    frequencies_hz: torch.Tensor   # [n_modes]
    Sa_ms2: torch.Tensor           # [n_dirs, n_modes] spectral accel (m/s^2)
    participation: torch.Tensor    # [n_dirs, n_modes] Gamma_i (sqrt(t))
    effective_mass_t: torch.Tensor  # [n_dirs, n_modes] Gamma_i^2 [t]
    total_mass_t: torch.Tensor     # structural + topside mass [t]
    U_peak: torch.Tensor           # [n_dof] combined peak displacement (mm)
    F1_local: torch.Tensor         # [M, 6] combined peak member end forces
    F2_local: torch.Tensor         # [M, 6] (N, N*mm; unsigned)
    von_mises: torch.Tensor        # [M] peak-estimate von Mises (MPa)
    utilization: torch.Tensor      # [M] von_mises / fy
    base_shear_kN: torch.Tensor    # [n_dirs] per-direction base shear
    max_displacement_mm: torch.Tensor
    directions: np.ndarray         # [n_dirs, 3] unit excitation vectors
    mode_shapes: torch.Tensor      # [n_modes, n_dof] mass-orthonormal


def _check_rules(combination: str, dir_rule: str) -> None:
    if combination not in ("cqc", "srss"):
        raise ValueError("combination must be 'cqc' or 'srss' "
                         f"(got {combination!r})")
    if dir_rule not in ("srss", "100-40-40"):
        raise ValueError("dir_rule must be 'srss' or '100-40-40' "
                         f"(got {dir_rule!r})")


def _unit_directions(directions) -> np.ndarray:
    dirs = np.asarray(directions, dtype=np.float64)
    return dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)


def _translation_influence(dirs: np.ndarray, n: int, n_nodes: int,
                           ref: torch.Tensor) -> torch.Tensor:
    """[n_dirs, n] influence vectors of rigid ground translations: the
    direction cosines on the translation DOFs of the first ``n_nodes``
    nodes (every node, fixed supports included, as the consistent-mass
    coupling block needs), 0 elsewhere."""
    r = ref.new_zeros(dirs.shape[0], n)
    for c in range(3):
        r[:, c:6 * n_nodes:6] = torch.as_tensor(
            dirs[:, c], dtype=ref.dtype, device=ref.device)[:, None]
    return r


def response_spectrum(model, pga_g: float, ground: str = "A",
                      zeta: float = 0.05, n_modes: int = 10,
                      E: float = 210000.0, nu: float = 0.3,
                      fy: float = 355.0,
                      topside_mass_t: float = 0.0,
                      support_stiffness=None,
                      added_mass_Ca=None, rho_water: float = 1025.0,
                      directions: Sequence[Sequence[float]] = ((1.0, 0.0, 0.0),
                                                               (0.0, 1.0, 0.0)),
                      spectrum=None,
                      vertical_spectrum: bool = True,
                      combination: str = "cqc",
                      dir_rule: str = "srss") -> SpectrumResults:
    """Response-spectrum earthquake analysis of a jacket model (dense, on
    the model's device in its dtype).

    ``directions``: excitation unit vectors (a vertical one uses the EC8
    vertical spectrum when ``vertical_spectrum``); ``spectrum``: a site
    ``(T_table, Sa_table)`` for every direction instead; ``combination``
    'cqc' or 'srss' over modes; ``dir_rule`` 'srss' or '100-40-40' over
    directions; topside mass, foundation springs and added mass as
    :func:`.dynamics.modal_analysis`.  Returns unsigned peak demands; von
    Mises and utilization evaluate the stress formula on the combined
    peak end forces.
    """
    _check_rules(combination, dir_rule)
    from ..api import _full_f32_matmul
    from .dynamics import _build_km, _modal_from_ff
    from .solve import ground_with_springs

    dtype = model.dtype
    dirs = _unit_directions(directions)
    with _full_f32_matmul():
        K, M, free, (K_local, T_rot, L_m) = _build_km(
            model, E, nu, topside_mass_t, added_mass_Ca, rho_water)
        if support_stiffness is not None:
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        K_ff = K[free][:, free]
        n_modes = min(n_modes, K_ff.shape[0])
        omega, shapes = _modal_from_ff(K_ff, M[free][:, free], free,
                                       model.n_dof, n_modes, dtype)
        gamma = (shapes @ M) @ _translation_influence(
            dirs, model.n_dof, model.n_nodes, shapes).mT   # [n_modes, n_d]
        core = _spectrum_core(
            model.conn, model.sections, model.sect_id, omega, shapes,
            gamma.mT, K_local, T_rot, pga_g, ground, zeta, dirs, spectrum,
            vertical_spectrum, combination, dir_rule, fy, dtype)
    mass_per_m = model.sections.mass_per_m[model.sect_id]
    total_mass = torch.sum(mass_per_m * L_m) / 1000.0 + topside_mass_t
    return core._replace(total_mass_t=total_mass)


def _spectrum_core(conn, sections, sect_id, omega, shapes, gamma,
                   K_local, T_rot, pga_g, ground, zeta, dirs, spectrum,
                   vertical_spectrum, combination, dir_rule, fy,
                   dtype) -> SpectrumResults:
    """Shared spectrum and combination pipeline of the dense and condensed
    paths: Sa per direction and mode, modal peaks, member end forces of
    every mode, CQC / SRSS over modes, the direction rule, stresses and
    base shear.  ``shapes`` [n_modes, n_dof] are mass-orthonormal over
    the DOF layout ``conn`` indexes; ``gamma`` is [n_dirs, n_modes];
    ``total_mass_t`` is left 0 for the caller."""
    live = omega > 0
    periods = torch.where(live, 2.0 * math.pi / torch.clamp(omega,
                                                              min=1e-30),
                          torch.full_like(omega, math.inf))
    rows = []
    for d in range(dirs.shape[0]):
        if spectrum is not None:
            Sa_d = table_spectrum(periods, spectrum[0], spectrum[1])
        else:
            Sa_d = ec8_spectrum(periods, pga_g, ground, zeta,
                                vertical=bool(vertical_spectrum
                                              and abs(dirs[d, 2]) > 0.99))
        rows.append(torch.where(live, Sa_d, 0.0))
    Sa = torch.stack(rows)                                # [n_dirs, n_modes]

    w2_safe = torch.where(live, omega, torch.ones_like(omega)) ** 2
    q = torch.where(live, gamma * (Sa * 1e3) / w2_safe, 0.0)
    rho = (cqc_correlation(omega, zeta) if combination == "cqc"
           else torch.eye(omega.shape[0], dtype=dtype, device=omega.device))

    # every mode's member end forces in one batched recovery
    F1_m, F2_m = internal_forces(K_local, T_rot,
                                 shapes[:, element_dof_indices(conn)])
    # every direction at once: the direction axis leads, the mode axis next
    U_d = _combine(rho, q[:, :, None] * shapes)
    F1_d = _combine(rho, q[:, :, None, None] * F1_m)
    F2_d = _combine(rho, q[:, :, None, None] * F2_m)

    if dir_rule == "srss":
        U_peak, F1, F2 = (torch.sqrt(torch.sum(x**2, dim=0))
                          for x in (U_d, F1_d, F2_d))
    else:  # 100/40/40 on unsigned peaks: max over which axis is at 100%
        n_d = dirs.shape[0]
        w = 0.4 + 0.6 * torch.eye(n_d, dtype=dtype, device=omega.device)
        U_peak = torch.max(w @ U_d.reshape(n_d, -1), dim=0).values
        F1, F2 = (torch.max(torch.einsum("kd,dmc->kmc", w, x), dim=0).values
                  for x in (F1_d, F2_d))

    vm = von_mises_8pt(sections, sect_id, *(F1[:, c] for c in range(6)))
    # per-direction base shear: modal V_i = Gamma_i^2 Sa_i [t m/s^2 = kN]
    V = _combine(rho, gamma**2 * Sa)
    disp = torch.linalg.norm(U_peak.reshape(-1, 6)[:, :3], dim=-1)
    return SpectrumResults(
        periods_s=periods,
        frequencies_hz=torch.where(live, omega / (2.0 * math.pi), 0.0),
        Sa_ms2=Sa, participation=gamma, effective_mass_t=gamma**2,
        total_mass_t=torch.zeros((), dtype=dtype, device=omega.device),
        U_peak=U_peak, F1_local=F1, F2_local=F2, von_mises=vm,
        utilization=vm / fy, base_shear_kN=V,
        max_displacement_mm=torch.max(disp), directions=dirs,
        mode_shapes=shapes)


def _combine(rho: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Peak of each direction's response from its per-mode values ``r``
    [n_dirs, n_modes, ...] under the modal correlation ``rho``:
    sqrt(sum_ij rho_ij r_i r_j), elementwise over the trailing axes."""
    quad = torch.einsum("ij,di...,dj...->d...", rho, r, r)
    return torch.sqrt(torch.clamp(quad, min=0.0))


def response_spectrum_condensed(coarse, refined, n_seg: int, pga_g: float,
                                ground: str = "A", zeta: float = 0.05,
                                n_modes: int = 10,
                                E: float = 210000.0, nu: float = 0.3,
                                fy: float = 355.0,
                                topside_mass_t: float = 0.0,
                                n_chain_modes: int = 12,
                                support_stiffness=None,
                                added_mass_Ca=None,
                                rho_water: float = 1025.0,
                                directions: Sequence[Sequence[float]] = (
                                    (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
                                spectrum=None,
                                vertical_spectrum: bool = True,
                                combination: str = "cqc",
                                dir_rule: str = "srss") -> SpectrumResults:
    """Response-spectrum analysis of a chain-refined mesh through the
    Craig-Bampton reduction (:func:`.dynamics.modal_analysis_condensed`;
    on the card its chain-mode iteration is 10 chain-sweep launches).

    The eigenproblem and the participation run on the reduced basis (a
    rigid ground translation lies in it exactly: all interface
    translations set, fixed supports included, and zero generalized
    coordinates); member demands are recovered on the full refined mesh
    through the expansion v = Psi u_b + Phi q.  Options as
    :func:`response_spectrum`.
    """
    _check_rules(combination, dir_rule)
    from ..api import _full_f32_matmul
    from .dynamics import _cb_expand, _cb_reduce, _modal_from_ff, _reduced_ff

    dtype = refined.dtype
    dirs = _unit_directions(directions)
    cb = _cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                    n_chain_modes, support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca, rho_water=rho_water)
    with _full_f32_matmul():
        K_ff, M_ff = _reduced_ff(cb)
        n_modes = min(n_modes, K_ff.shape[0])
        omega, shapes_r = _modal_from_ff(K_ff, M_ff, cb.free, cb.n_red,
                                         n_modes, dtype)
        gamma = (shapes_r @ cb.M_red) @ _translation_influence(
            dirs, cb.n_red, cb.nc, shapes_r).mT
        shapes = _cb_expand(cb, shapes_r)       # [n_modes, n_dof_refined]
        core = _spectrum_core(
            refined.conn, refined.sections, refined.sect_id, omega, shapes,
            gamma.mT, cb.K_local, cb.T, pga_g, ground, zeta, dirs, spectrum,
            vertical_spectrum, combination, dir_rule, fy, dtype)
    mass_per_m = refined.sections.mass_per_m[refined.sect_id]
    total_mass = torch.sum(mass_per_m * cb.L_m) / 1000.0 + topside_mass_t
    return core._replace(total_mass_t=total_mass)
