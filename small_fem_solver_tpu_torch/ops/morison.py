"""Morison-equation member loading (PyTorch counterpart of
``small_fem_solver_tpu/ops/morison.py``), in two forms:

- :func:`morison_loads` (and the phase scan :func:`phase_scan` over it)
  evaluates the wave kinematics pointwise at every Gauss point with the
  reference's exact semantics (``ops/waves.py::kinematics``: finite-
  difference or analytic acceleration, the evaluation-height clamp,
  Wheeler stretching) and carries the optional slamming term; a batch of
  times rides one evaluation, in chunks of phases;
  :func:`morison_pointwise_end_forces` is the same evaluation stopped at
  the member end forces (what the condensed scans read), the plain
  version of the pointwise CUDA kernel in ``ops/hopper_kernels.py``;
- :func:`morison_phase_batch` evaluates all phases through the separable
  harmonic contraction: with theta = k x - omega t every Fourier harmonic
  factorizes, cos(j theta) = cos(jkx) cos(jwt) + sin(jkx) sin(jwt), so the
  kinematics of all phases are one ``[S, N] x [N, P]`` contraction over
  the quadrature points (analytic acceleration, no evaluation-height
  clamp).  It is the plain PyTorch version of the fused CUDA kernel in
  ``ops/hopper_kernels.py``: the tests hold the port against the JAX
  package through it, and ``chip_smoke.py`` holds the kernel against it.

Semantics: compass-to-math heading theta = deg2rad(90 - dir); current split
onto its own heading; n-point Gauss-Legendre on [0, 1]; normal
decomposition; drag 0.5 rho Cd D |u_n| u_n L w gated at |u_n| > 1e-10,
inertia rho Cm (pi D^2 / 4) a_n L w; dry points (z > eta) carry nothing;
lever-rule end split F1 += (1 - s) f, F2 += s f.  Forces in N.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .assembly import node_gather_table, node_sum_ordered
from .waves import FourierWave, kinematics, surface_velocity

# Largest phases x points x modes intermediate of one pointwise evaluation
# (2^24 elements, 134 MB in float64); longer phase batches run in chunks.
POINTWISE_CHUNK_ELEMS = 1 << 24


def _as(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (number or tensor) as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def hydro_diameter_m(sections, sect_id, marine_growth_mm=0.0):
    """Effective hydrodynamic member diameter [m]: outer D plus twice the
    marine-growth thickness."""
    return (sections.D_outer[sect_id] + 2.0 * marine_growth_mm) / 1000.0


def hydro_members(model, marine_growth_mm, Cd, Cm):
    """Hydrodynamic segment set ``(conn_h, D_m_h, Cd_h, Cm_h)`` of a model.

    The structural members, then the model's appurtenances (hydro-only
    segments, :func:`..models.model.add_appurtenances`) with their own
    diameters, and their Cd/Cm multipliers folded into per-member [M + A]
    coefficients.  Marine growth widens appurtenances like members.  With
    no appurtenances the scalar ``Cd``/``Cm`` pass through unchanged.
    """
    D_m = hydro_diameter_m(model.sections, model.sect_id, marine_growth_mm)
    if model.n_appurtenances == 0:
        return model.conn, D_m, Cd, Cm
    D_app = (model.app_D_mm.to(D_m.dtype) + 2.0 * marine_growth_mm) / 1000.0
    ones = torch.ones(model.n_members, dtype=D_m.dtype, device=D_m.device)

    def per_member(coef, mult):
        return _as(coef, D_m) * torch.cat([ones, mult.to(D_m.dtype)])
    return (torch.cat([model.conn, model.app_conn]), torch.cat([D_m, D_app]),
            per_member(Cd, model.app_cd_mult),
            per_member(Cm, model.app_cm_mult))


def gauss_legendre_01(n: int, dtype=np.float64):
    """Nodes and weights of n-point Gauss-Legendre on [0, 1] (host
    constants): s = (xi + 1) / 2, w = weight / 2."""
    xi, wt = np.polynomial.legendre.leggauss(n)
    return (xi.astype(dtype) + 1.0) / 2.0, wt.astype(dtype) / 2.0


class MorisonLoads(NamedTuple):
    """One pointwise Morison evaluation (units: N, m).  With a batch of
    times every field has a leading phase axis."""

    nodal_forces: torch.Tensor     # [n_nodes, 3]
    total_drag: torch.Tensor       # [3]
    total_inertia: torch.Tensor    # [3]
    total_morison: torch.Tensor    # [3]
    member_drag: torch.Tensor      # [M, 3]
    member_inertia: torch.Tensor   # [M, 3]
    member_submerged_length: torch.Tensor  # [M]


def morison_loads(wave: FourierWave, coords: torch.Tensor,
                  conn: torch.Tensor, D_m: torch.Tensor, wave_dir_deg,
                  current_dir_deg, Cd, Cm, rho_water, t, n_gauss: int = 15,
                  accel: str = "fd", stretching: str = "none",
                  current_alpha=None, slam_cs: float = 0.0) -> MorisonLoads:
    """Morison drag + inertia loads of all members at time ``t`` (a number,
    a 0-d tensor, or ``[S]`` times: then every result gets a leading phase
    axis), in ``coords``' dtype on its device.

    ``D_m``: [M] hydrodynamic diameters in metres; ``Cd``/``Cm`` scalars or
    per-member [M]; ``stretching='wheeler'`` evaluates the kinematics at
    Wheeler-stretched heights; ``current_alpha`` gives the power-law
    current profile U_c ((z + d) / d)^alpha.

    ``slam_cs`` > 0 adds a quasi-static slamming line load on splash-zone
    members (DNV-RP-C205 8.6 form): f_s = 0.5 rho Cs D v_n^2 per unit
    length, v_n the surface rise velocity d(eta)/dt projected normal to
    the member axis, active only where the surface lies within D/2 of the
    point and is rising; it is folded into the drag of the breakdown.
    """
    wave = wave.to(coords.dtype, coords.device)
    t = _as(t, coords)
    if t.ndim > 1:
        raise ValueError(f"t must be a time or a 1-D tensor of times, got "
                         f"shape {tuple(t.shape)}")
    table = node_gather_table(torch.cat([conn[:, 0], conn[:, 1]]),
                              coords.shape[0])
    args = (wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
            rho_water)
    opts = (n_gauss, accel, stretching, current_alpha, slam_cs, table)
    per_phase = conn.shape[0] * n_gauss * wave.n_modes
    if t.ndim == 1 and t.shape[0] * per_phase > POINTWISE_CHUNK_ELEMS:
        parts = [_morison_loads(*args, tc, *opts) for tc in
                 t.split(max(1, POINTWISE_CHUNK_ELEMS // per_phase))]
        return MorisonLoads(*(torch.cat(f) for f in zip(*parts)))
    return _morison_loads(*args, t, *opts)


def _morison_loads(wave, coords, conn, D_m, wave_dir_deg, current_dir_deg,
                   Cd, Cm, rho_water, t, n_gauss, accel, stretching,
                   current_alpha, slam_cs, table) -> MorisonLoads:
    """:func:`morison_loads` of one time or one chunk of times, the nodal
    sums in ``table``'s order."""
    f, F_drag, F_inertia, s, Lw, subf = _point_forces(
        wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
        rho_water, t, n_gauss, accel, stretching, current_alpha, slam_cs)
    F1, F2 = _lever_split(f, s)
    member_drag = torch.sum(F_drag, dim=-2)
    member_inertia = torch.sum(F_inertia, dim=-2)
    nodal = node_sum_ordered(torch.cat([F1, F2], dim=-2), table)
    total_drag = torch.sum(member_drag, dim=-2)
    total_inertia = torch.sum(member_inertia, dim=-2)
    return MorisonLoads(
        nodal_forces=nodal, total_drag=total_drag,
        total_inertia=total_inertia,
        total_morison=total_drag + total_inertia,
        member_drag=member_drag, member_inertia=member_inertia,
        member_submerged_length=torch.sum(Lw * subf, dim=-1))


def _lever_split(f, s):
    """Lever-rule end split of point forces [..., M, Q, 3]: (F1, F2)
    [..., M, 3], F1 = sum (1 - s) f, F2 = sum s f."""
    return (torch.sum((1.0 - s)[:, None] * f, dim=-2),
            torch.sum(s[:, None] * f, dim=-2))


def _point_forces(wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd,
                  Cm, rho_water, t, n_gauss, accel, stretching, current_alpha,
                  slam_cs):
    """The pointwise Morison forces of one time or one chunk of times at
    every Gauss point: (f, F_drag, F_inertia) [..., M, Q, 3] (the slam
    term folded into f and F_drag), the abscissae s [Q], the weights L w
    [M, Q] and the submergence [..., M, Q] in ``coords``' dtype."""
    dtype = coords.dtype
    theta_w = torch.deg2rad(_as(90.0 - wave_dir_deg, coords))
    theta_c = torch.deg2rad(_as(90.0 - current_dir_deg, coords))
    cos_w, sin_w = torch.cos(theta_w), torch.sin(theta_w)
    cos_c, sin_c = torch.cos(theta_c), torch.sin(theta_c)

    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=-1)                      # [M]
    e = dL / L[:, None]
    s_np, w_np = gauss_legendre_01(n_gauss)
    s, w = _as(s_np, coords), _as(w_np, coords)
    pos = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [M, Q, 3]
    x, y, z = pos[..., 0], pos[..., 1], pos[..., 2]

    # 2D kinematics sampled along the wave heading, at [S, M, Q] or [M, Q]
    x_wave = x * cos_w + y * sin_w
    tb = t[..., None, None]
    kin = kinematics(wave, x_wave, z, tb, accel=accel, stretching=stretching)
    sub = kin.submerged
    subf = sub.to(dtype)

    # wave and current onto their own headings; the current is uniform or
    # a power-law profile of the height above the bed
    if current_alpha is None:
        Uc_pt = wave.U_c
    else:
        frac = torch.clip((z + wave.d) / wave.d, 0.0, 1.0)
        Uc_pt = wave.U_c * frac ** _as(current_alpha, coords)
    u_wave_only = kin.u - wave.U_c * subf
    U = torch.stack([u_wave_only * cos_w + Uc_pt * subf * cos_c,
                     u_wave_only * sin_w + Uc_pt * subf * sin_c,
                     kin.w], dim=-1)                        # [..., M, Q, 3]
    A = torch.stack([kin.du_dt * cos_w, kin.du_dt * sin_w, kin.dw_dt],
                    dim=-1)

    eb = e[:, None, :]
    U_perp = U - torch.sum(U * eb, dim=-1, keepdim=True) * eb
    A_perp = A - torch.sum(A * eb, dim=-1, keepdim=True) * eb
    # grad-safe norm: U_perp is exactly zero at dry points
    U_sq = torch.sum(U_perp * U_perp, dim=-1)
    U_mag = torch.where(U_sq > 0,
                        torch.sqrt(torch.where(U_sq > 0, U_sq, 1.0)), 0.0)

    D = D_m[:, None]
    Lw = L[:, None] * w[None, :]                           # [M, Q]
    A_cross = math.pi * D**2 / 4.0
    Cd, Cm = _as(Cd, coords), _as(Cm, coords)
    Cd = Cd[:, None] if Cd.ndim == 1 else Cd
    Cm = Cm[:, None] if Cm.ndim == 1 else Cm
    rho = _as(rho_water, coords)

    drag_on = torch.logical_and(sub, U_mag > 1e-10).to(dtype)
    F_drag = ((0.5 * rho * Cd * D * U_mag * Lw)[..., None] * U_perp
              * drag_on[..., None])
    F_inertia = ((rho * Cm * A_cross * Lw)[..., None] * A_perp
                 * subf[..., None])
    f = F_drag + F_inertia

    if slam_cs:
        eta_dot = surface_velocity(wave, x_wave, tb)
        crossing = torch.abs(z - kin.eta) <= D / 2.0
        vs = torch.where(torch.logical_and(crossing, eta_dot > 0.0),
                         eta_dot, 0.0)
        # normal part of the vertical: z_perp = zhat - e_z e, |z_perp| =
        # sqrt(1 - e_z^2); the load 0.5 rho Cs D eta_dot^2 |z_perp| z_perp
        ez = e[:, 2]
        zp_sq = torch.clamp(1.0 - ez * ez, min=0.0)        # [M]
        zp_mag = torch.where(zp_sq > 0,
                             torch.sqrt(torch.where(zp_sq > 0, zp_sq, 1.0)),
                             0.0)
        z_perp = torch.stack([-ez * e[:, 0], -ez * e[:, 1], zp_sq], dim=-1)
        slam_fac = (0.5 * rho * slam_cs * D * vs**2 * Lw
                    * zp_mag[:, None])                     # [..., M, Q]
        F_slam = slam_fac[..., None] * z_perp[:, None, :]
        F_drag = F_drag + F_slam
        f = f + F_slam

    return f, F_drag, F_inertia, s, Lw, subf


def morison_pointwise_end_forces(wave: FourierWave, coords: torch.Tensor,
                                 conn: torch.Tensor, D_m: torch.Tensor,
                                 wave_dir_deg, current_dir_deg, Cd, Cm,
                                 rho_water, ts: torch.Tensor,
                                 n_gauss: int = 15, accel: str = "fd",
                                 stretching: str = "none",
                                 current_alpha=None, slam_cs: float = 0.0):
    """:func:`morison_loads` of the times ``ts`` [S] without the nodal
    sums, for the condensed scans (they read the member end forces in their
    chain layout): (F1 [S, M, 3], F2 [S, M, 3], total_drag [S, 3],
    total_inertia [S, 3]), each equal to what :func:`morison_loads`
    computes on its way to the nodal sums.  The plain version of the
    pointwise Morison kernel (``ops/hopper_kernels.py::
    morison_pointwise_end_forces_cuda``)."""
    wave = wave.to(coords.dtype, coords.device)
    ts = _as(ts, coords)
    if ts.ndim != 1:
        raise ValueError(f"ts must be a 1-D tensor of times, got shape "
                         f"{tuple(ts.shape)}")
    per_phase = conn.shape[0] * n_gauss * wave.n_modes
    parts = []
    for tc in ts.split(max(1, POINTWISE_CHUNK_ELEMS // per_phase)):
        f, F_drag, F_inertia, s, _, _ = _point_forces(
            wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
            rho_water, tc, n_gauss, accel, stretching, current_alpha,
            slam_cs)
        parts.append((*_lever_split(f, s),
                      torch.sum(torch.sum(F_drag, dim=-2), dim=-2),
                      torch.sum(torch.sum(F_inertia, dim=-2), dim=-2)))
    return tuple(torch.cat(x) for x in zip(*parts))


class PhaseScan(NamedTuple):
    """Critical-phase scan of one wave period (leading axis = phase)."""

    t: torch.Tensor            # [S]
    phase_deg: torch.Tensor    # [S]
    total_kN: torch.Tensor     # [S]
    drag_kN: torch.Tensor      # [S]
    inertia_kN: torch.Tensor   # [S]
    F_kN: torch.Tensor         # [S, 3]
    critical_index: torch.Tensor
    nodal_forces: torch.Tensor | None = None   # [S, n_nodes, 3] (optional)


def phase_scan(wave: FourierWave, coords, conn, D_m, wave_dir_deg,
               current_dir_deg, Cd, Cm, rho_water, n_steps: int = 36,
               n_gauss: int = 15, accel: str = "fd",
               keep_nodal: bool = False, slam_cs: float = 0.0) -> PhaseScan:
    """Scan one wave period for the critical phase: the reference's
    sampling t_i = i T / n_steps and its argmax over |total Morison|, all
    phases in one batched :func:`morison_loads`."""
    ts = (torch.arange(n_steps, dtype=coords.dtype, device=coords.device)
          * _as(wave.T, coords) / n_steps)
    r = morison_loads(wave, coords, conn, D_m, wave_dir_deg, current_dir_deg,
                      Cd, Cm, rho_water, ts, n_gauss=n_gauss, accel=accel,
                      slam_cs=slam_cs)
    total_kN = torch.linalg.norm(r.total_morison, dim=-1) / 1000.0
    return PhaseScan(
        t=ts,
        phase_deg=torch.rad2deg(_as(wave.omega, coords) * ts) % 360.0,
        total_kN=total_kN,
        drag_kN=torch.linalg.norm(r.total_drag, dim=-1) / 1000.0,
        inertia_kN=torch.linalg.norm(r.total_inertia, dim=-1) / 1000.0,
        F_kN=r.total_morison / 1000.0,
        critical_index=torch.argmax(total_kN),
        nodal_forces=r.nodal_forces if keep_nodal else None)


class MorisonPhaseBatch(NamedTuple):
    """Per-phase Morison loads (leading axis = phase). Units: N.

    ``F1``/``F2`` are the lever-rule member end forces before the nodal
    scatter; the condensed solver reads them in its chain layout.
    """

    nodal_forces: torch.Tensor    # [S, n_nodes, 3]
    total_drag: torch.Tensor      # [S, 3]
    total_inertia: torch.Tensor   # [S, 3]
    total_morison: torch.Tensor   # [S, 3]
    F1: torch.Tensor              # [S, M, 3] node-1 end forces
    F2: torch.Tensor              # [S, M, 3] node-2 end forces


def nodal_scatter(F1: torch.Tensor, F2: torch.Tensor, conn: torch.Tensor,
                  n_nodes: int) -> torch.Tensor:
    """Member end forces [S, M, 3] summed onto their nodes [S, n_nodes, 3]
    in a fixed order (bit-repeatable on the card)."""
    return node_sum_ordered(torch.cat([F1, F2], dim=1), node_gather_table(
        torch.cat([conn[:, 0], conn[:, 1]]), n_nodes))


def morison_phase_batch(wave: FourierWave, coords: torch.Tensor,
                        conn: torch.Tensor, D_m: torch.Tensor,
                        wave_dir_deg, current_dir_deg, Cd, Cm, rho_water,
                        ts: torch.Tensor, n_gauss: int = 15,
                        current_alpha=None,
                        stretching: str = "none") -> MorisonPhaseBatch:
    """All wave phases' Morison loads via the separable harmonic
    contraction, in ``coords``' dtype on its device.

    ``stretching='wheeler'`` applies the frozen-stretch Wheeler treatment
    as a second-order Taylor expansion of the depth profiles about z
    (d/dz and d^2/dz^2 rows ride the same contraction);
    ``current_alpha`` gives the power-law current profile
    U_c ((z + d) / d)^alpha; ``Cd``/``Cm`` are scalars or per-member [M].
    """
    F1, F2, total_drag, total_inertia = morison_end_forces(
        wave, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
        rho_water, ts, n_gauss, current_alpha, stretching)
    return MorisonPhaseBatch(
        nodal_forces=nodal_scatter(F1, F2, conn, coords.shape[0]),
        total_drag=total_drag, total_inertia=total_inertia,
        total_morison=total_drag + total_inertia, F1=F1, F2=F2)


def morison_end_forces(wave: FourierWave, coords: torch.Tensor,
                       conn: torch.Tensor, D_m: torch.Tensor, wave_dir_deg,
                       current_dir_deg, Cd, Cm, rho_water, ts: torch.Tensor,
                       n_gauss: int = 15, current_alpha=None,
                       stretching: str = "none"):
    """:func:`morison_phase_batch` without the nodal scatter, for the
    condensed paths (they read the member end forces in their chain layout):
    returns (F1 [S, M, 3], F2 [S, M, 3], total_drag [S, 3],
    total_inertia [S, 3])."""
    dtype = coords.dtype
    wave = wave.to(dtype, coords.device)
    j = torch.arange(1, wave.n_modes + 1, dtype=dtype, device=coords.device)
    return _morison_batch_core(
        j * wave.k, j * wave.omega, torch.zeros_like(j), wave.E, wave.U,
        wave.d, wave.U_c, coords, conn, D_m, wave_dir_deg, current_dir_deg,
        Cd, Cm, rho_water, ts, n_gauss, current_alpha, stretching)


def morison_end_forces_batch(waves: FourierWave, coords: torch.Tensor,
                             conn: torch.Tensor, D_m, wave_dir_deg,
                             current_dir_deg, Cd, Cm, rho_water,
                             ts: torch.Tensor, n_gauss: int = 15,
                             current_alpha=None, stretching: str = "none"):
    """:func:`morison_end_forces` of C cases on one model's members, as
    ``torch.func.vmap`` over the cases (in chunks of at most
    ``POINTWISE_CHUNK_ELEMS`` phase x point x mode elements): the plain
    version of the Morison kernel's case-batched float64 instance.

    ``waves``: a batched wave (``waves.stack_waves``; ``E``, ``U`` [C, N],
    scalars [C]); ``ts`` [C, S]; ``D_m``, ``Cd``, ``Cm``: [C, M] per case
    and member, [C, 1] per case, [M] per member, or a scalar;
    ``wave_dir_deg``, ``current_dir_deg``, ``rho_water``,
    ``current_alpha``: [C] per case or a scalar.  Returns (F1, F2 [C, S,
    M, 3], total_drag, total_inertia [C, S, 3])."""
    C, S = ts.shape
    wave_names = [f.name for f in dataclasses.fields(FourierWave)
                  if isinstance(getattr(waves, f.name), torch.Tensor)]
    args = dict(D_m=D_m, Cd=Cd, Cm=Cm, wave_dir_deg=wave_dir_deg,
                current_dir_deg=current_dir_deg, rho_water=rho_water,
                current_alpha=current_alpha)
    batched = {}
    for name, v in args.items():
        if isinstance(v, np.ndarray):
            v = args[name] = _as(v, coords)
        per_case = (isinstance(v, torch.Tensor)
                    and v.ndim == (2 if name in ("D_m", "Cd", "Cm") else 1))
        if per_case:   # [C, 1] is one value a case
            batched[name] = (v[:, 0] if v.ndim == 2 and v.shape[1] == 1
                             else v)
    shared = {n: v for n, v in args.items() if n not in batched}

    def one(wave_fields, ts_c, per_case):
        kw = {**shared, **dict(zip(batched, per_case))}
        wave = dataclasses.replace(waves, **dict(zip(wave_names,
                                                     wave_fields)))
        return morison_end_forces(
            wave, coords, conn, kw["D_m"], kw["wave_dir_deg"],
            kw["current_dir_deg"], kw["Cd"], kw["Cm"], kw["rho_water"], ts_c,
            n_gauss, kw["current_alpha"], stretching)
    per_item = S * conn.shape[0] * n_gauss * waves.n_modes
    step = max(1, POINTWISE_CHUNK_ELEMS // per_item)
    parts = [torch.func.vmap(one)(
        tuple(getattr(waves, n)[lo:lo + step] for n in wave_names),
        ts[lo:lo + step], tuple(v[lo:lo + step] for v in batched.values()))
        for lo in range(0, C, step)]
    return tuple(torch.cat(x) for x in zip(*parts))


class _ModeCoeffs(NamedTuple):
    """Spatial per-mode coefficient matrices + quadrature geometry."""

    Acat: torch.Tensor   # [F, P, N] cos(w t) field rows
    Bcat: torch.Tensor   # [F, P, N] sin(w t) field rows
    #   row order: eta, u_x, u_y, w, du_x, du_y, dw (+ 12 Wheeler rows)
    z: torch.Tensor      # [P] quadrature-point elevations (m)
    e: torch.Tensor      # [M, 3] member unit vectors
    L: torch.Tensor      # [M] member lengths (m)
    s: torch.Tensor      # [Q] Gauss abscissae on [0, 1]
    w: torch.Tensor      # [Q] Gauss weights (sum 1)
    cos_c: torch.Tensor  # current heading factors
    sin_c: torch.Tensor


def _mode_spatial_coeffs(kv, wv, phiv, E, U, d, coords, conn, wave_dir_deg,
                         current_dir_deg, n_gauss: int, stretching: str,
                         rel_dir_deg=None) -> _ModeCoeffs:
    """Per-mode spatial harmonic factors at every Gauss point — the
    phase-independent half of the separable engine.

    ``rel_dir_deg`` ([N] degrees, or ``None``) gives each mode its own
    heading relative to ``wave_dir_deg`` (a short-crested sea): the phases
    use each mode's own projection, and the horizontal velocity and
    acceleration rows carry per-mode direction weights."""
    if rel_dir_deg is None:
        theta_w = torch.deg2rad(_as(90.0 - wave_dir_deg, coords))
    else:
        theta_w = torch.deg2rad(90.0 - (_as(wave_dir_deg, coords)
                                        + _as(rel_dir_deg, coords)))  # [N]
    theta_c = torch.deg2rad(_as(90.0 - current_dir_deg, coords))
    cw, sw = torch.cos(theta_w), torch.sin(theta_w)
    cos_c, sin_c = torch.cos(theta_c), torch.sin(theta_c)

    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=-1)                      # [M]
    e = dL / L[:, None]

    s_np, w_np = gauss_legendre_01(n_gauss)
    s, w = _as(s_np, coords), _as(w_np, coords)
    pos = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [M, Q, 3]
    x, y, z = (pos[..., c].reshape(-1) for c in range(3))      # [P]

    kx = kv * (x[:, None] * cw + y[:, None] * sw) + phiv[None, :]  # [P, N]
    cjx, sjx = torch.cos(kx), torch.sin(kx)
    A = kv * (z[:, None] + d)
    B = kv * d
    Aa = torch.abs(A)
    scale = torch.exp(Aa - B) / (1.0 + torch.exp(-2.0 * B))
    Cj = scale * (1.0 + torch.exp(-2.0 * Aa))
    Sj = torch.sign(A) * scale * (1.0 - torch.exp(-2.0 * Aa))
    jw = wv
    UC, US = U * Cj, U * Sj

    As = [E * cjx, UC * cw * cjx, UC * sw * cjx, US * sjx,
          UC * cw * jw * sjx, UC * sw * jw * sjx, -US * jw * cjx]
    Bs = [E * sjx, UC * cw * sjx, UC * sw * sjx, -US * cjx,
          -UC * cw * jw * cjx, -UC * sw * jw * cjx, -US * jw * sjx]
    if stretching == "wheeler":
        # d/dz and d^2/dz^2 rows (C' = jk S, S' = jk C, C'' = (jk)^2 C,
        # S'' = (jk)^2 S) share the parent fields' time factors
        UZ, WZ = U * kv * Sj, U * kv * Cj
        UZZ, WZZ = U * kv**2 * Cj, U * kv**2 * Sj
        As += [UZ * cw * cjx, UZ * sw * cjx, WZ * sjx,
               UZ * cw * jw * sjx, UZ * sw * jw * sjx, -WZ * jw * cjx,
               UZZ * cw * cjx, UZZ * sw * cjx, WZZ * sjx,
               UZZ * cw * jw * sjx, UZZ * sw * jw * sjx, -WZZ * jw * cjx]
        Bs += [UZ * cw * sjx, UZ * sw * sjx, -WZ * cjx,
               -UZ * cw * jw * cjx, -UZ * sw * jw * cjx, -WZ * jw * sjx,
               UZZ * cw * sjx, UZZ * sw * sjx, -WZZ * cjx,
               -UZZ * cw * jw * cjx, -UZZ * sw * jw * cjx, -WZZ * jw * sjx]
    elif stretching != "none":
        raise ValueError(f"unknown stretching mode {stretching!r}")
    return _ModeCoeffs(Acat=torch.stack(As), Bcat=torch.stack(Bs), z=z, e=e,
                       L=L, s=s, w=w, cos_c=cos_c, sin_c=sin_c)


def _per_member(v, Q: int, ref: torch.Tensor) -> torch.Tensor:
    """Scalar coefficient, or per-member [M] one repeated to [1, P]."""
    v = _as(v, ref)
    return v.repeat_interleave(Q)[None, :] if v.ndim == 1 else v


def _morison_batch_core(kv, wv, phiv, E, U, d, U_c, coords, conn, D_m,
                        wave_dir_deg, current_dir_deg, Cd, Cm, rho_water,
                        ts, n_gauss: int, current_alpha, stretching: str,
                        rel_dir_deg=None):
    """Separable Morison engine over an arbitrary mode set (per-mode [N]
    wavenumbers ``kv``, frequencies ``wv``, phase offsets ``phiv``, surface
    and velocity coefficients ``E``/``U``, optional per-mode headings
    ``rel_dir_deg``): harmonics of one wave or the components of a random
    sea; returns (F1, F2, total_drag, total_inertia)."""
    dtype = coords.dtype
    mc = _mode_spatial_coeffs(kv, wv, phiv, E, U, d, coords, conn,
                              wave_dir_deg, current_dir_deg, n_gauss,
                              stretching, rel_dir_deg)
    z, e, L, s, w = mc.z, mc.e, mc.L, mc.s, mc.w
    M, Q, S = conn.shape[0], n_gauss, ts.shape[0]

    ct = torch.cos(wv * ts[:, None].to(dtype))             # [S, N]
    st = torch.sin(wv * ts[:, None].to(dtype))
    fields = (torch.einsum("sn,fpn->fsp", ct, mc.Acat)
              + torch.einsum("sn,fpn->fsp", st, mc.Bcat))  # [F, S, P]
    eta, u_x, u_y, w_, du_x, du_y, dw = fields[:7]
    if stretching == "wheeler":
        # dz = -(z + d) eta / (d + eta): second-order Taylor of every
        # kinematic field about the unstretched height
        (ux_z, uy_z, w_z, dux_z, duy_z, dw_z,
         ux_zz, uy_zz, w_zz, dux_zz, duy_zz, dw_zz) = fields[7:]
        dz = -(z[None, :] + d) * eta / (d + eta)
        h2 = 0.5 * dz * dz
        u_x = u_x + dz * ux_z + h2 * ux_zz
        u_y = u_y + dz * uy_z + h2 * uy_zz
        w_ = w_ + dz * w_z + h2 * w_zz
        du_x = du_x + dz * dux_z + h2 * dux_zz
        du_y = du_y + dz * duy_z + h2 * duy_zz
        dw = dw + dz * dw_z + h2 * dw_zz

    live = torch.logical_not(z[None, :] > eta).to(dtype)
    if current_alpha is None:
        Uc_pt = U_c
    else:
        frac = torch.clip((z + d) / d, 0.0, 1.0)
        Uc_pt = (U_c * frac ** _as(current_alpha, coords))[None, :]

    Ux = (u_x + Uc_pt * mc.cos_c) * live
    Uy = (u_y + Uc_pt * mc.sin_c) * live
    Uz = w_ * live
    Ax_, Ay_, Az_ = du_x * live, du_y * live, dw * live

    ex, ey, ez = (e[:, c].repeat_interleave(Q)[None, :] for c in range(3))
    Ue = Ux * ex + Uy * ey + Uz * ez
    Ae = Ax_ * ex + Ay_ * ey + Az_ * ez
    Upx, Upy, Upz = Ux - Ue * ex, Uy - Ue * ey, Uz - Ue * ez
    Apx, Apy, Apz = Ax_ - Ae * ex, Ay_ - Ae * ey, Az_ - Ae * ez
    Usq = Upx**2 + Upy**2 + Upz**2
    Umag = torch.where(Usq > 0, torch.sqrt(torch.where(Usq > 0, Usq, 1.0)),
                       0.0)

    Dp = D_m.repeat_interleave(Q)[None, :]
    Lw = L.repeat_interleave(Q)[None, :] * w.repeat(M)[None, :]
    drag_on = (Umag > 1e-10).to(dtype)
    rho = _as(rho_water, coords)
    cd_fac = (0.5 * rho * _per_member(Cd, Q, coords) * Dp * Umag * Lw
              * drag_on)
    ci_fac = rho * _per_member(Cm, Q, coords) * (math.pi * Dp**2 / 4.0) * Lw
    fd = torch.stack([cd_fac * Upx, cd_fac * Upy, cd_fac * Upz], dim=-1)
    fi = torch.stack([ci_fac * Apx, ci_fac * Apy, ci_fac * Apz], dim=-1)
    f = (fd + fi).reshape(S, M, Q, 3)

    F1 = torch.einsum("q,smqc->smc", 1.0 - s, f)
    F2 = torch.einsum("q,smqc->smc", s, f)
    return F1, F2, fd.sum(dim=1), fi.sum(dim=1)
