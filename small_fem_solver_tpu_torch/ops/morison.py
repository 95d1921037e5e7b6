"""Morison-equation member loading over a batch of wave phases (PyTorch
counterpart of the separable path of ``small_fem_solver_tpu/ops/morison.py``).

With theta = k x - omega t every Fourier harmonic factorizes,
cos(j theta) = cos(jkx) cos(jwt) + sin(jkx) sin(jwt): the spatial factors
depend only on geometry, so the kinematics of all phases are one
``[S, N] x [N, P]`` contraction over the quadrature points.  Analytic
acceleration, no evaluation-height clamp.

:func:`morison_phase_batch` is the plain PyTorch version of the fused CUDA
kernel in ``ops/hopper_kernels.py``: the tests hold the port against the
JAX package through it, and ``chip_smoke.py`` holds the kernel against it.

Semantics: compass-to-math heading theta = deg2rad(90 - dir); current split
onto its own heading; n-point Gauss-Legendre on [0, 1]; normal
decomposition; drag 0.5 rho Cd D |u_n| u_n L w gated at |u_n| > 1e-10,
inertia rho Cm (pi D^2 / 4) a_n L w; dry points (z > eta) carry nothing;
lever-rule end split F1 += (1 - s) f, F2 += s f.  Forces in N.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .waves import FourierWave


def _as(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (number or tensor) as a tensor of ``ref``'s dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def hydro_diameter_m(sections, sect_id, marine_growth_mm=0.0):
    """Effective hydrodynamic member diameter [m]: outer D plus twice the
    marine-growth thickness."""
    return (sections.D_outer[sect_id] + 2.0 * marine_growth_mm) / 1000.0


def hydro_members(model, marine_growth_mm, Cd, Cm):
    """Hydrodynamic segment set ``(conn_h, D_m_h, Cd_h, Cm_h)`` of a model.

    The port's :class:`..models.model.JacketModel` refuses appurtenances,
    so the set is the structural members with the scalar coefficients.
    """
    D_m = hydro_diameter_m(model.sections, model.sect_id, marine_growth_mm)
    return model.conn, D_m, Cd, Cm


def gauss_legendre_01(n: int, dtype=np.float64):
    """Nodes and weights of n-point Gauss-Legendre on [0, 1] (host
    constants): s = (xi + 1) / 2, w = weight / 2."""
    xi, wt = np.polynomial.legendre.leggauss(n)
    return (xi.astype(dtype) + 1.0) / 2.0, wt.astype(dtype) / 2.0


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
    """Member end forces [S, M, 3] summed onto their nodes [S, n_nodes, 3]."""
    contrib = torch.cat([F1, F2], dim=1)
    nodes = torch.cat([conn[:, 0], conn[:, 1]])
    out = torch.zeros(F1.shape[0], n_nodes, 3, dtype=F1.dtype,
                      device=F1.device)
    return out.index_add_(1, nodes, contrib)


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
    dtype = coords.dtype
    wave = wave.to(dtype, coords.device)
    j = torch.arange(1, wave.n_modes + 1, dtype=dtype, device=coords.device)
    return _morison_batch_core(
        j * wave.k, j * wave.omega, torch.zeros_like(j), wave.E, wave.U,
        wave.d, wave.U_c, coords, conn, D_m, wave_dir_deg, current_dir_deg,
        Cd, Cm, rho_water, ts, n_gauss, current_alpha, stretching)


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
                         current_dir_deg, n_gauss: int,
                         stretching: str) -> _ModeCoeffs:
    """Per-mode spatial harmonic factors at every Gauss point — the
    phase-independent half of the separable engine."""
    dtype = coords.dtype
    theta_w = torch.deg2rad(_as(90.0 - wave_dir_deg, coords))
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
                        ts, n_gauss: int, current_alpha, stretching: str):
    """Separable Morison engine over an arbitrary mode set (per-mode [N]
    wavenumbers ``kv``, frequencies ``wv``, phase offsets ``phiv``, surface
    and velocity coefficients ``E``/``U``)."""
    dtype = coords.dtype
    mc = _mode_spatial_coeffs(kv, wv, phiv, E, U, d, coords, conn,
                              wave_dir_deg, current_dir_deg, n_gauss,
                              stretching)
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
    total_drag = fd.sum(dim=1)
    total_inertia = fi.sum(dim=1)
    return MorisonPhaseBatch(
        nodal_forces=nodal_scatter(F1, F2, conn, coords.shape[0]),
        total_drag=total_drag, total_inertia=total_inertia,
        total_morison=total_drag + total_inertia, F1=F1, F2=F2)
