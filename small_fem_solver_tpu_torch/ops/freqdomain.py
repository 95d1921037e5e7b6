"""Frequency-domain stochastic (spectral) response of the jacket (PyTorch
counterpart of ``small_fem_solver_tpu/ops/freqdomain.py``).

Borgman-linearized Morison drag makes the random-sea loading a linear map
from each spectral component to a load vector, so the response to a sea
state follows from 2N+1 transfer solves (one mean row, then cos and sin
rows per component), and its second-order statistics (stress standard
deviations, spectral moments, upcrossing rates, closed-form fatigue,
most-probable-maximum storm extremes) in closed form.

Conventions, as in the JAX package: Borgman (1969) drag linearization
|v| -> sqrt(8 / pi) sigma_v at each point; loads integrated to the mean
water line (z <= 0); quasi-static transfer (the dynamic transfer lives in
``api.spectral_transfer_dynamic``); fatigue stress = axial + bending normal
stress at the 8 circumferential points, governed per member by the
largest-variance point.

:func:`linearized_sea_loads` keeps the mode axis, so it is not the fused
Morison kernel's function: it runs as plain tensor operations on the
model's device.
"""
from __future__ import annotations

import math
from math import gamma as gamma_fn
from typing import NamedTuple

import torch

from .fatigue import SECONDS_PER_YEAR, SN_CURVES
from .morison import _as, _mode_spatial_coeffs


class LinearizedSeaLoads(NamedTuple):
    """Per-mode linearized load coefficient rows (chain-ready): row 0 the
    mean (linearized current drag), rows 1..N cos(w_i t), N+1..2N
    sin(w_i t)."""

    F1: torch.Tensor           # [R, M, 3] member node-1 end forces (N)
    F2: torch.Tensor           # [R, M, 3] member node-2 end forces
    totals: torch.Tensor       # [R, 3] global force rows (N)
    sigma_v_max: torch.Tensor  # [] peak perpendicular-velocity std (m/s)
    c_lin_mean: torch.Tensor   # [] wetted-average Borgman factor (m/s)
    c_damp: torch.Tensor       # [M] member-average linearized drag damping
    #   0.5 rho Cd D sqrt(8/pi) sigma_v  [N s/m per m length]
    totals_moment: torch.Tensor  # [R, 3] global moment rows about the
    #   mudline origin (0, 0, -d)  [N m]


def linearized_sea_loads(sea, coords, conn, D_m, wave_dir_deg,
                         current_dir_deg, Cd, Cm, rho_water,
                         n_gauss: int = 15,
                         current_alpha=None) -> LinearizedSeaLoads:
    """Borgman-linearized Morison load rows of ``sea`` in ``coords``'
    dtype on its device: the drag magnitude becomes the local sqrt(8/pi)
    sigma_v, so every component's force is linear in its amplitude, and
    the lever-rule split applies per component."""
    dtype = coords.dtype
    sea = sea.to(dtype, coords.device)
    mc = _mode_spatial_coeffs(sea.k, sea.omega, sea.phi, sea.E, sea.U, sea.d,
                              coords, conn, wave_dir_deg, current_dir_deg,
                              n_gauss, "none", sea.dir_deg)
    z = mc.z
    N = sea.omega.shape[0]
    M, Q = conn.shape[0], n_gauss

    live = (z <= 0.0).to(dtype)[:, None]                     # [P, 1]
    A_u = torch.stack([mc.Acat[1], mc.Acat[2], mc.Acat[3]], -1) \
        * live[..., None]                                    # [P, N, 3]
    B_u = torch.stack([mc.Bcat[1], mc.Bcat[2], mc.Bcat[3]], -1) \
        * live[..., None]
    A_a = torch.stack([mc.Acat[4], mc.Acat[5], mc.Acat[6]], -1) \
        * live[..., None]
    B_a = torch.stack([mc.Bcat[4], mc.Bcat[5], mc.Bcat[6]], -1) \
        * live[..., None]
    e_p = mc.e.repeat_interleave(Q, dim=0)                   # [P, 3]

    def perp(v):
        return v - (v * e_p[:, None, :]).sum(-1, keepdim=True) \
            * e_p[:, None, :]

    A_up, B_up = perp(A_u), perp(B_u)
    A_ap, B_ap = perp(A_a), perp(B_a)

    if current_alpha is None:
        Uc_pt = sea.U_c.expand(z.shape)
    else:
        frac = torch.clip((z + sea.d) / sea.d, 0.0, 1.0)
        Uc_pt = sea.U_c * frac ** _as(current_alpha, coords)
    mu = torch.stack([Uc_pt * mc.cos_c, Uc_pt * mc.sin_c,
                      torch.zeros_like(Uc_pt)], -1) * live   # [P, 3]
    mu_p = mu - (mu * e_p).sum(-1, keepdim=True) * e_p

    sigma2 = 0.5 * (torch.sum(A_up**2, dim=(1, 2))
                    + torch.sum(B_up**2, dim=(1, 2)))        # [P]
    sigma_v = torch.sqrt(sigma2)
    c_lin = math.sqrt(8.0 / math.pi) * sigma_v

    s, w = mc.s, mc.w
    Dp = D_m.repeat_interleave(Q)
    Lw = mc.L.repeat_interleave(Q) * w.repeat(M)
    Cd, Cm = _as(Cd, coords), _as(Cm, coords)
    Cdp = Cd.repeat_interleave(Q) if Cd.ndim == 1 else Cd
    Cmp = Cm.repeat_interleave(Q) if Cm.ndim == 1 else Cm
    rho = _as(rho_water, coords)
    cd_fac = (0.5 * rho * Cdp * Dp * c_lin * Lw)[:, None]    # [P, 1]
    ci_fac = (rho * Cmp * (math.pi * Dp**2 / 4.0) * Lw)[:, None]

    f_mean = cd_fac * mu_p                                   # [P, 3]
    f_cos = cd_fac[..., None] * A_up + ci_fac[..., None] * A_ap
    f_sin = cd_fac[..., None] * B_up + ci_fac[..., None] * B_ap
    f = torch.cat([f_mean[:, None, :], f_cos, f_sin], dim=1)  # [P, R, 3]
    R = 1 + 2 * N
    f = f.movedim(1, 0).reshape(R, M, Q, 3)

    F1 = torch.einsum("q,rmqc->rmc", 1.0 - s, f)
    F2 = torch.einsum("q,rmqc->rmc", s, f)
    totals = torch.sum(f, dim=(1, 2))

    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    p = c1[:, None, :] + s[None, :, None] * (c2 - c1)[:, None, :]   # [M,Q,3]
    r_arm = p - torch.stack([torch.zeros_like(sea.d),
                             torch.zeros_like(sea.d), -sea.d])
    totals_moment = torch.sum(torch.linalg.cross(
        r_arm[None].expand(R, M, Q, 3), f, dim=-1), dim=(1, 2))

    wet = live[:, 0]
    c_mean = torch.sum(c_lin * wet) / torch.clamp(torch.sum(wet), min=1.0)
    cd_unit = (0.5 * rho * Cdp * Dp * c_lin).reshape(M, Q)
    c_damp = torch.einsum("q,mq->m", w, cd_unit)
    return LinearizedSeaLoads(F1=F1, F2=F2, totals=totals,
                              sigma_v_max=torch.max(sigma_v),
                              c_lin_mean=c_mean, c_damp=c_damp,
                              totals_moment=totals_moment)


class FreqDomainResponse(NamedTuple):
    """Closed-form response statistics of one sea state: per-member stress
    statistics at the governing (largest-m0) of the 8 circumferential
    points; ``mpm_*`` are most-probable maxima over ``T_storm_s``, mean +
    sigma sqrt(2 ln(nu0 T))."""

    omega: torch.Tensor             # [N] component frequencies (rad/s)
    sigma_stress: torch.Tensor      # [M] stress std dev (MPa)
    mean_stress: torch.Tensor       # [M] mean (static + current) stress
    nu0_hz: torch.Tensor            # [M] mean-upcrossing rate
    bandwidth_alpha2: torch.Tensor  # [M] irregularity factor
    mpm_stress: torch.Tensor        # [M] MPM |stress| over the storm (MPa)
    mpm_utilization: torch.Tensor   # [M] mpm_stress / fy
    damage_nb: torch.Tensor         # [M] narrow-band Rayleigh Miner damage
    damage_wl: torch.Tensor         # [M] Wirsching-Light corrected damage
    life_years_nb: torch.Tensor
    life_years_wl: torch.Tensor
    sigma_disp_mm: torch.Tensor     # [] max nodal-translation std dev
    mpm_disp_mm: torch.Tensor       # [] MPM of that translation
    sigma_base_shear_N: torch.Tensor
    mean_base_shear_N: torch.Tensor
    sigma_otm_Nm: torch.Tensor
    mean_otm_Nm: torch.Tensor
    mpm_otm_Nm: torch.Tensor
    sigma_v_max: torch.Tensor       # linearization diagnostics
    c_lin_mean: torch.Tensor


def _mpm_factor(nu0, T_storm_s):
    """Most-probable-maximum peak factor sqrt(2 ln(nu0 T)) (>= 0)."""
    n_cycles = torch.clamp(nu0 * T_storm_s, min=1.0 + 1e-9)
    return torch.sqrt(2.0 * torch.log(n_cycles))


def spectral_stats(omega, stress_mean, stress_cos, stress_sin, U_mean, U_cos,
                   U_sin, totals, fy, T_storm_s, exposure_years,
                   curve: str = "D-sea-cp", scf=1.0, occurrence=1.0,
                   sigma_v_max=0.0, c_lin_mean=0.0,
                   totals_moment=None) -> FreqDomainResponse:
    """Spectral moments -> fatigue and extremes from per-component transfer
    rows: ``stress_*`` the normal stress at the 8 points (mean [M, 8], rows
    [N, M, 8], MPa), ``U_*`` the displacement rows (mm), ``totals`` the
    [R, 3] force rows.  Narrow-band Rayleigh damage at nu0 = sqrt(m2/m0) /
    2 pi with the Wirsching-Light (1980) wide-band correction."""
    if curve not in SN_CURVES:
        raise ValueError(f"unknown S-N curve {curve!r}; "
                         f"available: {sorted(SN_CURVES)}")
    m_slope, loga = SN_CURVES[curve]
    ref = stress_cos

    scf = _as(scf, ref)
    scf = scf[:, None] if scf.ndim == 1 else scf
    sc, ss, sm = stress_cos * scf, stress_sin * scf, stress_mean * scf

    amp2 = 0.5 * (sc**2 + ss**2)                         # [N, M, 8]
    w2 = omega[:, None, None] ** 2
    m0 = torch.sum(amp2, dim=0)                          # [M, 8]
    m2 = torch.sum(amp2 * w2, dim=0)
    m4 = torch.sum(amp2 * w2**2, dim=0)

    pt_ = torch.argmax(m0, dim=-1)[:, None]              # [M, 1]

    def take(a):
        return torch.take_along_dim(a, pt_, dim=-1)[:, 0]
    m0g, m2g, m4g, mean_g = take(m0), take(m2), take(m4), take(sm)

    eps_num = 1e-30
    sigma = torch.sqrt(torch.clamp(m0g, min=0.0))
    nu0 = torch.sqrt(torch.clamp(m2g, min=0.0)
                     / torch.clamp(m0g, min=eps_num)) / (2.0 * math.pi)
    alpha2 = torch.clip(m2g / torch.sqrt(torch.clamp(m0g * m4g, min=eps_num)),
                        0.0, 1.0)

    exposure_s = exposure_years * SECONDS_PER_YEAR * occurrence
    Kbar = 10.0 ** loga
    d_nb = (nu0 * exposure_s / Kbar
            * (2.0 * math.sqrt(2.0) * torch.clamp(sigma, min=1e-12))
            ** m_slope * gamma_fn(1.0 + m_slope / 2.0))
    d_nb = torch.where(sigma > 1e-9, d_nb, 0.0)
    eps_band = torch.sqrt(torch.clamp(1.0 - alpha2**2, min=0.0))
    a_wl = 0.926 - 0.033 * m_slope
    b_wl = 1.587 * m_slope - 2.323
    lam = a_wl + (1.0 - a_wl) * (1.0 - eps_band) ** b_wl
    d_wl = lam * d_nb

    inf = torch.full_like(d_nb, float("inf"))
    life_nb = torch.where(d_nb > 0, exposure_years / d_nb, inf)
    life_wl = torch.where(d_wl > 0, exposure_years / d_wl, inf)

    mpm = torch.abs(mean_g) + sigma * _mpm_factor(nu0, T_storm_s)
    util = mpm / fy

    # displacement: the governing translation DOF (largest variance)
    var_U = 0.5 * torch.sum(U_cos**2 + U_sin**2, dim=0)  # [n_dof]
    n_nodes = var_U.shape[0] // 6
    var_t = var_U.reshape(n_nodes, 6)[:, :3]
    mean_t = U_mean.reshape(n_nodes, 6)[:, :3]
    i_flat = torch.argmax(var_t)          # a device index: no sync
    sig_d = torch.sqrt(var_t.reshape(-1)[i_flat])
    mu_d = torch.abs(mean_t.reshape(-1)[i_flat])
    dof = 6 * torch.div(i_flat, 3, rounding_mode="floor") + i_flat % 3
    a2d = 0.5 * (U_cos.reshape(U_cos.shape[0], -1)[:, dof] ** 2
                 + U_sin.reshape(U_sin.shape[0], -1)[:, dof] ** 2)
    nu0_d = torch.sqrt(torch.sum(a2d * omega**2)
                       / torch.clamp(torch.sum(a2d), min=eps_num)) \
        / (2 * math.pi)
    mpm_d = mu_d + sig_d * _mpm_factor(nu0_d, T_storm_s)

    N = omega.shape[0]
    tc, ts_ = totals[1:1 + N], totals[1 + N:]
    fx2 = 0.5 * (tc[:, 0]**2 + ts_[:, 0]**2)
    fy2 = 0.5 * (tc[:, 1]**2 + ts_[:, 1]**2)
    sig_bs = torch.sqrt(torch.sum(fx2 + fy2))
    mean_bs = torch.sqrt(totals[0, 0]**2 + totals[0, 1]**2)

    if totals_moment is None:
        totals_moment = torch.zeros_like(totals)
    mc_, ms_ = totals_moment[1:1 + N], totals_moment[1 + N:]
    m2_rows = 0.5 * (mc_[:, 0]**2 + ms_[:, 0]**2
                     + mc_[:, 1]**2 + ms_[:, 1]**2)
    sig_otm = torch.sqrt(torch.sum(m2_rows))
    mean_otm = torch.sqrt(totals_moment[0, 0]**2 + totals_moment[0, 1]**2)
    nu0_otm = torch.sqrt(torch.sum(m2_rows * omega**2)
                         / torch.clamp(torch.sum(m2_rows), min=eps_num)) \
        / (2.0 * math.pi)
    mpm_otm = mean_otm + sig_otm * _mpm_factor(nu0_otm, T_storm_s)

    return FreqDomainResponse(
        omega=omega, sigma_stress=sigma, mean_stress=mean_g, nu0_hz=nu0,
        bandwidth_alpha2=alpha2, mpm_stress=mpm, mpm_utilization=util,
        damage_nb=d_nb, damage_wl=d_wl, life_years_nb=life_nb,
        life_years_wl=life_wl, sigma_disp_mm=sig_d, mpm_disp_mm=mpm_d,
        sigma_base_shear_N=sig_bs, mean_base_shear_N=mean_bs,
        sigma_otm_Nm=sig_otm, mean_otm_Nm=mean_otm, mpm_otm_Nm=mpm_otm,
        sigma_v_max=_as(sigma_v_max, ref), c_lin_mean=_as(c_lin_mean, ref))
