"""Irregular (spectral) seas: JONSWAP / PM spectra, random-sea realizations,
their kinematics and Morison loads, and the spectral fatigue screen
(PyTorch counterpart of ``small_fem_solver_tpu/ops/spectrum.py``).

A realization is a :class:`SpectralSea` of N independent linear (Airy)
components (omega_i, k_i, a_i, phi_i, optional heading).  Each component
separates like a harmonic of a steady wave, so the loads of all
components at all sample times go through the same engine as the phase
batch (:func:`.morison._morison_batch_core` with a general mode set): on
CUDA tensors :func:`morison_sea_batch` launches the general-mode instance
of the fused Morison kernel (``ops/hopper_kernels.py``), on the CPU it runs
the plain version.

Spectra (angular-frequency form, S(omega) in m^2 s/rad):

    JONSWAP:  S = alpha g^2 w^-5 exp(-1.25 (wp/w)^4) gamma^b,
              b = exp(-(w - wp)^2 / (2 sigma^2 wp^2)),
              sigma = 0.07 (w <= wp) else 0.09
    PM:       the gamma = 1 special case.

The amplitudes are normalized on the component grid so that m0 = sum a_i^2
/ 2 = Hs^2 / 16 exactly.
"""
from __future__ import annotations

import dataclasses
from math import gamma as gamma_fn
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from .dispersion import solve_dispersion
from .fatigue import SECONDS_PER_YEAR, SN_CURVES
from .morison import (MorisonPhaseBatch, _as, _morison_batch_core,
                      nodal_scatter)


def jonswap_shape(omega, Tp, gamma: float = 3.3):
    """Unnormalized JONSWAP spectral shape (host numpy; the caller fixes
    the scale)."""
    omega = np.asarray(omega, np.float64)
    wp = 2.0 * np.pi / Tp
    sigma = np.where(omega <= wp, 0.07, 0.09)
    b = np.exp(-((omega - wp) ** 2) / (2.0 * sigma**2 * wp**2))
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        shape = (omega**-5.0 * np.exp(-1.25 * (wp / omega) ** 4)
                 * gamma**b)
    return np.where(omega > 0, shape, 0.0)


def pm_shape(omega, Tp):
    """Pierson-Moskowitz shape = JONSWAP with gamma = 1."""
    return jonswap_shape(omega, Tp, gamma=1.0)


@dataclasses.dataclass(frozen=True)
class SpectralSea:
    """Linear random-sea realization: N independent Airy components.

    eta(x, t)   = sum_i a_i cos(k_i x - omega_i t + phi_i)
    u(x, z, t)  = sum_i U_i C_i(z) cos(.) + U_c,  U_i = a_i omega_i /
                  tanh(k_i d), C_i = cosh(k_i (z + d)) / cosh(k_i d)
    w(x, z, t)  = sum_i U_i S_i(z) sin(.)

    Per-mode fields are [N] tensors, scalars 0-d; ``dir_deg`` ([N]
    headings relative to the load case's wave heading) is None for a
    long-crested sea.
    """

    omega: torch.Tensor     # [N] component angular frequencies [rad/s]
    k: torch.Tensor         # [N] wavenumbers [1/m]
    a: torch.Tensor         # [N] component amplitudes [m]
    phi: torch.Tensor       # [N] phases [rad]
    E: torch.Tensor         # [N] = a (surface cosine coefficients)
    U: torch.Tensor         # [N] velocity coefficients [m/s]
    d: torch.Tensor         # water depth [m]
    U_c: torch.Tensor       # uniform current [m/s]
    Hs: torch.Tensor        # significant wave height [m]
    Tp: torch.Tensor        # peak period [s]
    dir_deg: torch.Tensor | None = None
    spectrum: str = "jonswap"

    @property
    def n_modes(self) -> int:
        return self.omega.shape[-1]

    @property
    def m0(self) -> torch.Tensor:
        """Zeroth spectral moment of the realization = sum a^2 / 2."""
        return torch.sum(self.a**2) / 2.0

    @property
    def mean_zero_crossing_period(self) -> torch.Tensor:
        """Tz = 2 pi sqrt(m0 / m2) of the discretized sea."""
        m2 = torch.sum(self.omega**2 * self.a**2) / 2.0
        return 2.0 * torch.pi * torch.sqrt(self.m0 / m2)

    def to(self, dtype: torch.dtype, device=None) -> "SpectralSea":
        """Every tensor field in ``dtype`` on ``device`` (default: where
        it is)."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(dtype=dtype, device=device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def make_random_sea(Hs, Tp, d, n_components: int = 64, seed: int = 0,
                    spectrum: str = "jonswap", gamma: float = 3.3,
                    U_c=0.0, omega_range=None, spreading_s=None,
                    dtype: torch.dtype = torch.float64,
                    device=None) -> SpectralSea:
    """Discretize a JONSWAP / PM spectrum into an N-component realization.

    Equal-d(omega) grid over ``omega_range`` (default [0.5, 3.0] x the peak
    frequency), component frequencies at the interval midpoints, amplitudes
    a_i = sqrt(2 S_i dw) rescaled so m0 = Hs^2 / 16, phases uniform from
    ``numpy.random.default_rng(seed)`` (the JAX package's numbers for the
    same seed).  ``spreading_s`` draws one heading per component from the
    cos^(2s)(theta / 2) spreading function by inverse-CDF sampling of the
    same generator (a short-crested sea).  Wavenumbers from
    :func:`.dispersion.solve_dispersion` in float64 on the host; the fields
    are then cast to ``dtype`` on ``device``.
    """
    device = resolve_device(device)
    Hs_f, Tp_f, d_f = float(Hs), float(Tp), float(d)
    wp = 2.0 * np.pi / Tp_f
    lo, hi = omega_range if omega_range is not None else (0.5 * wp, 3.0 * wp)
    edges = np.linspace(lo, hi, n_components + 1)
    om = 0.5 * (edges[:-1] + edges[1:])
    dw = np.diff(edges)

    if spectrum == "jonswap":
        shape = jonswap_shape(om, Tp_f, gamma)
    elif spectrum == "pm":
        shape = pm_shape(om, Tp_f)
    else:
        raise ValueError(f"unknown spectrum {spectrum!r} "
                         "(available: 'jonswap', 'pm')")
    a = np.sqrt(2.0 * shape * dw)
    a = a * np.sqrt(Hs_f**2 / 16.0 / (np.sum(a**2) / 2.0))

    rng = np.random.default_rng(seed)
    phi = rng.uniform(0.0, 2.0 * np.pi, size=n_components)

    dir_deg = None
    if spreading_s is not None:
        s_exp = float(spreading_s)
        if s_exp <= 0:
            raise ValueError("spreading_s must be > 0 (larger = more "
                             "long-crested)")
        th = np.linspace(-np.pi, np.pi, 4097)
        cdf = np.cumsum(np.cos(th / 2.0) ** (2.0 * s_exp))
        cdf = (cdf - cdf[0]) / (cdf[-1] - cdf[0])
        u = rng.uniform(0.0, 1.0, size=n_components)
        dir_deg = torch.as_tensor(np.degrees(np.interp(u, cdf, th)),
                                  dtype=dtype, device=device)

    f64 = torch.float64
    om_t = torch.as_tensor(om, dtype=f64)
    k = solve_dispersion(om_t, torch.tensor(d_f, dtype=f64))
    a_t = torch.as_tensor(a, dtype=f64)
    U = a_t * om_t / torch.tanh(k * d_f)

    def cast(v):
        return torch.as_tensor(v, dtype=f64).to(dtype=dtype, device=device)
    return SpectralSea(omega=cast(om_t), k=cast(k), a=cast(a_t),
                       phi=cast(phi), E=cast(a_t), U=cast(U), d=cast(d_f),
                       U_c=cast(float(U_c)), Hs=cast(Hs_f), Tp=cast(Tp_f),
                       dir_deg=dir_deg, spectrum=spectrum)


def sea_surface(sea: SpectralSea, x, t, y=0.0, wave_dir_deg=0.0):
    """eta of the realization at ``x`` / ``y`` / ``t`` of any common shape
    (in the sea's dtype on its device).  For a long-crested sea ``x`` is
    the coordinate along the propagation direction (``y`` ignored); for a
    spread sea (x, y) are plan coordinates and ``wave_dir_deg`` the mean
    compass heading the relative component headings add to."""
    x = _as(x, sea.k)[..., None]
    t = _as(t, sea.k)[..., None]
    if sea.dir_deg is None:
        kx = sea.k * x
    else:
        th_n = torch.deg2rad(90.0 - (_as(wave_dir_deg, sea.k) + sea.dir_deg))
        y = _as(y, sea.k)[..., None]
        kx = sea.k * (x * torch.cos(th_n) + y * torch.sin(th_n))
    return torch.sum(sea.a * torch.cos(kx - sea.omega * t + sea.phi), dim=-1)


class SeaKinematics(NamedTuple):
    u: torch.Tensor
    w: torch.Tensor
    du_dt: torch.Tensor
    dw_dt: torch.Tensor
    eta: torch.Tensor
    submerged: torch.Tensor


def sea_kinematics(sea: SpectralSea, x, z, t) -> SeaKinematics:
    """Pointwise linear-superposition kinematics of a long-crested sea
    (dry-masked, analytic d/dt); ``x`` along the heading.  A spread sea
    raises: its headings are resolved inside :func:`morison_sea_batch`."""
    if sea.dir_deg is not None:
        raise ValueError("sea_kinematics is the long-crested 2D oracle; "
                         "spread seas resolve per-mode headings inside "
                         "morison_sea_batch")
    x, z, t = torch.broadcast_tensors(_as(x, sea.k), _as(z, sea.k),
                                      _as(t, sea.k))
    eta = sea_surface(sea, x, t)
    th = sea.k * x[..., None] - sea.omega * t[..., None] + sea.phi
    A = sea.k * (z[..., None] + sea.d)
    B = sea.k * sea.d
    Aa = torch.abs(A)
    scale = torch.exp(Aa - B) / (1.0 + torch.exp(-2.0 * B))
    C = scale * (1.0 + torch.exp(-2.0 * Aa))
    S = torch.sign(A) * scale * (1.0 - torch.exp(-2.0 * Aa))
    u = torch.sum(sea.U * C * torch.cos(th), dim=-1)
    w = torch.sum(sea.U * S * torch.sin(th), dim=-1)
    du = torch.sum(sea.U * C * sea.omega * torch.sin(th), dim=-1)
    dw = -torch.sum(sea.U * S * sea.omega * torch.cos(th), dim=-1)
    dry = z > eta
    zero = torch.zeros_like(u)
    return SeaKinematics(
        u=torch.where(dry, zero, u + sea.U_c), w=torch.where(dry, zero, w),
        du_dt=torch.where(dry, zero, du), dw_dt=torch.where(dry, zero, dw),
        eta=eta, submerged=torch.logical_not(dry))


def morison_sea_end_forces(sea: SpectralSea, coords, conn, D_m, wave_dir_deg,
                           current_dir_deg, Cd, Cm, rho_water, ts,
                           n_gauss: int = 15, current_alpha=None,
                           stretching: str = "none"):
    """The plain version of the sea's member end forces: (F1 [S, M, 3],
    F2 [S, M, 3], total_drag [S, 3], total_inertia [S, 3]) in ``coords``'
    dtype, through :func:`.morison._morison_batch_core` with the sea's
    components as the mode set."""
    sea = sea.to(coords.dtype, coords.device)
    return _morison_batch_core(
        sea.k, sea.omega, sea.phi, sea.E, sea.U, sea.d, sea.U_c, coords,
        conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm, rho_water, ts,
        n_gauss, current_alpha, stretching, rel_dir_deg=sea.dir_deg)


def morison_sea_batch(sea: SpectralSea, coords, conn, D_m, wave_dir_deg,
                      current_dir_deg, Cd, Cm, rho_water, ts,
                      n_gauss: int = 15, current_alpha=None,
                      stretching: str = "none") -> MorisonPhaseBatch:
    """Morison loads of the random sea at every sample time ``ts`` [S], in
    ``coords``' dtype: on CUDA tensors one launch of the fused kernel's
    general-mode instance (``hopper_kernels.morison_sea_batch_cuda``), on
    the CPU the plain version, and on the card too at ``n_gauss`` > 16,
    past the kernel's limit (no launch; one plain route counted, see
    ``hopper_kernels.kernel_route``).  ``stretching='wheeler'`` is the
    standard crest treatment for linear irregular seas (API RP 2A)."""
    # hopper_kernels imports this module for the plain version
    from .hopper_kernels import kernel_route, morison_sea_batch_cuda
    if kernel_route(coords.device, n_gauss):
        return morison_sea_batch_cuda(sea, coords, conn, D_m, wave_dir_deg,
                                      current_dir_deg, Cd, Cm, rho_water, ts,
                                      n_gauss, current_alpha, stretching)
    F1, F2, drag, inertia = morison_sea_end_forces(
        sea, coords, conn, D_m, wave_dir_deg, current_dir_deg, Cd, Cm,
        rho_water, ts, n_gauss, current_alpha, stretching)
    return MorisonPhaseBatch(
        nodal_forces=nodal_scatter(F1, F2, conn, coords.shape[0]),
        total_drag=drag, total_inertia=inertia,
        total_morison=drag + inertia, F1=F1, F2=F2)


# ---------------------------------------------------------------------------
# Spectral fatigue screening (host numpy: histories come back to the host)
# ---------------------------------------------------------------------------

class SpectralFatigue(NamedTuple):
    """Narrow-band (Rayleigh) and rainflow fatigue screen per member."""

    sigma_mpa: torch.Tensor         # [M] std dev of the stress history
    nu0_hz: torch.Tensor            # [M] mean-upcrossing rate
    damage_rayleigh: torch.Tensor   # [M] narrow-band Miner damage
    damage_rainflow: torch.Tensor   # [M] rainflow-counted Miner damage
    life_years_rayleigh: torch.Tensor
    life_years_rainflow: torch.Tensor


def _rainflow_ranges(y: np.ndarray):
    """Cycle ranges of one history by the ASTM E1049 rainflow rules:
    ``(ranges, weights)``, full cycles weight 1.0, half cycles (the
    history start and the residual path) 0.5."""
    dy = np.diff(y)
    keep = np.ones(y.shape[0], dtype=bool)
    keep[1:-1] = dy[:-1] * dy[1:] < 0
    stack: list[float] = []
    full, half = [], []
    for x in y[keep]:
        stack.append(float(x))
        while len(stack) >= 3:
            X = abs(stack[-2] - stack[-1])
            Y = abs(stack[-3] - stack[-2])
            if X < Y:
                break
            if len(stack) == 3:
                half.append(Y)          # half cycle at the history start
                stack.pop(0)
            else:
                full.append(Y)
                del stack[-3:-1]
    for i in range(len(stack) - 1):     # residuals count as half cycles
        half.append(abs(stack[i] - stack[i + 1]))
    return np.asarray(full + half), np.concatenate(
        [np.ones(len(full)), 0.5 * np.ones(len(half))])


def spectral_fatigue_screen(vm_history, dt: float, exposure_years: float,
                            curve: str = "D", scf=1.0,
                            occurrence: float = 1.0) -> SpectralFatigue:
    """Fatigue damage per member from an irregular-sea stress history
    ``vm_history`` [S, M] (MPa, spacing ``dt``): narrow-band Rayleigh at
    the measured mean-upcrossing rate, and rainflow counting (the native
    counter of ``native/mesh_kit.cpp`` when it builds, else the Python
    stack: identical results), both scaled to ``exposure_years`` x
    ``occurrence``.  ``scf`` is a scalar or per-member [M].  Computed on
    the host in float64; the results are float64 CPU tensors."""
    if curve not in SN_CURVES:
        raise ValueError(f"unknown S-N curve {curve!r}; "
                         f"available: {sorted(SN_CURVES)}")
    m_slope, loga = SN_CURVES[curve]
    if isinstance(vm_history, torch.Tensor):
        vm_history = vm_history.detach().cpu().numpy()
    if isinstance(scf, torch.Tensor):
        scf = scf.detach().cpu().numpy()
    vm = np.asarray(vm_history, dtype=np.float64) * scf       # [S, M]
    S, M = vm.shape
    T_real = S * dt
    mean = vm.mean(axis=0)
    sigma = vm.std(axis=0)
    above = vm > mean[None, :]
    nu0 = np.maximum((~above[:-1] & above[1:]).sum(axis=0), 1e-12) / T_real

    exposure_s = exposure_years * SECONDS_PER_YEAR * occurrence
    Kbar = 10.0**loga
    d_ray = (nu0 * exposure_s / Kbar
             * (2.0 * np.sqrt(2.0) * np.maximum(sigma, 1e-12)) ** m_slope
             * gamma_fn(1.0 + m_slope / 2.0))
    d_ray = np.where(sigma > 1e-9, d_ray, 0.0)

    scale_t = exposure_s / T_real
    sums = native.rainflow_damage_sums_native(vm, m_slope)
    if sums is not None:
        d_rf = np.where(sigma > 1e-9, sums[0] / Kbar * scale_t, 0.0)
    else:
        d_rf = np.zeros(M)
        for j in range(M):
            if sigma[j] <= 1e-9:
                continue
            ranges, weight = _rainflow_ranges(vm[:, j])
            if ranges.size:
                d_rf[j] = np.sum(weight * ranges**m_slope) / Kbar * scale_t

    with np.errstate(divide="ignore"):
        life_ray = np.where(d_ray > 0, exposure_years / d_ray, np.inf)
        life_rf = np.where(d_rf > 0, exposure_years / d_rf, np.inf)
    t = torch.from_numpy
    return SpectralFatigue(
        sigma_mpa=t(sigma), nu0_hz=t(nu0), damage_rayleigh=t(d_ray),
        damage_rainflow=t(d_rf), life_years_rayleigh=t(life_ray),
        life_years_rainflow=t(life_rf))
