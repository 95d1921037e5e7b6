"""Pile-soil interaction: API RP 2A p-y / t-z / Q-z curves to pile-head
springs (PyTorch counterpart of ``small_fem_solver_tpu/ops/soil.py``).

A laterally and axially loaded pile is a beam / rod on a nonlinear
Winkler foundation with the API RP 2A-WSD (21st ed., section 6.8) soil
resistance curves, solved in float64 by a Newton iteration of fixed length
on the device of the caller (``device=None``: the CUDA card; the
spring-supported analyses pass the model's).  The curves and the head
springs are the JAX module's; see its docstring for the formulas:

- lateral ``sand`` (A p_u tanh(k z y / (A p_u)), Reese-Cox-Koop wedge
  coefficients), ``clay`` (Matlock, 0.5 (y/y_50)^(1/3) capped at 1,
  linear below y/y_50 = 1e-3) and ``linear`` (p = E_s y);
- axial t-z (sand bilinear to 2.54 mm, clay the API table odd-extended,
  linear k_s u) and the API Q-z tip curve (compression only);
- head springs: secant k_y = H / y(0), k_z = V / u(0), k_rot = M /
  theta(0) from three solves at the working loads, torsion from the
  elastic axial analogy.

The Newton tangent is the curves' derivative in closed form, with the
values ``jax.grad`` gives where the JAX module differentiates through a
kink, because the iteration starts at u = 0, exactly on them:
``maximum(u, 0)`` of the tip and ``minimum`` / ``maximum`` of the clay cap
and the sand clip weigh a tie by 1/2, a table knot takes the slope of the
segment to its right (:func:`.interp.interp_slope`), and the guarded clay
cube root has no derivative inside its linear core.  The JAX module sends
its float64 solves to the host CPU because the TPU has no float64 LU
(``small_fem_solver_tpu/ops/soil.py:318-323``); here ``torch.linalg.solve``
runs on the caller's device, the card included.

Units: soil input in kPa, kN/m^3, m, mm; internal SI; the springs come
out in N/mm and N*mm/rad, ready for ``analyze_ssi`` / ``support_stiffness=``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .interp import interp, interp_slope

F64 = torch.float64

# API chart fits (host-side tables, interpolated at layer phi)
_K_SAND_PHI = np.array([20.0, 25.0, 30.0, 35.0, 40.0])       # deg
_K_SAND_MN3 = np.array([2.0, 5.4, 11.0, 22.0, 45.0])         # MN/m^3
_NQ_PHI = np.array([20.0, 25.0, 30.0, 35.0, 40.0])
_NQ = np.array([12.0, 20.0, 40.0, 50.0, 100.0])

# API t-z (clay) and Q-z piecewise curves, normalized (z/D, t/t_max)
_TZ_CLAY_Z = np.array([0.0, 0.0016, 0.0031, 0.0057, 0.0080, 0.0100,
                       0.0200, 1.0])
_TZ_CLAY_T = np.array([0.0, 0.30, 0.50, 0.75, 0.90, 1.00, 0.90, 0.90])
_QZ_Z = np.array([0.0, 0.002, 0.013, 0.042, 0.073, 0.100, 1.0])
_QZ_Q = np.array([0.0, 0.25, 0.50, 0.75, 0.90, 1.00, 1.00])
# odd extension of the clay t-z table so dt/du is positive AT u = 0
_TZ_CLAY_Z_ODD = np.concatenate([-_TZ_CLAY_Z[:0:-1], _TZ_CLAY_Z])
_TZ_CLAY_T_ODD = np.concatenate([-_TZ_CLAY_T[:0:-1], _TZ_CLAY_T])

_SAND_PEAK_M = 0.00254    # sand t-z peak displacement (2.54 mm)
_CLAY_R0 = 1e-3           # clay p-y: linear core below |y| / y_50 = r0


@dataclasses.dataclass(frozen=True)
class SoilLayer:
    """One soil layer, ``z_top <= z < z_bot`` in metres below mudline.

    ``kind``: 'sand' (phi_deg, gamma_kN_m3, optional k_MN_m3 override),
    'clay' (su_kPa, gamma_kN_m3, eps50, J) or 'linear' (Es_MPa lateral
    modulus, ks_MPa skin modulus, ktip_MN_m tip spring).
    """

    kind: str
    z_top: float
    z_bot: float
    gamma_kN_m3: float = 10.0     # effective (submerged) unit weight
    phi_deg: float = 30.0         # sand friction angle
    k_MN_m3: float | None = None  # sand initial modulus gradient override
    su_kPa: float = 50.0          # clay undrained shear strength
    eps50: float = 0.01           # clay strain at half ultimate
    J: float = 0.5                # Matlock empirical constant
    Es_MPa: float | None = None   # linear lateral modulus (p = Es y)
    ks_MPa: float | None = None   # linear skin modulus (t' = ks u)
    ktip_MN_m: float = 0.0        # linear tip spring

    def __post_init__(self):
        if self.kind not in ("sand", "clay", "linear"):
            raise ValueError("SoilLayer kind must be 'sand', 'clay' or "
                             f"'linear' (got {self.kind!r})")
        if self.z_bot <= self.z_top:
            raise ValueError("SoilLayer needs z_bot > z_top")
        if self.kind == "linear" and self.Es_MPa is None:
            raise ValueError("linear SoilLayer needs Es_MPa")


@dataclasses.dataclass(frozen=True)
class Pile:
    """Tubular pile below the mudline (the jacket model owns any stickup)."""

    D_mm: float
    t_mm: float
    L_m: float
    E_MPa: float = 210000.0
    nu: float = 0.3
    n_elem: int = 64
    plugged: bool = True

    def __post_init__(self):
        if self.L_m <= 0 or self.D_mm <= 0 or self.t_mm <= 0:
            raise ValueError("Pile needs positive D_mm, t_mm, L_m")
        if self.n_elem < 4:
            raise ValueError("Pile needs n_elem >= 4")


def _sand_C123(phi_deg):
    """Reese-Cox-Koop wedge/flow coefficients (API RP 2A commentary);
    phi = 30 deg gives C1 ~ 1.9, C2 ~ 2.7, C3 ~ 28."""
    phi = np.deg2rad(phi_deg)
    a = phi / 2.0
    b = np.deg2rad(45.0) + phi / 2.0
    K0, Ka = 0.4, np.tan(np.deg2rad(45.0) - phi / 2.0) ** 2
    C1 = (np.tan(b) ** 2 * np.tan(a) / np.tan(b - phi)
          + K0 * (np.tan(phi) * np.sin(b) / (np.cos(a) * np.tan(b - phi))
                  + np.tan(b) * (np.tan(phi) * np.sin(b) - np.tan(a))))
    C2 = np.tan(b) / np.tan(b - phi) - Ka
    C3 = Ka * (np.tan(b) ** 8 - 1.0) + K0 * np.tan(phi) * np.tan(b) ** 4
    return C1, C2, C3


def _layer_at(soil: Sequence[SoilLayer], z: np.ndarray) -> list[SoilLayer]:
    """The layer owning each depth (last layer extends to the pile tip)."""
    out = []
    for zi in z:
        hit = None
        for lay in soil:
            if lay.z_top <= zi < lay.z_bot:
                hit = lay
                break
        out.append(hit if hit is not None else soil[-1])
    return out


def _overburden(soil: Sequence[SoilLayer], z: np.ndarray) -> np.ndarray:
    """Effective vertical stress sigma'_v [Pa] at each depth."""
    sig = np.zeros_like(z)
    deepest = max(lay.z_bot for lay in soil)
    for i, zi in enumerate(z):
        s = 0.0
        for lay in soil:
            lo = max(lay.z_top, 0.0)
            hi = min(lay.z_bot, zi)
            if hi > lo:
                s += lay.gamma_kN_m3 * 1e3 * (hi - lo)
        # depth beyond the last layer: extend the deepest layer
        if zi > deepest:
            s += soil[-1].gamma_kN_m3 * 1e3 * (zi - deepest)
        sig[i] = s
    return sig


def _scoured_overburden(soil, z: np.ndarray, scour_m: float) -> np.ndarray:
    """sigma'_v measured from the scoured mudline, floored at 0."""
    return np.maximum(_overburden(soil, z)
                      - _overburden(soil, np.full_like(z, scour_m)), 0.0)


class _LateralParams(NamedTuple):
    """Per-node p-y parameters (SI, float64 on one device)."""

    kind: torch.Tensor    # int32: 0 sand, 1 clay, 2 linear
    pu: torch.Tensor      # ultimate resistance [N/m] (sand: A pu)
    c1: torch.Tensor      # clay: y50 [m] | linear: Es [Pa]
    c2: torch.Tensor      # sand: k z [N/m^2]


def _lateral_params(pile: Pile, soil: Sequence[SoilLayer], z: np.ndarray,
                    scour_m: float = 0.0, device=None) -> _LateralParams:
    """Per-node p-y parameters on ``device`` (``None``: the card).

    Depth-strength products use the integrated overburden sigma'_v and
    the depth below the SCOURED mudline (``z - scour_m``); nodes inside
    the scour hole carry no soil; the layer stays the survey depth's.
    """
    D = pile.D_mm / 1000.0
    layers = _layer_at(soil, z)
    sig = _scoured_overburden(soil, z, scour_m)
    z_eff = z - scour_m
    kind = np.zeros(len(z), np.int32)
    pu = np.zeros(len(z))
    c1 = np.zeros(len(z))
    c2 = np.zeros(len(z))
    for i, (zi, lay) in enumerate(zip(z_eff, layers)):
        if lay.kind == "sand":
            kind[i] = 0
            if zi < 0.0:
                continue                                  # scoured away
            C1, C2, C3 = _sand_C123(lay.phi_deg)
            pu_i = min((C1 * zi + C2 * D) * sig[i], C3 * D * sig[i])
            A = max(3.0 - 0.8 * zi / D, 0.9)
            k = (lay.k_MN_m3 if lay.k_MN_m3 is not None
                 else float(np.interp(lay.phi_deg, _K_SAND_PHI,
                                      _K_SAND_MN3))) * 1e6   # N/m^3
            pu[i] = A * pu_i
            c2[i] = k * zi
        elif lay.kind == "clay":
            kind[i] = 1
            if zi < 0.0:
                continue
            su = lay.su_kPa * 1e3
            pu[i] = min(3.0 + sig[i] / su + lay.J * zi / D, 9.0) * su * D
            c1[i] = 2.5 * lay.eps50 * D                   # y50 [m]
        else:
            kind[i] = 2
            c1[i] = lay.Es_MPa * 1e6 if zi >= 0.0 else 0.0  # Pa
    device = resolve_device(device)
    return _LateralParams(torch.as_tensor(kind, device=device),
                          *(torch.as_tensor(a, dtype=F64, device=device)
                            for a in (pu, c1, c2)))


def _tie_gate(a: torch.Tensor, b) -> torch.Tensor:
    """d min(a, b) / da as ``jax.grad`` takes it: 1 below, 1/2 at a tie,
    0 above (``maximum`` is the same gate with the arguments swapped)."""
    return torch.where(a < b, 1.0, torch.where(a == b, 0.5, 0.0)).to(a.dtype)


def _clay_core(par: _LateralParams, y: torch.Tensor):
    """(r = y / y50, y50, the linear-core mask) of the clay p-y curve."""
    y50 = torch.where(par.c1 > 0, par.c1, torch.ones_like(par.c1))
    r = y / y50
    return r, y50, torch.abs(r) < _CLAY_R0


def _by_kind(kind, sand, clay, linear):
    return torch.where(kind == 0, sand, torch.where(kind == 1, clay, linear))


def py_resistance(par: _LateralParams, y: torch.Tensor) -> torch.Tensor:
    """Soil resistance p(y) [N/m] per node: odd in y, with a positive
    dp/dy at y = 0 (the Newton iteration starts there).

    sand: A pu tanh(k z y / (A pu)); clay: 0.5 pu (y/y50)^(1/3) capped at
    pu, linear below |y|/y50 = 1e-3; linear: Es y.
    """
    pu_safe = torch.where(par.pu > 0, par.pu, torch.ones_like(par.pu))
    p_sand = torch.where(par.pu > 0, par.pu * torch.tanh(par.c2 * y
                                                         / pu_safe), 0.0)
    r, _, small = _clay_core(par, y)
    r_safe = torch.where(small, _CLAY_R0, r)
    p_pow = torch.sign(r_safe) * torch.clamp(
        0.5 * torch.abs(r_safe) ** (1.0 / 3.0), max=1.0)
    p_clay = par.pu * torch.where(small, 0.5 * _CLAY_R0 ** (-2.0 / 3.0) * r,
                                  p_pow)
    return _by_kind(par.kind, p_sand, p_clay, par.c1 * y)


def py_slope(par: _LateralParams, y: torch.Tensor) -> torch.Tensor:
    """dp/dy of :func:`py_resistance` [N/m^2] per node, the Newton
    tangent (the JAX module's ``jax.grad``, module docstring)."""
    pu_safe = torch.where(par.pu > 0, par.pu, torch.ones_like(par.pu))
    th = torch.tanh(par.c2 * y / pu_safe)
    g = par.c2 / pu_safe
    d_sand = torch.where(par.pu > 0, par.pu * ((g + g * th) * (1.0 - th)),
                         0.0)
    r, y50, small = _clay_core(par, y)
    r_safe = torch.where(small, _CLAY_R0, r)
    a = torch.abs(r_safe)
    cube = 0.5 * a ** (1.0 / 3.0)
    d_pow = 0.5 * ((1.0 / 3.0) * a ** (1.0 / 3.0 - 1.0)) * _tie_gate(cube,
                                                                      1.0)
    d_clay = par.pu * torch.where(small, 0.5 * _CLAY_R0 ** (-2.0 / 3.0),
                                  d_pow) / y50
    return _by_kind(par.kind, d_sand, d_clay, par.c1)


def _beam_matrix(EI: float, L: float, n: int) -> np.ndarray:
    """[2(n+1) x 2(n+1)] Euler-Bernoulli lateral stiffness, DOFs (y, th)."""
    le = L / n
    k = EI / le**3 * np.array([
        [12.0, 6 * le, -12.0, 6 * le],
        [6 * le, 4 * le**2, -6 * le, 2 * le**2],
        [-12.0, -6 * le, 12.0, -6 * le],
        [6 * le, 2 * le**2, -6 * le, 4 * le**2]])
    K = np.zeros((2 * (n + 1), 2 * (n + 1)))
    for e in range(n):
        K[2 * e:2 * e + 4, 2 * e:2 * e + 4] += k
    return K


def _rod_matrix(EA: float, L: float, n: int) -> np.ndarray:
    le = L / n
    K = np.zeros((n + 1, n + 1))
    for e in range(n):
        K[e:e + 2, e:e + 2] += EA / le * np.array([[1.0, -1.0], [-1.0, 1.0]])
    return K


def _trib(L: float, n: int) -> np.ndarray:
    trib = np.full(n + 1, L / n)
    trib[0] = trib[-1] = L / (2 * n)
    return trib


class PileSolve(NamedTuple):
    """Converged Winkler solution (SI units)."""

    u: torch.Tensor          # lateral: [2(n+1)] (y, th) | axial: [n+1]
    residual: torch.Tensor   # |R| / (|F| + 1) at the last Newton step
    z: np.ndarray            # node depths [m]


def _newton(K: torch.Tensor, F: torch.Tensor, soil_force, soil_tangent,
            n_iter: int = 60):
    """Newton on R(u) = K u + f_soil(u) - F from u = 0, ``n_iter`` steps
    (f64, on K's device).  The tangent K + diag(df/du) need not be SPD
    (plastic plateaus zero the soil diagonal), so each step is an LU
    solve; a singular tangent gives non-finite iterates, as in JAX,
    instead of an error (``solve_ex``: no host read of the LU's status,
    so the card is not synchronised every step)."""
    u = torch.zeros_like(F)
    for _ in range(n_iter):
        R = K @ u + soil_force(u) - F
        u = u - torch.linalg.solve_ex(K + torch.diag(soil_tangent(u)), R)[0]
    R = K @ u + soil_force(u) - F
    return u, torch.linalg.norm(R) / (torch.linalg.norm(F) + 1.0)


def _tube(pile: Pile):
    """(D, Di) [m]: outer and inner diameters."""
    return pile.D_mm / 1000.0, (pile.D_mm - 2 * pile.t_mm) / 1000.0


def lateral_solve(pile: Pile, soil: Sequence[SoilLayer], H_N: float,
                  M_Nm: float = 0.0, n_iter: int = 60,
                  scour_m: float = 0.0, device=None) -> PileSolve:
    """Laterally loaded pile: head shear ``H_N`` [N] and moment ``M_Nm``
    [N m] at the (original) mudline; returns nodal (y [m], theta [rad]).
    ``scour_m``: general scour depth (the top metres carry no soil, depth
    and overburden terms are measured from the scoured surface).
    ``device``: where the Newton iteration runs (``None``: the card)."""
    device = resolve_device(device)
    n = pile.n_elem
    D, Di = _tube(pile)
    EI = pile.E_MPa * 1e6 * np.pi / 64.0 * (D**4 - Di**4)
    z = np.linspace(0.0, pile.L_m, n + 1)
    par = _lateral_params(pile, soil, z, scour_m=scour_m, device=device)
    trib = torch.as_tensor(_trib(pile.L_m, n), dtype=F64, device=device)
    K = torch.as_tensor(_beam_matrix(EI, pile.L_m, n), dtype=F64,
                        device=device)
    F = torch.zeros(2 * (n + 1), dtype=F64, device=device)
    F[0], F[1] = H_N, M_Nm

    def soil_force(u):
        f = torch.zeros_like(u)
        f[0::2] = py_resistance(par, u[0::2]) * trib
        return f

    def soil_tangent(u):
        d = torch.zeros_like(u)
        d[0::2] = py_slope(par, u[0::2]) * trib
        return d

    u, res = _newton(K, F, soil_force, soil_tangent, n_iter=n_iter)
    return PileSolve(u=u, residual=res, z=z)


class _AxialParams(NamedTuple):
    kind: torch.Tensor    # 0 sand, 1 clay, 2 linear
    tmax: torch.Tensor    # ultimate shaft transfer per length [N/m]
    scale: torch.Tensor   # clay: D | sand: z_peak | linear: ks


def _axial_params(pile: Pile, soil: Sequence[SoilLayer], z: np.ndarray,
                  scour_m: float = 0.0,
                  device=None) -> tuple[_AxialParams, float, float]:
    """Per-node t-z parameters on ``device`` + (Q_max [N], D [m]); scour
    removes skin in the hole and reduces the overburden below it."""
    D = pile.D_mm / 1000.0
    circ = np.pi * D
    layers = _layer_at(soil, z)
    sig = _scoured_overburden(soil, z, scour_m)
    z_eff = z - scour_m
    kind = np.zeros(len(z), np.int32)
    tmax = np.zeros(len(z))
    scale = np.zeros(len(z))
    for i, (zi, lay) in enumerate(zip(z_eff, layers)):
        if lay.kind == "sand":
            kind[i] = 0
            if zi < 0.0:
                continue
            delta = np.deg2rad(max(lay.phi_deg - 5.0, 5.0))
            tmax[i] = 0.8 * sig[i] * np.tan(delta) * circ
            scale[i] = _SAND_PEAK_M
        elif lay.kind == "clay":
            kind[i] = 1
            if zi < 0.0:
                continue
            su = lay.su_kPa * 1e3
            psi = su / max(sig[i], 1.0)
            alpha = min(0.5 * psi**-0.5 if psi <= 1.0 else 0.5 * psi**-0.25,
                        1.0)
            tmax[i] = alpha * su * circ
            scale[i] = D
        else:
            kind[i] = 2
            scale[i] = ((lay.ks_MPa or 0.0) * 1e6 if zi >= 0.0
                        else 0.0)                     # N/m per m
    tip = layers[-1]
    if pile.plugged:
        A_tip = np.pi / 4.0 * D**2
    else:
        A_tip = np.pi / 4.0 * (D**2 - _tube(pile)[1] ** 2)
    if tip.kind == "clay":
        Q_max = 9.0 * tip.su_kPa * 1e3 * A_tip
    elif tip.kind == "sand":
        Nq = float(np.interp(tip.phi_deg, _NQ_PHI, _NQ))
        Q_max = Nq * sig[-1] * A_tip
    else:
        Q_max = 0.0
    device = resolve_device(device)
    return (_AxialParams(torch.as_tensor(kind, device=device),
                         *(torch.as_tensor(a, dtype=F64, device=device)
                           for a in (tmax, scale))), Q_max, D)


def _tz_ratio(par: _AxialParams, u: torch.Tensor):
    """(u / 2.54 mm, u / clay scale, the clay scale guarded from 0)."""
    scale = torch.where(par.scale > 0, par.scale, torch.ones_like(par.scale))
    return u / _SAND_PEAK_M, u / scale, scale


def tz_resistance(par: _AxialParams, u: torch.Tensor) -> torch.Tensor:
    """Shaft transfer t(u) [N/m] per node: odd in u, with a positive
    dt/du at u = 0 (the Newton requirement of :func:`py_resistance`)."""
    s, r, _ = _tz_ratio(par, u)
    t_sand = par.tmax * torch.clamp(s, -1.0, 1.0)
    t_clay = par.tmax * interp(r, _TZ_CLAY_Z_ODD, _TZ_CLAY_T_ODD)
    return _by_kind(par.kind, t_sand, t_clay, par.scale * u)


def tz_slope(par: _AxialParams, u: torch.Tensor) -> torch.Tensor:
    """dt/du of :func:`tz_resistance` [N/m^2] per node (the JAX module's
    ``jax.grad``: ``clip`` is ``minimum(maximum(x, -1), 1)``, a tie
    weighs 1/2)."""
    s, r, scale = _tz_ratio(par, u)
    gate = _tie_gate(-1.0 * torch.ones_like(s), s) * _tie_gate(
        torch.clamp(s, min=-1.0), 1.0)
    d_sand = par.tmax * (gate / _SAND_PEAK_M)
    d_clay = par.tmax * interp_slope(r, _TZ_CLAY_Z_ODD, _TZ_CLAY_T_ODD) \
        / scale
    return _by_kind(par.kind, d_sand, d_clay, par.scale)


def axial_solve(pile: Pile, soil: Sequence[SoilLayer], V_N: float,
                n_iter: int = 60, scour_m: float = 0.0,
                device=None) -> PileSolve:
    """Axially loaded pile (positive ``V_N`` = compression, head settles
    +u); nonlinear t-z shaft + Q-z tip; ``scour_m`` and ``device`` as
    :func:`lateral_solve`."""
    device = resolve_device(device)
    n = pile.n_elem
    D, Di = _tube(pile)
    EA = pile.E_MPa * 1e6 * np.pi / 4.0 * (D**2 - Di**2)
    z = np.linspace(0.0, pile.L_m, n + 1)
    par, Q_max, _ = _axial_params(pile, soil, z, scour_m=scour_m,
                                  device=device)
    trib = torch.as_tensor(_trib(pile.L_m, n), dtype=F64, device=device)
    tip_lay = _layer_at(soil, np.array([pile.L_m]))[0]
    ktip_lin = ((tip_lay.ktip_MN_m or 0.0) * 1e6
                if tip_lay.kind == "linear" else 0.0)
    K = torch.as_tensor(_rod_matrix(EA, pile.L_m, n), dtype=F64,
                        device=device)
    F = torch.zeros(n + 1, dtype=F64, device=device)
    F[0] = V_N

    def tip(ut):
        """(tip force, its slope): the Q-z curve resists compression
        (u > 0) only; ``maximum(u, 0)`` weighs u = 0 by 1/2."""
        if Q_max > 0.0:
            x = torch.clamp(ut, min=0.0) / D
            gate = _tie_gate(torch.zeros_like(ut), ut)
            return (Q_max * interp(x, _QZ_Z, _QZ_Q),
                    Q_max * (interp_slope(x, _QZ_Z, _QZ_Q) * (gate / D)))
        return ktip_lin * ut, torch.full_like(ut, ktip_lin)

    def soil_force(u):
        f = tz_resistance(par, u) * trib
        f[-1] = f[-1] + tip(u[-1])[0]
        return f

    def soil_tangent(u):
        d = tz_slope(par, u) * trib
        d[-1] = d[-1] + tip(u[-1])[1]
        return d

    u, res = _newton(K, F, soil_force, soil_tangent, n_iter=n_iter)
    return PileSolve(u=u, residual=res, z=z)


class PileHeadStiffness(NamedTuple):
    """Secant pile-head springs at the working loads (host numpy)."""

    support_stiffness: np.ndarray   # [6] N/mm & N*mm/rad (diagonal secants)
    K_lateral_2x2: np.ndarray       # [[H/y, H/th],[M/y, M/th]] secant info
    y_head_mm: float                # lateral head deflection at H_work
    theta_head_rad: float
    u_head_mm: float                # axial settlement at V_work
    residuals: np.ndarray           # [3] Newton residuals (H, M, V solves)


def pile_head_stiffness(pile: Pile, soil: Sequence[SoilLayer],
                        H_kN: float = 100.0, V_kN: float = 1000.0,
                        M_kNm: float = 0.0, scour_m: float = 0.0,
                        device=None) -> PileHeadStiffness:
    """Uncoupled secant pile-head springs at the given working loads.

    Three nonlinear solves on ``device`` (``None``: the card): H alone, M
    alone (``M_kNm`` <= 0: the probe moment H min(5 D, L / 4)), V alone,
    give ``k = load / head displacement``; torsion comes from the elastic
    axial analogy.  Feed ``support_stiffness`` to ``analyze_ssi`` (or use
    :func:`soil_support_stiffness` for per-support working loads).
    """
    if H_kN <= 0 or V_kN <= 0:
        raise ValueError("pile_head_stiffness needs H_kN > 0 and V_kN > 0 "
                         "working loads (probe with small values if unknown)")
    device = resolve_device(device)
    H = H_kN * 1e3
    V = V_kN * 1e3
    lat_H = lateral_solve(pile, soil, H, 0.0, scour_m=scour_m, device=device)
    M = (H * min(5.0 * pile.D_mm / 1000.0, pile.L_m / 4.0) if M_kNm <= 0.0
         else M_kNm * 1e3)
    lat_M = lateral_solve(pile, soil, 0.0, M, scour_m=scour_m, device=device)
    ax = axial_solve(pile, soil, V, scour_m=scour_m, device=device)
    y0, th_H = (float(v) for v in lat_H.u[:2])
    yM, th0 = (float(v) for v in lat_M.u[:2])
    u0 = float(ax.u[0])

    ky = H / max(abs(y0), 1e-12)                       # N/m
    krot = M / max(abs(th0), 1e-12)                    # N m/rad
    kz = V / max(abs(u0), 1e-12)                       # N/m

    # torsion: elastic shaft with distributed skin stiffness s0 R^2
    D, Di = _tube(pile)
    G = pile.E_MPa * 1e6 / (2.0 * (1.0 + pile.nu))
    J = np.pi / 32.0 * (D**4 - Di**4)
    z = np.linspace(0.0, pile.L_m, pile.n_elem + 1)
    par, _, _ = _axial_params(pile, soil, z, scour_m=scour_m, device=device)
    u_probe = 0.001
    s0 = tz_resistance(par, torch.full((len(z),), u_probe, dtype=F64,
                                       device=device)).cpu().numpy() / u_probe
    k_theta = float(np.mean(s0)) * (D / 2.0) ** 2      # N m/rad per m
    if k_theta > 0:
        mu = np.sqrt(k_theta / (G * J))
        kt = np.sqrt(G * J * k_theta) * np.tanh(mu * pile.L_m)
    else:
        kt = G * J / pile.L_m
    ks = np.array([ky / 1e3, ky / 1e3, kz / 1e3,       # N/m -> N/mm
                   krot * 1e3, krot * 1e3, kt * 1e3])  # N m -> N mm
    K2 = np.array([[H / max(abs(y0), 1e-12), H / max(abs(th_H), 1e-12)],
                   [M / max(abs(yM), 1e-12), M / max(abs(th0), 1e-12)]])
    return PileHeadStiffness(
        support_stiffness=ks, K_lateral_2x2=K2,
        y_head_mm=y0 * 1e3, theta_head_rad=th0, u_head_mm=u0 * 1e3,
        residuals=np.array([float(lat_H.residual), float(lat_M.residual),
                            float(ax.residual)]))


def soil_support_stiffness(model, soil: Sequence[SoilLayer], pile: Pile,
                           reactions=None,
                           scour_m: float = 0.0) -> np.ndarray:
    """Per-support [n_fixed, 6] springs from per-support working loads,
    solved on the model's device.

    ``reactions``: the clamped analysis' ``results.reactions`` (N / N*mm on
    the fixed nodes): each support's pile is solved at its own working
    shear, axial force and moment; ``None`` uses one shared 100 kN /
    1000 kN probe.  The workflow: clamped ``analyze`` -> this ->
    ``analyze_ssi`` (one round is usually enough; iterate for soft soils).
    """
    fixed = np.where(model.fixed_mask.cpu().numpy())[0]
    R_all = (None if reactions is None else
             np.asarray(torch.as_tensor(reactions).cpu()).reshape(-1, 6))
    out = np.zeros((fixed.size, 6))
    for i in range(fixed.size):
        if R_all is None:
            H_kN, V_kN, M_kNm = 100.0, 1000.0, 0.0
        else:
            R = R_all[i]
            H_kN = max(float(np.hypot(R[0], R[1])) / 1e3, 10.0)
            V_kN = max(abs(float(R[2])) / 1e3, 100.0)
            M_kNm = max(float(np.hypot(R[3], R[4])) / 1e6, 0.0)
        out[i] = pile_head_stiffness(
            pile, soil, H_kN=H_kN, V_kN=V_kN,
            M_kNm=M_kNm if M_kNm > 1.0 else 0.0, scour_m=scour_m,
            device=model.device).support_stiffness
    return out
