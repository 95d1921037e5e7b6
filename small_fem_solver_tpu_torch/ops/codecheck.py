"""API RP 2A-WSD cylindrical-member strength checks, working stress
(PyTorch counterpart of ``small_fem_solver_tpu/ops/codecheck.py``).

API RP 2A-WSD (21st ed., sections 3.2 / 3.3) member unity checks,
elementwise over all members from the end forces an analysis recovers:

- tension: ft/Ft + fb/Fb; compression: fa/Fa + Cm fb / ((1 - fa/Fe') Fb)
  (3.3.1-1) and fa/(0.6 Fy) + fb/Fb (3.3.1-2), the simple sum fa/Fa +
  fb/Fb when fa/Fa <= 0.15 (3.3.1-3);
- Ft = 0.6 Fy (3.2.1); Fa by the AISC column curve (3.2.2) on the
  local-buckling yield Fxc for D/t > 60; Fb in the three D/t ranges of
  3.2.3.

Hydrostatic collapse, punching shear (``ops/jointcheck.py``) and shear
checks are not here.  Stresses in MPa; fb is the resultant bending stress
at the more-stressed end; effective-length factors legs 1.0, braces 0.8;
Cm = 0.85.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _as(x, ref=None) -> torch.Tensor:
    if torch.is_tensor(x):
        return x
    if ref is not None:
        return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)
    return torch.as_tensor(x, dtype=torch.float64)


def allowable_tension(Fy):
    """Ft = 0.6 Fy (API RP 2A-WSD 3.2.1-1)."""
    return 0.6 * _as(Fy)


def local_buckling_fxc(Fy, E, D_over_t):
    """Local-buckling-reduced axial yield Fxc (3.2.2-3/4): Fy for D/t <=
    60, else Fy [1.64 - 0.23 (D/t)^0.25] capped by Fxe = 2 (0.3) E t/D
    and Fy."""
    dt = _as(D_over_t)
    Fy = _as(Fy, dt)
    Fxe = 2.0 * 0.3 * E / dt
    Fxc_inel = Fy * (1.64 - 0.23 * dt**0.25)
    Fxc = torch.minimum(torch.minimum(Fxc_inel, Fxe), Fy)
    return torch.where(dt <= 60.0, Fy, Fxc)


def allowable_compression(Fy, E, KL_over_r, D_over_t):
    """Fa by the AISC/API column curve (3.2.2-1/2) on the local-buckling
    yield Fxc."""
    Fxc = local_buckling_fxc(Fy, E, D_over_t)
    lam = _as(KL_over_r, Fxc)
    Cc = torch.sqrt(2.0 * math.pi**2 * E / Fxc)
    r = lam / Cc
    Fa_inel = (1.0 - 0.5 * r**2) * Fxc / (
        5.0 / 3.0 + 3.0 * r / 8.0 - r**3 / 8.0)
    Fa_el = 12.0 * math.pi**2 * E / (23.0 * lam**2)
    return torch.where(lam < Cc, Fa_inel, Fa_el)


def allowable_bending(Fy, E, D_over_t):
    """Fb in the three D/t ranges of 3.2.3 (SI units, Fy in MPa)."""
    dt = _as(D_over_t)
    Fy = _as(Fy, dt)
    lim1 = 10340.0 / Fy
    lim2 = 20680.0 / Fy
    Fb1 = 0.75 * Fy
    Fb2 = (0.84 - 1.74 * Fy * dt / E) * Fy
    Fb3 = (0.72 - 0.58 * Fy * dt / E) * Fy
    return torch.where(dt <= lim1, Fb1, torch.where(dt <= lim2, Fb2, Fb3))


class CodeCheck(NamedTuple):
    """API RP 2A-WSD member unity checks (all [M] unless noted)."""

    uc: torch.Tensor              # governing unity check per member
    uc_stability: torch.Tensor    # 3.3.1-1 (or the tension interaction)
    uc_yield: torch.Tensor        # 3.3.1-2 (compression) / same (tension)
    fa_mpa: torch.Tensor          # axial stress (+compression)
    fb_mpa: torch.Tensor          # resultant bending stress (worst end)
    Fa_mpa: torch.Tensor          # allowable axial (tension or compression)
    Fb_mpa: torch.Tensor          # allowable bending
    KL_over_r: torch.Tensor       # slenderness used
    governing: np.ndarray         # [M] str: 'tension' | 'stability' | 'yield'


def member_slenderness(model, results, K_leg: float, K_brace: float,
                       L_override=None):
    """(A, W, D, t, KL/r) per member: section data and the slenderness
    with K by member type (legs ``K_leg``, the rest ``K_brace``) on the
    results' member lengths or ``L_override`` [m]."""
    sec, sid = model.sections, model.sect_id
    A = sec.Ax[sid]                          # mm^2
    r_gyr = torch.sqrt(sec.Iy[sid] / A)      # mm
    L_m = results.length_m if L_override is None else _as(L_override, A)
    K = torch.tensor([K_leg if ty == "leg" else K_brace
                      for ty in model.member_types], dtype=A.dtype,
                     device=A.device)
    return A, sec.Wy[sid], sec.D_outer[sid], sec.t[sid], \
        K * (L_m * 1000.0) / r_gyr


def member_code_check(model, results, Fy=None, E=None,
                      K_leg: float = 1.0, K_brace: float = 0.8,
                      Cm: float = 0.85, L_override=None) -> CodeCheck:
    """API RP 2A-WSD strength unity checks from an analysis result (its
    ``F1_local`` / ``F2_local``; run at the governing phase), on the
    results' device.  ``Fy`` / ``E`` default to 355 / 210000 MPa;
    ``K_leg`` / ``K_brace``: effective-length factors; ``L_override``:
    member lengths [m] to use instead.  The axial force in member
    convention is N = -F1[0] (+ compression; node-1 forces are negated).
    """
    A, W, D, t, KL_r = member_slenderness(model, results, K_leg, K_brace,
                                          L_override)
    Fy = _as(355.0 if Fy is None else Fy, A)
    E = _as(210000.0 if E is None else E, A)
    dt = D / t

    # stresses from the worse member end (N, N*mm -> MPa)
    F1, F2 = results.F1_local, results.F2_local
    N1 = -F1[:, 0]                           # +compression
    N2 = F2[:, 0]
    fa = torch.where(torch.abs(N1) >= torch.abs(N2), N1, N2) / A
    fb = torch.maximum(torch.sqrt(F1[:, 4]**2 + F1[:, 5]**2) / W,
                       torch.sqrt(F2[:, 4]**2 + F2[:, 5]**2) / W)

    Ft = allowable_tension(Fy)
    Fa = allowable_compression(Fy, E, KL_r, dt)
    Fb = allowable_bending(Fy, E, dt)
    # Euler stress of the amplification term (12/23 safety, 3.3.1-4)
    Fe = 12.0 * math.pi**2 * E / (23.0 * KL_r**2)

    comp = fa > 0.0
    fa_c = torch.abs(fa)
    # compression interaction (3.3.1-1/2/3)
    amp = torch.clamp(1.0 - fa_c / Fe, min=1e-3)
    uc1 = fa_c / Fa + Cm * fb / (amp * Fb)
    uc2 = fa_c / (0.6 * Fy) + fb / Fb
    uc_simple = fa_c / Fa + fb / Fb
    small_axial = fa_c / Fa <= 0.15
    uc_stab_c = torch.where(small_axial, uc_simple, torch.maximum(uc1, uc2))
    uc_yield_c = torch.where(small_axial, uc_simple, uc2)
    # tension interaction (3.3.1-2 form)
    uc_t = fa_c / Ft + fb / Fb

    uc_stab = torch.where(comp, uc_stab_c, uc_t)
    uc_yield = torch.where(comp, uc_yield_c, uc_t)
    comp_np = comp.cpu().numpy()
    gov = np.where(comp_np, np.where((uc_stab_c >= uc_yield_c).cpu().numpy(),
                                     "stability", "yield"), "tension")
    return CodeCheck(uc=torch.maximum(uc_stab, uc_yield),
                     uc_stability=uc_stab, uc_yield=uc_yield, fa_mpa=fa,
                     fb_mpa=fb, Fa_mpa=torch.where(comp, Fa, Ft), Fb_mpa=Fb,
                     KL_over_r=KL_r, governing=gov)
