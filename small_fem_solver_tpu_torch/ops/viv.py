"""Vortex-induced vibration (VIV) susceptibility screening (PyTorch
counterpart of ``small_fem_solver_tpu/ops/viv.py``).

The screen an offshore engineer runs before a detailed VIV fatigue
assessment, elementwise over all members:

1. first bending frequency of each span as a uniform beam, f_n =
   (lambda_1^2 / 2 pi L^2) sqrt(EI / m_e), clamped-clamped (lambda_1^2 =
   22.373) or pinned (pi^2); m_e = steel + internal water of flooded
   members + added mass Ca rho_w pi D^2 / 4 of submerged ones;
2. reduced velocity V_r = U / (f_n D) with the current at the member's
   midpoint depth (uniform or power law);
3. stability parameter K_s = 2 m_e delta / (rho_w D^2), delta = 2 pi
   zeta.

Onset (DNV-RP-C205 section 9 screening values): in-line when V_r >= 1.0
and K_s <= 1.8, cross-flow when V_r >= 3.5 and K_s <= 16; the reported
utilizations are V_r / onset (0 when suppressed or dry).  Wave-induced
and wind VIV are out of scope.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# first-mode frequency coefficients lambda_1^2 for a uniform beam span
_LAMBDA1_SQ = {"fixed": 4.730040744862704**2, "pinned": float(np.pi**2)}

# screening onset values (DNV-CN 30.5 / RP-C205 sec. 9)
VR_ONSET_INLINE = 1.0
VR_ONSET_CROSSFLOW = 3.5
KS_SUPPRESS_INLINE = 1.8
KS_SUPPRESS_CROSSFLOW = 16.0


class VIVScreen(NamedTuple):
    """Per-member VIV screening results (all arrays ``[M]``)."""

    f_n_hz: torch.Tensor       # first-mode natural frequency of the span
    m_e_kg_m: torch.Tensor     # effective mass per unit length
    U_ms: torch.Tensor         # current speed at the member midpoint (0 dry)
    V_r: torch.Tensor          # reduced velocity U / (f_n D)
    K_s: torch.Tensor          # stability parameter 2 m_e delta / (rho D^2)
    uc_inline: torch.Tensor    # V_r / 1.0, 0 when suppressed (K_s) or dry
    uc_crossflow: torch.Tensor  # V_r / 3.5, 0 when suppressed or dry
    submerged: torch.Tensor    # bool: midpoint below MWL
    flags: np.ndarray          # str: 'ok' | 'inline' | 'crossflow' | 'both'


def viv_screen(model, U_c, d, rho_water=1025.0, zeta: float = 0.01,
               Ca: float = 1.0, current_alpha=None,
               marine_growth_mm: float = 0.0, flooded: str = "none",
               E: float = 210000.0, end_fixity: str = "fixed") -> VIVScreen:
    """Current-induced VIV susceptibility of every member, on the model's
    device.

    ``model``: the COARSE model (spans are the node-to-node framing
    lengths; a refined mesh would shorten them); ``U_c``: surface current
    [m/s]; ``d``: water depth [m]; ``current_alpha``: power-law exponent
    of U(z) = U_c ((z + d) / d)^a (None: uniform); ``zeta``: structural
    damping ratio; ``Ca``: added-mass coefficient; ``flooded``: 'none' |
    'legs' | 'all'; ``end_fixity``: 'fixed' (welded) or 'pinned'
    (conservative).
    """
    if end_fixity not in _LAMBDA1_SQ:
        raise ValueError("end_fixity must be 'fixed' or 'pinned' "
                         f"(got {end_fixity!r})")
    if flooded not in ("none", "legs", "all"):
        raise ValueError("flooded must be 'none', 'legs' or 'all' "
                         f"(got {flooded!r})")
    lam2 = _LAMBDA1_SQ[end_fixity]
    sec, sid = model.sections, model.sect_id
    dtype, device = model.dtype, model.device

    c1 = model.coords[model.conn[:, 0]]
    c2 = model.coords[model.conn[:, 1]]
    L = torch.linalg.norm(c2 - c1, dim=-1)                   # [M] m
    z_mid = 0.5 * (c1[:, 2] + c2[:, 2])                      # m, MWL at 0
    submerged = z_mid < 0.0

    D_h = (sec.D_outer[sid] + 2.0 * marine_growth_mm) / 1000.0
    D_i = sec.D_inner[sid] / 1000.0
    if flooded == "legs":
        flooded_m = torch.tensor([ty == "leg" for ty in model.member_types],
                                 device=device)
    else:
        flooded_m = torch.full((model.n_members,), flooded == "all",
                               device=device)
    m_fluid = torch.where(flooded_m & submerged,
                          rho_water * math.pi * D_i**2 / 4.0, 0.0)
    m_added = torch.where(submerged,
                          Ca * rho_water * math.pi * D_h**2 / 4.0, 0.0)
    m_e = sec.mass_per_m[sid] + m_fluid + m_added           # kg/m

    # EI in SI: E [MPa] * I [mm^4] = N mm^2 -> * 1e-6 N m^2
    EI = torch.as_tensor(E, dtype=dtype, device=device) * sec.Iy[sid] * 1e-6
    f_n = lam2 / (2.0 * math.pi * L**2) * torch.sqrt(EI / m_e)  # Hz

    U_c = torch.as_tensor(U_c, dtype=dtype, device=device)
    if current_alpha is None:
        U = torch.where(submerged, U_c, 0.0)
    else:
        frac = torch.clamp((z_mid + d) / d, 0.0, 1.0)
        U = torch.where(submerged, U_c * frac**current_alpha, 0.0)

    V_r = U / (f_n * D_h)
    K_s = 2.0 * m_e * (2.0 * math.pi * zeta) / (rho_water * D_h**2)
    uc_il = torch.where((K_s <= KS_SUPPRESS_INLINE) & submerged,
                        V_r / VR_ONSET_INLINE, 0.0)
    uc_cf = torch.where((K_s <= KS_SUPPRESS_CROSSFLOW) & submerged,
                        V_r / VR_ONSET_CROSSFLOW, 0.0)
    il = (uc_il >= 1.0).cpu().numpy()
    cf = (uc_cf >= 1.0).cpu().numpy()
    flags = np.where(il & cf, "both",
                     np.where(cf, "crossflow", np.where(il, "inline", "ok")))
    return VIVScreen(f_n_hz=f_n, m_e_kg_m=m_e, U_ms=U, V_r=V_r, K_s=K_s,
                     uc_inline=uc_il, uc_crossflow=uc_cf,
                     submerged=submerged, flags=flags)
