"""ISO 19902 cylindrical-member strength checks, partial-factor format
(PyTorch counterpart of ``small_fem_solver_tpu/ops/codecheck_iso.py``).

ISO 19902:2007 section 13 member checks, elementwise over all members
from the same recovered end forces as :mod:`.codecheck`:

- representative strengths: tension f_t = f_y; local buckling f_yc
  (13.2.3.3, f_xe = 2 C_x E t/D, C_x = 0.3); column f_c (13.2.3.2, lam =
  sqrt(f_yc / f_e)); bending f_b with the plastic shape factor Z_p/Z_e
  (13.2.4);
- interactions with gamma_Rt = 1.05, gamma_Rc = 1.18, gamma_Rb = 1.05:
  tension + bending by the cosine interaction (13.3.2); compression +
  bending as a beam-column with per-plane amplification (13.3.3-1) and
  the local-strength cosine form (13.3.3-2).

Hydrostatic pressure, conical transitions and dented members are not
here.  Per-plane bending stresses from the more-stressed end; K legs 1.0,
braces 0.8; C_m = 0.85 in both planes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .codecheck import _as, member_slenderness

GAMMA_RT = 1.05
GAMMA_RC = 1.18
GAMMA_RB = 1.05


def iso_local_buckling_fyc(Fy, E, D_over_t):
    """Representative local buckling strength f_yc (ISO 19902 13.2.3.3)."""
    dt = _as(D_over_t)
    Fy = _as(Fy, dt)
    fxe = 2.0 * 0.3 * E / dt
    r = Fy / fxe
    fyc_mid = (1.047 - 0.274 * r) * Fy
    return torch.where(r <= 0.170, Fy,
                       torch.where(r <= 1.911, torch.minimum(fyc_mid, Fy),
                                   fxe))


def iso_column_fc(Fy, E, KL_over_r, D_over_t):
    """Representative axial compressive strength f_c (13.2.3.2): (f_c,
    f_yc, f_e)."""
    fyc = iso_local_buckling_fyc(Fy, E, D_over_t)
    fe = math.pi**2 * E / _as(KL_over_r, fyc) ** 2
    lam = torch.sqrt(fyc / fe)
    return torch.where(lam <= 1.34, (1.0 - 0.278 * lam**2) * fyc,
                       0.9 * fyc / lam**2), fyc, fe


def iso_bending_fb(Fy, E, D_mm, t_mm):
    """Representative bending strength f_b (13.2.4) with the tube's plastic
    shape factor Z_p/Z_e."""
    D = _as(D_mm)
    t = _as(t_mm, D)
    Fy = _as(Fy, D)
    Di = D - 2.0 * t
    Zp = (D**3 - Di**3) / 6.0
    Ze = math.pi / 32.0 * (D**4 - Di**4) / D
    shape = Zp / Ze
    x = Fy * D / (E * t)
    fb1 = shape * Fy
    fb2 = (1.13 - 2.58 * x) * shape * Fy
    fb3 = (0.94 - 0.76 * x) * shape * Fy
    return torch.where(x <= 0.0517, fb1, torch.where(x <= 0.1034, fb2, fb3))


class ISOCheck(NamedTuple):
    """ISO 19902 member unity checks (all ``[M]`` unless noted)."""

    uc: torch.Tensor             # governing utilization per member
    uc_beam_column: torch.Tensor  # 13.3.3-1 (compression) / 13.3.2 (tension)
    uc_local: torch.Tensor       # 13.3.3-2 (compression) / same (tension)
    fa_mpa: torch.Tensor         # axial stress (+compression)
    fb_mpa: torch.Tensor         # resultant bending stress (worst end)
    fc_mpa: torch.Tensor         # representative axial strength (f_c or f_t)
    fb_rep_mpa: torch.Tensor     # representative bending strength f_b
    fyc_mpa: torch.Tensor        # local buckling strength f_yc
    KL_over_r: torch.Tensor
    governing: np.ndarray        # [M] str: 'tension'|'beam-column'|'local'


def iso_member_check(model, results, Fy=None, E=None,
                     K_leg: float = 1.0, K_brace: float = 0.8,
                     Cm: float = 0.85, L_override=None) -> ISOCheck:
    """ISO 19902 section 13 strength utilizations from an analysis result:
    inputs and sign conventions as :func:`.codecheck.member_code_check`,
    the partial resistance factors are the module constants."""
    A, W, D, t, KL_r = member_slenderness(model, results, K_leg, K_brace,
                                          L_override)
    Fy = _as(355.0 if Fy is None else Fy, A)
    E = _as(210000.0 if E is None else E, A)

    # worst-end stresses; the two bending planes apart for 13.3.3-1
    F1, F2 = results.F1_local, results.F2_local
    N1 = -F1[:, 0]
    N2 = F2[:, 0]
    worse1 = torch.abs(N1) >= torch.abs(N2)
    fa = torch.where(worse1, N1, N2) / A              # + compression [MPa]
    fby = torch.abs(torch.where(worse1, F1[:, 4], F2[:, 4])) / W
    fbz = torch.abs(torch.where(worse1, F1[:, 5], F2[:, 5])) / W
    fb = torch.sqrt(fby**2 + fbz**2)

    fc, fyc, fe = iso_column_fc(Fy, E, KL_r, D / t)
    fb_rep = iso_bending_fb(Fy, E, D, t)

    comp = fa > 0.0
    fa_c = torch.abs(fa)
    half_pi = math.pi / 2.0
    # tension + bending (13.3.2, cosine interaction)
    arg_t = torch.clamp(half_pi * GAMMA_RT * fa_c / Fy, 0.0, half_pi)
    uc_t = 1.0 - torch.cos(arg_t) + GAMMA_RB * fb / fb_rep
    # compression: beam-column (13.3.3-1)
    amp_y = torch.clamp(1.0 - fa_c / fe, min=1e-3)
    uc_bc = GAMMA_RC * fa_c / fc + GAMMA_RB / fb_rep * torch.sqrt(
        (Cm * fby / amp_y) ** 2 + (Cm * fbz / amp_y) ** 2)
    # compression: local strength (13.3.3-2)
    arg_c = torch.clamp(half_pi * GAMMA_RC * fa_c / fyc, 0.0, half_pi)
    uc_loc = 1.0 - torch.cos(arg_c) + GAMMA_RB * fb / fb_rep

    uc_bc_all = torch.where(comp, uc_bc, uc_t)
    uc_loc_all = torch.where(comp, uc_loc, uc_t)
    gov = np.where(comp.cpu().numpy(),
                   np.where((uc_bc >= uc_loc).cpu().numpy(), "beam-column",
                            "local"), "tension")
    return ISOCheck(uc=torch.maximum(uc_bc_all, uc_loc_all),
                    uc_beam_column=uc_bc_all, uc_local=uc_loc_all,
                    fa_mpa=fa, fb_mpa=fb,
                    fc_mpa=torch.where(comp, fc, Fy), fb_rep_mpa=fb_rep,
                    fyc_mpa=fyc, KL_over_r=KL_r, governing=gov)
