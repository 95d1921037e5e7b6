"""Thin-wall tubular section properties as stacked tensors.

PyTorch counterpart of ``small_fem_solver_tpu/ops/sections.py``: a
:class:`TubeSections` holds one tensor per property over any number of
sections, so element stiffness, Morison diameters and stress recovery are
gathers plus vectorized arithmetic.

All section dimensions are in mm; areas mm^2, inertias mm^4, section moduli
mm^3; ``mass_per_m`` is kg/m.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device


class TubeSections(NamedTuple):
    """Stacked thin-wall tube properties; every field has shape ``[S]``."""

    D_outer: torch.Tensor    # outer diameter [mm]
    t: torch.Tensor          # wall thickness [mm]
    rho_steel: torch.Tensor  # steel density [kg/m^3]
    D_inner: torch.Tensor    # [mm]
    R_outer: torch.Tensor    # [mm]
    R_inner: torch.Tensor    # [mm]
    Ax: torch.Tensor         # cross-section area [mm^2]
    Ax_m2: torch.Tensor      # cross-section area [m^2]
    Iy: torch.Tensor         # second moment about y [mm^4]
    Iz: torch.Tensor         # second moment about z [mm^4] (== Iy)
    Ix: torch.Tensor         # torsion constant J [mm^4] (= 2 Iy)
    Ay: torch.Tensor         # shear area along y [mm^2] (= Ax / 2)
    Az: torch.Tensor         # shear area along z [mm^2] (= Ax / 2)
    Wy: torch.Tensor         # section modulus [mm^3]
    Wz: torch.Tensor         # [mm^3]
    Wx: torch.Tensor         # torsional modulus [mm^3]
    mass_per_m: torch.Tensor  # [kg/m]
    D_t_ratio: torch.Tensor   # thin-wall validity indicator (D/t > 10)

    def to(self, dtype: torch.dtype) -> "TubeSections":
        """Every field cast to ``dtype`` (same device)."""
        return TubeSections(*(f.to(dtype) for f in self))


def tube_sections(D_outer_mm, t_mm, rho_steel=7850.0,
                  dtype: torch.dtype = torch.float64,
                  device=None) -> TubeSections:
    """Build stacked tube section properties (scalars or 1-D inputs, all
    broadcast to a common ``[S]`` shape): annular area, I = pi/64 (D^4 -
    d^4), J = pi/32 (D^4 - d^4), shear areas A/2.  ``device=None`` is the
    CUDA card."""
    device = resolve_device(device)

    def vec(v):
        return torch.atleast_1d(torch.as_tensor(v, dtype=dtype,
                                                device=device))

    D, t, rho = torch.broadcast_tensors(vec(D_outer_mm), vec(t_mm),
                                        vec(rho_steel))
    Di = D - 2.0 * t
    Ro = D / 2.0
    Ri = Di / 2.0
    Ax = math.pi / 4.0 * (D**2 - Di**2)
    Ax_m2 = Ax / 1e6
    Iy = math.pi / 64.0 * (D**4 - Di**4)
    Iz = Iy
    Ix = math.pi / 32.0 * (D**4 - Di**4)
    return TubeSections(
        D_outer=D, t=t, rho_steel=rho, D_inner=Di, R_outer=Ro, R_inner=Ri,
        Ax=Ax, Ax_m2=Ax_m2, Iy=Iy, Iz=Iz, Ix=Ix, Ay=0.5 * Ax, Az=0.5 * Ax,
        Wy=Iy / Ro, Wz=Iz / Ro, Wx=Ix / Ro, mass_per_m=Ax_m2 * rho,
        D_t_ratio=D / t,
    )


# The 8 circumferential stress evaluation points, 45 deg apart, at R_outer.
STRESS_POINT_ANGLES_DEG = np.array([0.0, 45.0, 90.0, 135.0, 180.0, 225.0,
                                    270.0, 315.0])


def stress_point_offsets(R_outer: torch.Tensor):
    """(y, z) offsets of the 8 stress points for radius ``R_outer``;
    two tensors shaped ``R_outer.shape + (8,)``."""
    ang = torch.deg2rad(torch.as_tensor(STRESS_POINT_ANGLES_DEG,
                                        dtype=R_outer.dtype,
                                        device=R_outer.device))
    R = R_outer[..., None]
    return R * torch.cos(ang), R * torch.sin(ang)


def normal_stress_8pt(sec: TubeSections, sect_id, Fx, My, Mz):
    """Axial + bending normal stress at the 8 circumferential points:
    sigma = Fx/Ax + My z/Iy + Mz y/Iz.  Inputs ``[..., M]`` (N, N*mm),
    output ``[..., M, 8]`` in MPa."""
    y, z = stress_point_offsets(sec.R_outer[sect_id])
    return ((Fx / sec.Ax[sect_id])[..., None]
            + (My / sec.Iy[sect_id])[..., None] * z
            + (Mz / sec.Iz[sect_id])[..., None] * y)


def von_mises_8pt(sec: TubeSections, sect_id, Fx, Fy, Fz, Mx, My, Mz):
    """Max von Mises stress over the 8 circumferential points, batched:

      sigma = Fx/Ax + My*z/Iy + Mz*y/Iz
      tau   = sqrt((Mx*R/Ix)^2 + (Fy/Ay)^2 + (Fz/Az)^2)
      vm    = sqrt(sigma^2 + 3 tau^2)

    Inputs ``[..., M]`` (forces N, moments N*mm); output ``[..., M]`` MPa.
    """
    Ro = sec.R_outer[sect_id]
    sigma = normal_stress_8pt(sec, sect_id, Fx, My, Mz)
    tau = _safe_sqrt((Mx * Ro / sec.Ix[sect_id]) ** 2
                     + (Fy / sec.Ay[sect_id]) ** 2
                     + (Fz / sec.Az[sect_id]) ** 2)
    vm = _safe_sqrt(sigma**2 + 3.0 * tau[..., None] ** 2)
    return torch.amax(vm, dim=-1)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a finite gradient at 0 (the JAX package's grad-safe
    sqrt; the forward is unchanged for x >= 0): sqrt's gradient at an
    exactly-zero argument is NaN, which would poison the design
    gradients of any member with zero shear and torsion."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def validate_sections(sec: TubeSections, strict: bool = False) -> list:
    """Thin-wall validity check D/t > 10 (the reference documents the
    limit but never enforces it).  Returns warning strings; raises
    ``ValueError`` if ``strict``."""
    Dt = sec.D_t_ratio.detach().cpu().numpy()
    D = sec.D_outer.detach().cpu().numpy()
    msgs = [f"section {i} (D={D[i]:.0f} mm): D/t = {Dt[i]:.1f} <= 10 — "
            "thin-wall section formulas are inaccurate"
            for i in range(Dt.shape[0]) if Dt[i] <= 10.0]
    if strict and msgs:
        raise ValueError("; ".join(msgs))
    return msgs
