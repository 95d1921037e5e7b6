"""Canonical presets: the default 3-leg jacket and the default storm case.

Same numbers as ``small_fem_solver_tpu/models/presets.py``: 21 nodes (3 legs
x 4 levels + 9 hinge nodes), 51 members (9 leg segments, 6 horizontal
braces, 36 X-braces), supports at A1/B1/C1, topside interface at A4/B4/C4,
leg tube 2000x75 mm / brace tube 800x30 mm.
"""
from __future__ import annotations

import torch

from .model import JacketModel, build_model


def default_3leg_jacket_geometry(z_water_ref: float = 47.0):
    """Node table, member list, support and interface node names.

    Coordinates are defined with the deck datum at z = +74 m and shifted
    down by ``z_water_ref`` so z = 0 is the mean water level.
    """
    zr = z_water_ref
    nodes = {
        "A1": (-9.2376, -16.0, 0.0 - zr),
        "A2": (-7.9254, -13.7272, 28.41 - zr),
        "A3": (-6.7947, -11.7688, 52.89 - zr),
        "A4": (-5.8197, -10.08, 74.0 - zr),
        "B1": (18.4752, 0.0, 0.0 - zr),
        "B2": (15.8508, 0.0, 28.41 - zr),
        "B3": (13.5894, 0.0, 52.89 - zr),
        "B4": (11.6394, 0.0, 74.0 - zr),
        "C1": (-9.2376, 16.0, 0.0 - zr),
        "C2": (-7.9254, 13.7272, 28.41 - zr),
        "C3": (-6.7947, 11.7688, 52.89 - zr),
        "C4": (-5.8197, 10.08, 74.0 - zr),
        "HAB1": (4.2657, -7.3884, 15.291 - zr),
        "HBC1": (4.2657, 7.3884, 15.291 - zr),
        "HCA1": (-8.5313, 0.0, 15.291 - zr),
        "HAB2": (3.6583, -6.3364, 41.5902 - zr),
        "HBC2": (3.6583, 6.3364, 41.5902 - zr),
        "HCA2": (-7.3166, 0.0, 41.5902 - zr),
        "HAB3": (3.1348, -5.4296, 64.2608 - zr),
        "HBC3": (3.1348, 5.4296, 64.2608 - zr),
        "HCA3": (-6.2695, 0.0, 64.2608 - zr),
    }

    members = []
    for leg in "ABC":
        for i in (1, 2, 3):
            members.append({"name": f"Leg_{leg}{i}-{leg}{i+1}",
                            "node1": f"{leg}{i}", "node2": f"{leg}{i+1}",
                            "type": "leg"})
    for n1, n2 in [("A1", "B1"), ("B1", "C1"), ("C1", "A1"),
                   ("A2", "B2"), ("B2", "C2"), ("C2", "A2")]:
        members.append({"name": f"HBrace_{n1}-{n2}", "node1": n1,
                        "node2": n2, "type": "h_brace"})

    xbrace_levels = [
        [("A1", "HAB1"), ("HAB1", "B2"), ("B1", "HAB1"), ("HAB1", "A2"),
         ("B1", "HBC1"), ("HBC1", "C2"), ("C1", "HBC1"), ("HBC1", "B2"),
         ("C1", "HCA1"), ("HCA1", "A2"), ("A1", "HCA1"), ("HCA1", "C2")],
        [("A2", "HAB2"), ("HAB2", "B3"), ("B2", "HAB2"), ("HAB2", "A3"),
         ("B2", "HBC2"), ("HBC2", "C3"), ("C2", "HBC2"), ("HBC2", "B3"),
         ("C2", "HCA2"), ("HCA2", "A3"), ("A2", "HCA2"), ("HCA2", "C3")],
        [("A3", "HAB3"), ("HAB3", "B4"), ("B3", "HAB3"), ("HAB3", "A4"),
         ("B3", "HBC3"), ("HBC3", "C4"), ("C3", "HBC3"), ("HBC3", "B4"),
         ("C3", "HCA3"), ("HCA3", "A4"), ("A3", "HCA3"), ("HCA3", "C4")],
    ]
    for level in xbrace_levels:
        for n1, n2 in level:
            members.append({"name": f"XBr_{n1}-{n2}", "node1": n1,
                            "node2": n2, "type": "x_brace"})

    return nodes, members, ["A1", "B1", "C1"], ["A4", "B4", "C4"]


def default_3leg_jacket(z_water_ref: float = 47.0,
                        dtype: torch.dtype = torch.float64, device="cpu",
                        **kw) -> JacketModel:
    """Packed :class:`JacketModel` of the default 3-leg jacket."""
    nodes, members, fixed, top = default_3leg_jacket_geometry(z_water_ref)
    return build_model(nodes, members, fixed, top, dtype=dtype,
                       device=device, **kw)


# Default storm load case (the reference GUI defaults).
DEFAULT_STORM = dict(
    E=210000.0, nu=0.3, fy=355.0, rho_steel=7850.0, rho_water=1025.0,
    D_leg=2000.0, t_leg=75.0, D_brace=800.0, t_brace=30.0,
    H=17.038, T=9.4, d=50.0, U_c=1.7,
    wave_dir=38.0, current_dir=38.0, N_harm=10,
    Cd=0.7, Cm=2.0,
    F_axial_kN=25100.0, F_shear_kN=2900.0,
    M_moment_kNm=0.0, M_torsion_kNm=0.0,
    self_weight_mode="custom", custom_sw_tonnes=1100.0,
    t_analysis=0.0,
)
