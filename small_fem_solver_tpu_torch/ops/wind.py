"""Wind loading: API RP 2A wind profile, member drag and topside block
(PyTorch counterpart of ``small_fem_solver_tpu/ops/wind.py``).

- height profile: the API 1-hour mean power law
  ``u(z) = u_ref (z / z_ref)^alpha``, ``z_ref = 10 m``, ``alpha = 0.125``;
- exposed members: cylinder drag per unit length
  ``q = 0.5 rho_air Cs D |U_perp| U_perp`` on the above-water span, on
  the Morison loads' Gauss-Legendre rule and lever-split to the end
  nodes (members submerged at still water see nothing);
- topside: a block force ``0.5 rho_air Cs A u(z_top)^2`` along the wind
  heading, split over the interface nodes.

Headings are compass degrees like the wave and current (math angle
``90 - dir``); ``rho_air = 1.226 kg/m^3`` (API).  Wind is steady, so
phase scans and envelopes see it as a constant load.
"""
from __future__ import annotations

import torch

from .assembly import node_gather_table, node_sum_ordered
from .morison import gauss_legendre_01

RHO_AIR = 1.226          # kg/m^3 (API RP 2A 2.3.2)
Z_REF_M = 10.0
ALPHA_1H = 0.125         # 1-hour mean power-law exponent


def wind_profile(u_ref_ms, z_m, z_ref: float = Z_REF_M,
                 alpha: float = ALPHA_1H):
    """API power-law wind speed at elevation ``z_m`` above still water;
    elevations below 0.1 m take the 0.1 m speed."""
    z = torch.clamp(z_m if torch.is_tensor(z_m)
                    else torch.tensor(z_m, dtype=torch.float64), min=0.1)
    return u_ref_ms * (z / z_ref) ** alpha


def wind_member_ends(coords: torch.Tensor, conn: torch.Tensor,
                     D_m: torch.Tensor, u_ref_ms, wind_dir_deg, Cs=0.5,
                     n_gauss: int = 15):
    """Per-member wind end forces (F1, F2) [M, 3] (N) on the spans above
    still water (points with z > 0), with ``D_m`` [M] the exposed
    diameters in metres."""
    dtype, dev = coords.dtype, coords.device
    theta = torch.deg2rad(torch.as_tensor(90.0 - wind_dir_deg, dtype=dtype,
                                          device=dev))
    wvec = torch.stack([torch.cos(theta), torch.sin(theta),
                        torch.zeros_like(theta)])          # unit, horizontal
    s_np, w_np = gauss_legendre_01(n_gauss)
    s = torch.as_tensor(s_np, dtype=dtype, device=dev)
    w = torch.as_tensor(w_np, dtype=dtype, device=dev)

    c1 = coords[conn[:, 0]]
    dL = coords[conn[:, 1]] - c1
    L = torch.linalg.norm(dL, dim=-1)
    e = dL / torch.clamp(L, min=1e-12)[:, None]            # [M, 3]
    pts = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [M, Q, 3]
    z = pts[..., 2]
    U = wind_profile(u_ref_ms, z)[..., None] * wvec        # [M, Q, 3]
    Ue = torch.einsum("mqk,mk->mq", U, e)
    U_perp = U - Ue[..., None] * e[:, None, :]
    U_mag = torch.linalg.norm(U_perp, dim=-1)
    q = (0.5 * RHO_AIR * torch.as_tensor(Cs, dtype=dtype, device=dev)
         * D_m[:, None] * U_mag * L[:, None] * w[None, :]
         * (z > 0.0).to(dtype))                            # [M, Q]
    f = q[..., None] * U_perp
    return (torch.sum((1.0 - s)[None, :, None] * f, dim=1),
            torch.sum(s[None, :, None] * f, dim=1))


def wind_member_forces(coords: torch.Tensor, conn: torch.Tensor,
                       D_m: torch.Tensor, u_ref_ms, wind_dir_deg, Cs=0.5,
                       n_gauss: int = 15):
    """Nodal wind forces [n_nodes, 3] (N), summed in a fixed order, and
    their total [3] (see :func:`wind_member_ends`)."""
    F1, F2 = wind_member_ends(coords, conn, D_m, u_ref_ms, wind_dir_deg,
                              Cs=Cs, n_gauss=n_gauss)
    table = node_gather_table(torch.cat([conn[:, 0], conn[:, 1]]),
                              coords.shape[0])
    return (node_sum_ordered(torch.cat([F1, F2]), table),
            torch.sum(F1 + F2, dim=0))


def wind_topside_force(u_ref_ms, area_m2, z_m, Cs=1.0):
    """Topside block wind force magnitude [N] at elevation ``z_m``."""
    return 0.5 * RHO_AIR * Cs * area_m2 * wind_profile(u_ref_ms, z_m) ** 2
