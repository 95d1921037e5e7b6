"""Tensor-based structural model (mesh) for jacket space frames.

PyTorch counterpart of ``small_fem_solver_tpu/models/model.py``.  The model
is a frozen dataclass of packed tensors (float coordinates, int64
connectivity, per-member section ids, boolean node masks); node and member
names stay host-side tuples.

Conventions: x east, y north, z up, z = 0 at mean water level; coordinates
in metres; 6 DOFs per node (ux, uy, uz, rx, ry, rz), node-major, so DOF
``6*i + c`` belongs to node i.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sections import TubeSections, tube_sections

# Member type vocabulary of the reference GUI combo
# (`JacketAnalysisGUI_v2.py:1163`); 'leg' binds the leg section, everything
# else binds the brace section (`JacketAnalysisGUI_v2.py:329`).
MEMBER_TYPES = ("leg", "h_brace", "x_brace", "brace")


@dataclasses.dataclass(frozen=True)
class JacketModel:
    """Packed structural model.

    coords     [n_nodes, 3]   node coordinates [m]
    conn       [n_members, 2] int64 node indices (node1, node2)
    sect_id    [n_members]    int64 index into ``sections`` fields
    sections   TubeSections   stacked section properties (mm units)
    fixed_mask [n_nodes]      bool, fully clamped support nodes
    top_mask   [n_nodes]      bool, topside interface nodes

    Appurtenances (risers, conductors, J-tubes, caissons) are hydro-only
    segments between structural nodes: they attract Morison load with
    their own diameter and Cd/Cm multipliers but add no stiffness, mass,
    weight or buoyancy (``None``: none).  ``release`` holds [M] end-release
    codes (``ops.beams.RELEASE_*``; ``None``: every member rigidly framed).
    """

    coords: torch.Tensor
    conn: torch.Tensor
    sect_id: torch.Tensor
    sections: TubeSections
    fixed_mask: torch.Tensor
    top_mask: torch.Tensor
    node_names: tuple = ()
    member_names: tuple = ()
    member_types: tuple = ()
    app_conn: torch.Tensor | None = None      # [A, 2] int64 node indices
    app_D_mm: torch.Tensor | None = None      # [A] hydrodynamic OD [mm]
    app_cd_mult: torch.Tensor | None = None   # [A] drag multiplier
    app_cm_mult: torch.Tensor | None = None   # [A] inertia multiplier
    app_names: tuple = ()
    release: torch.Tensor | None = None       # [M] int64 release codes

    def __post_init__(self):
        if self.release is not None and tuple(self.release.shape) != (
                self.n_members,):
            raise ValueError(f"release must be [{self.n_members}] codes, got "
                             f"shape {tuple(self.release.shape)}")
        A = self.n_appurtenances
        for name in ("app_D_mm", "app_cd_mult", "app_cm_mult"):
            v = getattr(self, name)
            if A and (v is None or tuple(v.shape) != (A,)):
                raise ValueError(f"{name} must be [{A}] with app_conn "
                                 f"[{A}, 2]")

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_members(self) -> int:
        return self.conn.shape[0]

    @property
    def n_dof(self) -> int:
        return 6 * self.n_nodes

    @property
    def n_appurtenances(self) -> int:
        return 0 if self.app_conn is None else self.app_conn.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def member_geometry(self):
        """(coord1, coord2, dL, L) for every member; L in metres."""
        c1 = self.coords[self.conn[:, 0]]
        c2 = self.coords[self.conn[:, 1]]
        dL = c2 - c1
        return c1, c2, dL, torch.linalg.norm(dL, dim=-1)

    def node_index(self, name: str) -> int:
        return self.node_names.index(name)

    def fixed_node_names(self) -> list:
        return [n for n, f in zip(self.node_names, self.fixed_mask.tolist())
                if f]

    def top_node_names(self) -> list:
        return [n for n, f in zip(self.node_names, self.top_mask.tolist())
                if f]


_REL_CODES = {"none": 0, "": 0, "pinned1": 1, "pinned2": 2, "pinned": 3,
              "both": 3}


def build_model(nodes: dict, members: Sequence[dict],
                fixed_nodes: Sequence[str], top_nodes: Sequence[str],
                leg_section=(2000.0, 75.0), brace_section=(800.0, 30.0),
                rho_steel: float = 7850.0,
                dtype: torch.dtype = torch.float64,
                device=None) -> JacketModel:
    """Build a packed model from reference-style inputs: ``nodes`` maps
    name -> (x, y, z) in metres; each member dict has name/node1/node2/type;
    'leg' members use ``leg_section`` (D_mm, t_mm), all others
    ``brace_section``.  ``device=None`` is the CUDA card
    (:func:`..device.resolve_device`).

    A member dict may carry ``release``: ``"none"`` (default),
    ``"pinned1"``, ``"pinned2"`` or ``"pinned"`` (both ends): a pinned end
    transmits axial force, shear and torsion but no bending moment.  Every
    non-support node must keep a rigidly framed member end (else its
    rotations have no stiffness); a violation raises naming the node.
    """
    device = resolve_device(device)
    node_names = tuple(nodes.keys())
    index = {n: i for i, n in enumerate(node_names)}
    coords = np.array([nodes[n] for n in node_names], dtype=np.float64)
    conn = np.array([[index[m["node1"]], index[m["node2"]]]
                     for m in members], dtype=np.int64)
    member_types = tuple(m.get("type", "brace") for m in members)
    sect_id = np.array([0 if t == "leg" else 1 for t in member_types],
                       dtype=np.int64)
    rel_strs = [str(m.get("release", "none")).lower() for m in members]
    bad = sorted({r for r in rel_strs if r not in _REL_CODES})
    if bad:
        raise ValueError(f"unknown member release {bad}; use "
                         "'none' | 'pinned1' | 'pinned2' | 'pinned'")
    release = np.array([_REL_CODES[r] for r in rel_strs], dtype=np.int64)
    (D_leg, t_leg), (D_brace, t_brace) = leg_section, brace_section
    sections = tube_sections([D_leg, D_brace], [t_leg, t_brace], rho_steel,
                             dtype=dtype, device=device)
    fixed_mask = np.zeros(len(node_names), dtype=bool)
    top_mask = np.zeros(len(node_names), dtype=bool)
    fixed_mask[[index[n] for n in fixed_nodes]] = True
    top_mask[[index[n] for n in top_nodes]] = True
    if release.any():
        # a non-support node whose every member end is pinned has no
        # bending stiffness on its rotations: a singular system
        rigid = fixed_mask.copy()
        rigid[conn[release & 1 == 0, 0]] = True
        rigid[conn[release & 2 == 0, 1]] = True
        if not rigid.all():
            offenders = [node_names[i] for i in np.where(~rigid)[0]]
            raise ValueError(
                f"node(s) {offenders} have ONLY pinned member ends "
                "attached: their rotations are unrestrained (singular "
                "system). Keep at least one rigidly framed member end at "
                "every non-support node.")
    return JacketModel(
        coords=torch.as_tensor(coords, dtype=dtype, device=device),
        conn=torch.as_tensor(conn, device=device),
        sect_id=torch.as_tensor(sect_id, device=device),
        sections=sections,
        fixed_mask=torch.as_tensor(fixed_mask, device=device),
        top_mask=torch.as_tensor(top_mask, device=device),
        node_names=node_names,
        member_names=tuple(m["name"] for m in members),
        member_types=member_types,
        release=torch.as_tensor(release, device=device) if release.any()
        else None,
    )


def add_appurtenances(model: JacketModel,
                      appurtenances: Sequence[dict]) -> JacketModel:
    """Attach hydro-only appurtenance segments to a model.

    Each spec dict: ``name``, ``node1``/``node2`` (structural node names:
    risers and conductors hang on the jacket at guide elevations),
    ``D_mm`` (hydrodynamic OD), optional ``cd_mult``/``cm_mult``
    (shielding or roughness factors, default 1).  The segments attract
    Morison drag and inertia through the same kinematics as the members
    but add no stiffness, mass, weight or buoyancy; their end forces land
    on the guide nodes by the same lever rule.  Returns a new model.
    """
    if not appurtenances:
        return model
    index = {n: i for i, n in enumerate(model.node_names)}
    conn = np.array([[index[a["node1"]], index[a["node2"]]]
                     for a in appurtenances], dtype=np.int64)
    D = np.array([float(a["D_mm"]) for a in appurtenances])
    cd = np.array([float(a.get("cd_mult", 1.0)) for a in appurtenances])
    cm = np.array([float(a.get("cm_mult", 1.0)) for a in appurtenances])
    if np.any(D <= 0):
        raise ValueError("appurtenance D_mm must be > 0")
    if np.any(cd < 0) or np.any(cm < 0):
        raise ValueError("appurtenance cd_mult/cm_mult must be >= 0")
    dev, dtype = model.device, model.dtype
    return dataclasses.replace(
        model, app_conn=torch.as_tensor(conn, device=dev),
        app_D_mm=torch.as_tensor(D, dtype=dtype, device=dev),
        app_cd_mult=torch.as_tensor(cd, dtype=dtype, device=dev),
        app_cm_mult=torch.as_tensor(cm, dtype=dtype, device=dev),
        app_names=tuple(a["name"] for a in appurtenances))


def refine_model(model: JacketModel, n_seg: int) -> JacketModel:
    """Subdivide every member into ``n_seg`` equal beam elements.

    Interior nodes are appended member-major (member e's chain is a
    contiguous block), unnamed, unflagged, and inherit the parent member's
    section and type — the layout the condensation solver relies on.  End
    releases stay on the physical member ends (the node-1 bit on the first
    segment, the node-2 bit on the last); appurtenances hang on original
    nodes, whose indices refinement keeps, and are carried unchanged.  The
    index arithmetic runs host-side in numpy; the result lives on the
    model's device and dtype.
    """
    if n_seg <= 1:
        return model
    coords = model.coords.detach().cpu().numpy()
    conn = model.conn.cpu().numpy()
    sect_id = model.sect_id.cpu().numpy()
    n_nodes, M = coords.shape[0], conn.shape[0]
    n_int = n_seg - 1

    c1, c2 = coords[conn[:, 0]], coords[conn[:, 1]]
    s = (np.arange(1, n_seg) / n_seg)[None, :, None]
    interior = c1[:, None, :] + (c2 - c1)[:, None, :] * s
    new_coords = np.concatenate([coords, interior.reshape(-1, 3)], axis=0)

    int_ids = n_nodes + np.arange(M * n_int).reshape(M, n_int)
    chain = np.concatenate([conn[:, 0:1], int_ids, conn[:, 1:2]], axis=1)
    new_conn = np.stack([chain[:, :-1], chain[:, 1:]], axis=-1).reshape(-1, 2)

    fixed = np.zeros(new_coords.shape[0], dtype=bool)
    top = np.zeros(new_coords.shape[0], dtype=bool)
    fixed[:n_nodes] = model.fixed_mask.cpu().numpy()
    top[:n_nodes] = model.top_mask.cpu().numpy()

    base = model.member_names or tuple(f"M{e}" for e in range(M))
    types = model.member_types or ("brace",) * M
    dev, dtype = model.device, model.dtype
    release = None
    if model.release is not None:
        rel = model.release.cpu().numpy()
        seg_rel = np.zeros((M, n_seg), dtype=np.int64)
        seg_rel[:, 0] |= rel & 1
        seg_rel[:, -1] |= rel & 2
        release = torch.as_tensor(seg_rel.reshape(-1), device=dev)
    return dataclasses.replace(
        model,
        coords=torch.as_tensor(new_coords, dtype=dtype, device=dev),
        conn=torch.as_tensor(new_conn, dtype=torch.int64, device=dev),
        sect_id=torch.as_tensor(np.repeat(sect_id, n_seg), dtype=torch.int64,
                                device=dev),
        fixed_mask=torch.as_tensor(fixed, device=dev),
        top_mask=torch.as_tensor(top, device=dev),
        node_names=tuple(model.node_names) + tuple(
            f"_R{e}_{k}" for e in range(M) for k in range(1, n_seg)),
        member_names=tuple(f"{base[e]}#{k}" for e in range(M)
                           for k in range(n_seg)),
        member_types=tuple(types[e] for e in range(M) for _ in range(n_seg)),
        release=release,
    )
