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

from ..ops.sections import TubeSections, tube_sections

# Options of the JAX model that this package does not carry yet.
NOT_PORTED_OPTIONS = ("member end releases and appurtenances are not ported "
                      "yet (ROADMAP.md, Queue A item 3: model and load "
                      "options)")


@dataclasses.dataclass(frozen=True)
class JacketModel:
    """Packed structural model.

    coords     [n_nodes, 3]   node coordinates [m]
    conn       [n_members, 2] int64 node indices (node1, node2)
    sect_id    [n_members]    int64 index into ``sections`` fields
    sections   TubeSections   stacked section properties (mm units)
    fixed_mask [n_nodes]      bool, fully clamped support nodes
    top_mask   [n_nodes]      bool, topside interface nodes

    ``app_conn`` (appurtenance segments) and ``release`` (member end
    releases) mirror the JAX model's fields; a model that sets either is
    refused (:data:`NOT_PORTED_OPTIONS`).
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
    app_conn: torch.Tensor | None = None
    release: torch.Tensor | None = None

    def __post_init__(self):
        if self.release is not None or (
                self.app_conn is not None and self.app_conn.shape[0] > 0):
            raise NotImplementedError(NOT_PORTED_OPTIONS)

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
    def dtype(self) -> torch.dtype:
        return self.coords.dtype

    @property
    def device(self) -> torch.device:
        return self.coords.device


def build_model(nodes: dict, members: Sequence[dict],
                fixed_nodes: Sequence[str], top_nodes: Sequence[str],
                leg_section=(2000.0, 75.0), brace_section=(800.0, 30.0),
                rho_steel: float = 7850.0,
                dtype: torch.dtype = torch.float64,
                device="cpu") -> JacketModel:
    """Build a packed model from reference-style inputs: ``nodes`` maps
    name -> (x, y, z) in metres; each member dict has name/node1/node2/type;
    'leg' members use ``leg_section`` (D_mm, t_mm), all others
    ``brace_section``.  A member with a ``release`` other than 'none' is
    refused (:data:`NOT_PORTED_OPTIONS`)."""
    if any(str(m.get("release", "none")).lower() not in ("none", "")
           for m in members):
        raise NotImplementedError(NOT_PORTED_OPTIONS)
    node_names = tuple(nodes.keys())
    index = {n: i for i, n in enumerate(node_names)}
    coords = np.array([nodes[n] for n in node_names], dtype=np.float64)
    conn = np.array([[index[m["node1"]], index[m["node2"]]]
                     for m in members], dtype=np.int64)
    member_types = tuple(m.get("type", "brace") for m in members)
    sect_id = np.array([0 if t == "leg" else 1 for t in member_types],
                       dtype=np.int64)
    (D_leg, t_leg), (D_brace, t_brace) = leg_section, brace_section
    sections = tube_sections([D_leg, D_brace], [t_leg, t_brace], rho_steel,
                             dtype=dtype, device=device)
    fixed_mask = np.zeros(len(node_names), dtype=bool)
    top_mask = np.zeros(len(node_names), dtype=bool)
    fixed_mask[[index[n] for n in fixed_nodes]] = True
    top_mask[[index[n] for n in top_nodes]] = True
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
    )


def refine_model(model: JacketModel, n_seg: int) -> JacketModel:
    """Subdivide every member into ``n_seg`` equal beam elements.

    Interior nodes are appended member-major (member e's chain is a
    contiguous block), unnamed, unflagged, and inherit the parent member's
    section and type — the layout the condensation solver relies on.  The
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
    return JacketModel(
        coords=torch.as_tensor(new_coords, dtype=dtype, device=dev),
        conn=torch.as_tensor(new_conn, dtype=torch.int64, device=dev),
        sect_id=torch.as_tensor(np.repeat(sect_id, n_seg), dtype=torch.int64,
                                device=dev),
        sections=model.sections,
        fixed_mask=torch.as_tensor(fixed, device=dev),
        top_mask=torch.as_tensor(top, device=dev),
        node_names=tuple(model.node_names) + tuple(
            f"_R{e}_{k}" for e in range(M) for k in range(1, n_seg)),
        member_names=tuple(f"{base[e]}#{k}" for e in range(M)
                           for k in range(n_seg)),
        member_types=tuple(types[e] for e in range(M) for _ in range(n_seg)),
    )
