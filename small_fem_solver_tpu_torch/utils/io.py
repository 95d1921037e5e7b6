"""Model + case JSON persistence and CSV export (PyTorch counterpart of
``small_fem_solver_tpu/utils/io.py``).

The JSON schema is the JAX package's, so a model saved by either package
loads in the other: nodes, members (with their end releases), fixed and
top node sets, the leg/brace sections, the steel density, appurtenances
and optional analysis parameters.  The CSV member-force table has the
exact column set of the reference tool's ``export_csv``.  A loaded model
lives on ``device`` (``None``: the CUDA card).
"""
from __future__ import annotations

import csv
import json
import pathlib

import numpy as np
import torch

from ..models.model import JacketModel, add_appurtenances, build_model
from . import spans

SCHEMA_VERSION = 1

# Column order of the reference's internal-force table.
CSV_COLUMNS = ["member", "type", "node1", "node2", "length_m",
               "Fx_max_kN", "Fy_max_kN", "Fz_max_kN",
               "My_max_kNm", "Mz_max_kNm",
               "von_mises_max_MPa", "utilization"]

_RELEASES = ("none", "pinned1", "pinned2", "pinned")


@spans.spanned(spans.HOST_COPY)
def _np(x) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array."""
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def model_to_dict(model: JacketModel, params: dict | None = None) -> dict:
    """Serializable dict of a model (+ optional analysis parameters)."""
    coords = _np(model.coords)
    conn = _np(model.conn)
    sec = model.sections
    D, t, rho = _np(sec.D_outer), _np(sec.t), _np(sec.rho_steel)
    if D.shape[0] != 2:
        raise ValueError(
            "model_to_dict serializes the standard 2-section (leg/brace) "
            f"layout; this model carries {D.shape[0]} sections")
    release = None if model.release is None else _np(model.release)
    d = {
        "schema_version": SCHEMA_VERSION,
        "nodes": {n: [float(x) for x in coords[i]]
                  for i, n in enumerate(model.node_names)},
        "members": [
            {"name": model.member_names[e],
             "node1": model.node_names[conn[e, 0]],
             "node2": model.node_names[conn[e, 1]],
             "type": model.member_types[e],
             **({"release": _RELEASES[int(release[e])]}
                if release is not None and int(release[e]) else {})}
            for e in range(model.n_members)],
        "fixed_nodes": model.fixed_node_names(),
        "top_nodes": model.top_node_names(),
        "sections": {
            "leg": {"D_mm": float(D[0]), "t_mm": float(t[0])},
            "brace": {"D_mm": float(D[1]), "t_mm": float(t[1])},
            "rho_steel": float(rho[0]),
        },
    }
    if model.n_appurtenances:
        app = _np(model.app_conn)
        D_app, cd, cm = (_np(model.app_D_mm), _np(model.app_cd_mult),
                         _np(model.app_cm_mult))
        d["appurtenances"] = [
            {"name": model.app_names[a],
             "node1": model.node_names[app[a, 0]],
             "node2": model.node_names[app[a, 1]],
             "D_mm": float(D_app[a]), "cd_mult": float(cd[a]),
             "cm_mult": float(cm[a])}
            for a in range(app.shape[0])]
    if params:
        d["params"] = params
    return d


def save_model(path, model: JacketModel, params: dict | None = None) -> None:
    pathlib.Path(path).write_text(json.dumps(model_to_dict(model, params),
                                             indent=2))


def model_from_dict(d: dict, dtype: torch.dtype | None = None,
                    device=None) -> tuple[JacketModel, dict]:
    """(model, params) from a dict produced by :func:`model_to_dict` (of
    either package); float tensors of ``dtype`` (default float64) on
    ``device`` (``None``: the CUDA card)."""
    if d.get("schema_version", 1) > SCHEMA_VERSION:
        raise ValueError(f"model file schema {d['schema_version']} is newer "
                         f"than supported {SCHEMA_VERSION}")
    sec = d.get("sections", {})
    leg = sec.get("leg", {"D_mm": 2000.0, "t_mm": 75.0})
    brace = sec.get("brace", {"D_mm": 800.0, "t_mm": 30.0})
    model = build_model(
        nodes={n: tuple(c) for n, c in d["nodes"].items()},
        members=d["members"],
        fixed_nodes=d.get("fixed_nodes", []),
        top_nodes=d.get("top_nodes", []),
        leg_section=(leg["D_mm"], leg["t_mm"]),
        brace_section=(brace["D_mm"], brace["t_mm"]),
        rho_steel=sec.get("rho_steel", 7850.0),
        dtype=dtype or torch.float64, device=device,
    )
    if d.get("appurtenances"):
        model = add_appurtenances(model, d["appurtenances"])
    return model, d.get("params", {})


def load_model(path, dtype: torch.dtype | None = None,
               device=None) -> tuple[JacketModel, dict]:
    return model_from_dict(json.loads(pathlib.Path(path).read_text()),
                           dtype=dtype, device=device)


def member_force_table(model: JacketModel, results) -> list[dict]:
    """The reference's internal-force record list, one dict per member."""
    F1 = _np(results.F1_local)
    F2 = _np(results.F2_local)
    vm = _np(results.von_mises)
    util = _np(results.utilization)
    length = _np(results.length_m)
    conn = _np(model.conn)
    rows = []
    for e in range(model.n_members):
        rows.append({
            "member": model.member_names[e],
            "type": model.member_types[e],
            "node1": model.node_names[conn[e, 0]],
            "node2": model.node_names[conn[e, 1]],
            "length_m": float(length[e]),
            "Fx_max_kN": float(max(abs(F1[e, 0]), abs(F2[e, 0])) / 1e3),
            "Fy_max_kN": float(max(abs(F1[e, 1]), abs(F2[e, 1])) / 1e3),
            "Fz_max_kN": float(max(abs(F1[e, 2]), abs(F2[e, 2])) / 1e3),
            "My_max_kNm": float(max(abs(F1[e, 4]), abs(F2[e, 4])) / 1e6),
            "Mz_max_kNm": float(max(abs(F1[e, 5]), abs(F2[e, 5])) / 1e6),
            "von_mises_max_MPa": float(vm[e]),
            "utilization": float(util[e]),
        })
    return rows


def export_csv(path, model: JacketModel, results) -> None:
    """CSV with the reference's exact columns, through the standard
    library's ``csv`` (no pandas: the file's bytes do not depend on what
    the host has installed)."""
    rows = member_force_table(model, results)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        w.writerows(rows)
