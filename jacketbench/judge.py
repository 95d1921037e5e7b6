"""What decides ``correct``: the plain reference (``reference/``) set up
from the same configuration and traffic mix, and the comparison of the
program's answers with it.

The reference imports nothing of the program.  It builds its own model from
the configuration's tables and works its own waves out again from (H, T, d,
U_c), then answers each sampled call in float64 (or, for the control, in
the precision below the configuration's).

Each compared number is a widest gap: max |program - reference| over an
answer, divided by the largest |reference| of that answer in the call.
Rows (a case's or a phase's values) whose loads pass within
``surface_band_m`` of a jump (a Gauss point at the wet / dry surface, or at
the edge of the slamming band) are left out of row-wise numbers, since a
rounding there flips a whole point's load on or off; an envelope over
every row leaves out the items (elements) whose reference envelope is set
in such a row.
The limits and the band are the cell's ``limits/<cell>.json``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .reference import jacket, waves as rwaves


@dataclasses.dataclass
class Judge:
    config: dict
    system: jacket.System
    waves: dict                # numpy float64, the mix's whole wave set
    case: jacket.Case
    clamp: bool                # the entry's load path (pointwise: True)
    band: float


def build(config: dict, mix: dict, H: np.ndarray, clamp: bool, band: float,
          prec: jacket.Precision, device) -> Judge:
    mat, sea, top = config["material"], config["sea"], config["topside"]
    model = jacket.build(config, int(config["mesh"]["n_seg"]), prec, device)
    system = jacket.system(model, mat["E_MPa"], mat["nu"], prec)
    w = rwaves.make_waves(config["wave"], H, sea["T_s"], sea["d_m"],
                          sea["U_c_ms"])
    case = jacket.Case(Cd=sea["Cd"], Cm=sea["Cm"],
                       rho=sea["rho_water_kg_m3"],
                       slam_cs=float(mix.get("case", {}).get("slam_cs", 0.0)),
                       F_axial_kN=top["F_axial_kN"],
                       F_shear_kN=top["F_shear_kN"],
                       sw_tonnes=top["self_weight_t"], fy=mat["fy_MPa"])
    return Judge(config=config, system=system, waves=w, case=case,
                 clamp=clamp, band=band)


def answer(j: Judge, spec: dict) -> dict:
    """The reference's answers to one call: per (case, phase) utilization
    [C, S, M], total Morison [C, S, 3], reactions [C, S, n_sup, 6] and the
    band flags [C, S]."""
    idx = spec["wave_idx"]
    w = rwaves.select(j.waves, idx)
    S = spec["n_steps"]
    ts = w["T"][:, None] * np.arange(S)[None, :] / S
    return jacket.analysis(j.system, w, spec["heading_deg"], ts, j.case,
                           int(j.config["sea"]["n_gauss"]), j.clamp, j.band)


def gap(got: np.ndarray, ref: np.ndarray, skip_rows=None):
    """max |got - ref| over the rows not skipped, over max |ref|; None
    when every row is skipped."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return float("inf")
    scale = np.abs(ref).max()
    d = np.abs(got - ref)
    if skip_rows is not None:
        keep = ~np.asarray(skip_rows, bool)
        if not keep.any():
            return None
        d = d[keep]
    return float(d.max() / scale) if d.size else None


def judge(readings: list, limits: dict) -> dict:
    """The worst reading of each number over the sampled calls, beside its
    limit: {name: {"value": v, "limit": l, "ok": bool}}."""
    out = {}
    for name, limit in limits.items():
        vals = [r[name] for r in readings if r.get(name) is not None]
        v = max(vals, key=lambda x: x if np.isfinite(x) else np.inf,
                default=None)
        ok = v is not None and bool(np.isfinite(v)) and v <= limit
        if v is not None and not np.isfinite(v):
            v = str(v)             # no NaN or Infinity in the JSON line
        out[name] = {"value": v, "limit": limit, "ok": bool(ok)}
    return out


def free_device() -> None:
    """Release cached device blocks between the program and the
    reference."""
    import gc
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
