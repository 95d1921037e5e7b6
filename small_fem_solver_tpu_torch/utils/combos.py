"""Load-combination engine: factored superposition of analysis results
(PyTorch counterpart of ``small_fem_solver_tpu/utils/combos.py``).

The FEM is linear, so the response to a factored combination of actions
is the factored combination of the responses: analyze each characteristic
action once (dead, live, environmental per heading, ...), then superpose
with the code's partial factors and re-evaluate the stresses on the
combined member forces (von Mises is a norm: a factored sum of stresses
would be wrong).  Typical factor sets (consult the governing code): ISO
19902 in-place extreme 1.1 G + 1.1 Q + 1.35 E, operating 1.3 G + 1.3 Q +
0.9 E; API RP 2A-WSD extreme 1.0 G + 1.0 Q + 1.0 E.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..ops.sections import von_mises_8pt


def combine_results(model, results: Sequence, factors: Sequence[float],
                    fy: float = 355.0):
    """Factored superposition of linear analysis results of the same model
    (same mesh and supports): the linear fields (U, reactions, applied
    loads, member end forces) are the factored sums, von Mises and
    utilization are re-evaluated on the combined end forces.  The Morison
    breakdown is not combinable (drag is nonlinear in the kinematics) and
    is carried from the first result unscaled; the solver and P-delta
    fields are cleared."""
    if len(results) == 0:
        raise ValueError("combine_results needs at least one result")
    if len(results) != len(factors):
        raise ValueError(f"{len(results)} results but {len(factors)} factors")
    n = results[0].U.shape[0]
    for r in results[1:]:
        if r.U.shape[0] != n:
            raise ValueError("results come from different meshes "
                             f"({r.U.shape[0]} vs {n} DOFs)")

    def lc(field):
        vals = [getattr(r, field) for r in results]
        out = factors[0] * vals[0]
        for f, v in zip(factors[1:], vals[1:]):
            out = out + f * v
        return out

    U = lc("U")
    F1 = lc("F1_local")
    reac = lc("reactions")
    vm = von_mises_8pt(model.sections, model.sect_id,
                       *(F1[:, c] for c in range(6)))
    disp = torch.linalg.norm(U.reshape(-1, 6)[:, :3], dim=-1)
    imax = torch.argmax(disp)
    return results[0]._replace(
        U=U, reactions=reac, F_applied=lc("F_applied"),
        F1_local=F1, F2_local=lc("F2_local"),
        von_mises=vm, utilization=vm / fy,
        max_displacement_mm=disp[imax], max_displacement_node=imax,
        total_reaction=torch.sum(reac, dim=0),
        solver_iters=None, solver_residual=None, pdelta_amplification=None)


def combo_envelope(model, actions: Mapping[str, object],
                   combos: Mapping[str, Mapping[str, float]],
                   fy: float = 355.0):
    """Evaluate a table of named combinations and their member envelope.

    ``actions``: name -> AnalysisResults of one characteristic action;
    ``combos``: combo name -> {action name: factor} (absent actions get
    0).  Returns ``(results, envelope)``: the per-combo combined results
    and a dict with the member-wise max utilization (``member_envelope``
    [M]), each member's governing combo index (``governing_combo`` [M]
    into ``list(combos)``), ``combo_names`` and the governing combo's
    name (``governing``).
    """
    names = list(actions)
    res_list = [actions[k] for k in names]
    out = {}
    for cname, fmap in combos.items():
        unknown = set(fmap) - set(names)
        if unknown:
            raise ValueError(f"combo {cname!r} references unknown "
                             f"action(s) {sorted(unknown)}")
        out[cname] = combine_results(
            model, res_list, [float(fmap.get(k, 0.0)) for k in names], fy=fy)
    U = torch.stack([r.utilization for r in out.values()])  # [n_combos, M]
    worst = int(torch.argmax(torch.max(U, dim=1).values))
    return out, {
        "member_envelope": torch.max(U, dim=0).values,
        "governing_combo": torch.argmax(U, dim=0),
        "combo_names": list(combos),
        "governing": list(combos)[worst],
    }
