"""``phase_scan_prepared``: one storm's condensed phase scan through a
handle factored once in set-up; utilization, reactions and the total
Morison force of every phase on the host."""
from __future__ import annotations

from .. import judge
from ..sut import build_kernels, host, pick_waves

CLAMP = True           # pointwise kinematics (the evaluation-height clamp)


def setup(sut):
    build_kernels(sut)
    mat = sut.config["material"]
    sut.prep = sut.pt.prepare_condensed(sut.coarse, sut.refined, sut.n_seg,
                                        E=mat["E_MPa"], nu=mat["nu"],
                                        solve_dtype=sut.solve_dtype)
    return sut


def call(sut, spec: dict) -> dict:
    import dataclasses
    (i,), (h,) = spec["wave_idx"], spec["heading_deg"]
    case = dataclasses.replace(sut.base_case, wave_dir_deg=float(h),
                               current_dir_deg=float(h))
    res = sut.pt.phase_scan_prepared(
        sut.prep, pick_waves(sut.waves, [i]).case(0), case, spec["n_steps"],
        n_gauss=sut.config["sea"]["n_gauss"], **sut.mix["entry_options"])
    return {"utilization": host(res.utilization),
            "reactions": host(res.reactions),
            "total_morison": host(res.total_morison)}


def work_shapes(sut, spec: dict) -> dict:
    return {}


def readings(out: dict, ref: dict) -> dict:
    near = ref["near"][0]
    return {
        "util_gap": judge.gap(out["utilization"], ref["utilization"][0],
                              near),
        "reaction_gap": judge.gap(out["reactions"], ref["reactions"][0],
                                  near),
        "morison_gap": judge.gap(out["total_morison"],
                                 ref["total_morison"][0], near),
    }


def from_reference(ans: dict) -> dict:
    """A reference's answers in this entry's form (the control)."""
    return {k: ans[k][0] for k in ("utilization", "reactions",
                                    "total_morison")}
