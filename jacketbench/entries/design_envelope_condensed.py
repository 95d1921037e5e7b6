"""``design_envelope_condensed``: the storm envelope on a refined mesh,
every storm of the call under its own heading, all phases, reductions on
the host (per case and phase the largest utilization, per element the
envelope, the total Morison force)."""
from __future__ import annotations

import numpy as np

from .. import judge
from ..sut import build_kernels, host, pick_waves

CLAMP = False          # loads through the separable (phase-batch) path


def setup(sut):
    build_kernels(sut)
    return sut


def call(sut, spec: dict) -> dict:
    pt, h = sut.pt, spec["heading_deg"]
    cases = pt.make_case_batch(sut.base_case, wave_dir_deg=h,
                               current_dir_deg=h)
    env = pt.design_envelope_condensed(
        sut.coarse, sut.refined, sut.n_seg, pick_waves(sut.waves,
                                                       spec["wave_idx"]),
        cases, n_steps=spec["n_steps"],
        n_gauss=sut.config["sea"]["n_gauss"], solve_dtype=sut.solve_dtype,
        **sut.mix["entry_options"])
    return {"max_util_per_phase": host(env.max_util_per_phase),
            "member_envelope": host(env.member_envelope),
            "total_morison": host(env.total_morison),
            "governing_case": host(env.governing_case)}


def work_shapes(sut, spec: dict) -> dict:
    """K1's work a call: each storm's loads at its phases on every
    element."""
    r = sut.refined
    k1 = dict(dtype=str(sut.dtype).split(".")[-1], C=1, S=spec["n_steps"],
              M=r.n_members, Q=sut.config["sea"]["n_gauss"],
              N=sut.waves.n_modes, n_nodes=r.n_nodes)
    return {"k1": [k1] * len(spec["wave_idx"])}


def readings(out: dict, ref: dict) -> dict:
    """Per (case, phase) the largest utilization and the total Morison
    force, band rows left out; per element the envelope over every row,
    leaving out the elements whose reference envelope is set in a band
    row (its largest value over the rows outside the band is lower)."""
    near = ref["near"]                                    # [C, S]
    u = ref["utilization"]                                # [C, S, M]
    env = u.max(axis=(0, 1))
    outside = np.where(near[..., None], -np.inf, u).max(axis=(0, 1))
    return {
        "util_phase_gap": judge.gap(out["max_util_per_phase"], u.max(-1),
                                    near),
        "member_env_gap": judge.gap(out["member_envelope"], env,
                                    env > outside),
        "morison_gap": judge.gap(out["total_morison"], ref["total_morison"],
                                 near),
    }


def from_reference(ans: dict) -> dict:
    """A reference's answers in this entry's form (the control)."""
    u = ans["utilization"]
    return {"max_util_per_phase": u.max(-1),
            "member_envelope": u.max(axis=(0, 1)),
            "total_morison": ans["total_morison"]}
