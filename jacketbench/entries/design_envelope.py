"""``design_envelope``: the dense design tier, every case of the batch at
every phase, reductions on the host (per case and phase the largest
utilization, per member the envelope, the total Morison force)."""
from __future__ import annotations

from .design_envelope_condensed import (  # noqa: F401 (same answers)
    from_reference, readings)
from ..sut import build_kernels, host, pick_waves

CLAMP = False          # loads through the separable (phase-batch) path


def setup(sut):
    build_kernels(sut)
    return sut


def call(sut, spec: dict) -> dict:
    pt, h = sut.pt, spec["heading_deg"]
    cases = pt.make_case_batch(sut.base_case, wave_dir_deg=h,
                               current_dir_deg=h)
    env = pt.design_envelope(sut.coarse, pick_waves(sut.waves,
                                                    spec["wave_idx"]),
                             cases, n_steps=spec["n_steps"],
                             n_gauss=sut.config["sea"]["n_gauss"],
                             **sut.mix["entry_options"])
    return {"max_util_per_phase": host(env.max_util_per_phase),
            "member_envelope": host(env.member_envelope),
            "total_morison": host(env.total_morison),
            "governing_case": host(env.governing_case)}


def work_shapes(sut, spec: dict) -> dict:
    """K1's work a call: every case's loads at its phases, one batch."""
    m = sut.coarse
    return {"k1": [dict(dtype=str(sut.dtype).split(".")[-1],
                        C=len(spec["wave_idx"]), S=spec["n_steps"],
                        M=m.n_members, Q=sut.config["sea"]["n_gauss"],
                        N=sut.waves.n_modes, n_nodes=m.n_nodes)]}
