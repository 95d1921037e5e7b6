"""Deterministic fatigue screening: S-N damage over a phase-resolved
stress history (PyTorch counterpart of
``small_fem_solver_tpu/ops/fatigue.py``).

A phase scan gives every member's von Mises history over one wave cycle,
so the per-cycle stress range is exact, and Miner damage for an exposure
follows from the wave count.  Scope: one sea state, one stress cycle per
wave period, the von Mises range as the fatigue stress, single-slope S-N
curves N = 10^loga S^-m (S in MPa), simplifications of the DNV-GL RP-C203
curves:

  'D'  in air:             m = 3.0, log a = 12.164
  'D-sea-cp' seawater+CP:  m = 3.0, log a = 11.764
  'F'  in air:             m = 3.0, log a = 11.855
"""
from __future__ import annotations

from typing import NamedTuple

import torch

SN_CURVES = {
    "D": (3.0, 12.164),
    "D-sea-cp": (3.0, 11.764),
    "F": (3.0, 11.855),
}

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0


class FatigueScreen(NamedTuple):
    stress_range_mpa: torch.Tensor   # [M] per-cycle von Mises range * scf
    cycles_to_failure: torch.Tensor  # [M] N(S) from the S-N curve
    damage: torch.Tensor             # [M] Miner damage over the exposure
    life_years: torch.Tensor         # [M] exposure_years / damage
    n_cycles: float                  # wave cycles in the exposure


def fatigue_screen(von_mises_phases, T_wave: float, exposure_years: float,
                   curve: str = "D", scf=1.0,
                   occurrence: float = 1.0) -> FatigueScreen:
    """Miner damage per member from a phase-resolved von Mises history
    ``[S, M]`` (MPa) over one wave period: one stress cycle per period with
    range max - min over the phases.  ``occurrence`` is the fraction of
    the exposure this sea state acts (1.0: the design wave runs
    continuously, conservative); ``scf`` (a scalar or per-member [M])
    multiplies the range."""
    if curve not in SN_CURVES:
        raise ValueError(f"unknown S-N curve {curve!r}; "
                         f"available: {sorted(SN_CURVES)}")
    m, loga = SN_CURVES[curve]
    vm = torch.as_tensor(von_mises_phases)
    S = (torch.amax(vm, dim=0) - torch.amin(vm, dim=0)) * torch.as_tensor(
        scf, dtype=vm.dtype, device=vm.device)
    n_cycles = exposure_years * SECONDS_PER_YEAR / float(T_wave) * occurrence
    N_fail = 10.0 ** loga * torch.clamp(S, min=1e-12) ** (-m)
    damage = torch.where(S > 0, n_cycles / N_fail, torch.zeros_like(S))
    life = torch.where(damage > 0, exposure_years / damage,
                       torch.full_like(S, float("inf")))
    return FatigueScreen(stress_range_mpa=S, cycles_to_failure=N_fail,
                         damage=damage, life_years=life,
                         n_cycles=float(n_cycles))
