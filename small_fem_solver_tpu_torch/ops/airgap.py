"""Deck air-gap (wave-in-deck clearance) check (PyTorch counterpart of
``small_fem_solver_tpu/ops/airgap.py``).

The maximum crest elevation under the platform footprint over a full wave
cycle against the deck underside with the customary margin (ISO 19902: a
positive air gap of at least 1.5 m above the extreme crest; surge and
tide raise the still-water level).  The crest search is one
:func:`.waves.surface_elevation` evaluation over an [n_phases, n_x] grid
on the model's device.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .waves import surface_elevation


class AirGapResult(NamedTuple):
    """Crest-vs-deck clearance figures (m, MWL datum)."""

    crest_m: torch.Tensor          # max eta under the footprint over a cycle
    swl_offset_m: float            # surge + tide still-water-level rise
    deck_elevation_m: float        # deck underside above MWL
    air_gap_m: torch.Tensor        # deck - (crest + swl)
    margin_m: float                # required clearance
    ok: torch.Tensor               # air_gap >= margin
    crest_phase_deg: torch.Tensor  # phase of the governing crest
    crest_x_m: torch.Tensor        # footprint position of the governing crest


def air_gap_check(model, wave, wave_dir_deg: float = 0.0,
                  deck_elevation_m: float | None = None,
                  surge_m: float = 0.0, tide_m: float = 0.0,
                  margin_m: float = 1.5, n_phases: int = 360,
                  n_x: int = 64) -> AirGapResult:
    """Air-gap screen: max crest under the footprint vs the deck underside.

    ``deck_elevation_m`` defaults to the model's top-node elevation; the
    footprint is the span of all node positions projected on the wave
    heading (compass ``wave_dir_deg``), sampled at ``n_x`` points; the
    crest is maximized over ``n_phases`` phases of one period;
    ``surge_m`` + ``tide_m`` raise the still-water level; ``margin_m`` is
    the required clearance.  Any wave theory of the port
    (``FourierWave``: Airy, Stokes, Fenton).
    """
    if n_phases < 1 or n_x < 1:
        raise ValueError("air_gap_check needs n_phases >= 1 and n_x >= 1")
    coords = model.coords.cpu().numpy()
    if deck_elevation_m is None:
        top = np.where(model.top_mask.cpu().numpy())[0]
        if top.size == 0:
            raise ValueError("model has no top nodes; pass "
                             "deck_elevation_m explicitly")
        deck_elevation_m = float(coords[top, 2].max())
    theta = np.deg2rad(90.0 - wave_dir_deg)
    proj = coords[:, 0] * np.cos(theta) + coords[:, 1] * np.sin(theta)
    wave = wave.to(model.dtype, model.device)
    xs = torch.linspace(float(proj.min()), float(proj.max()), n_x,
                        dtype=model.dtype, device=model.device)
    T = 2.0 * math.pi / wave.omega
    ts = torch.arange(n_phases, dtype=model.dtype,
                      device=model.device) * T / n_phases
    eta = surface_elevation(wave, xs[None, :], ts[:, None])  # [phases, n_x]
    flat = torch.argmax(eta)
    ip, ix = flat // n_x, flat % n_x
    crest = eta[ip, ix]
    swl = float(surge_m) + float(tide_m)
    gap = deck_elevation_m - (crest + swl)
    return AirGapResult(
        crest_m=crest, swl_offset_m=swl,
        deck_elevation_m=float(deck_elevation_m), air_gap_m=gap,
        margin_m=float(margin_m), ok=gap >= margin_m,
        crest_phase_deg=360.0 * ip / n_phases, crest_x_m=xs[ix])
