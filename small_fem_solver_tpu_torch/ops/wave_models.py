"""Wave-model facade with automatic steepness-based selection (PyTorch
counterpart of ``small_fem_solver_tpu/ops/wave_models.py``).

Given (H, T, d, model name, N) return the canonical :class:`FourierWave`.
Selection thresholds are the reference's:

    steepness = H / L_airy
    'auto':   < 0.01 -> Airy;  < 0.03 -> Stokes N=3;  < 0.06 -> Stokes N=5;
              else Fenton with N = clip(int(200 * steepness), 10, 20)
    'stokes': order = min(N, 5)
    'fenton': stream function with N modes
    'airy':   linear theory

Breaking-wave limits H/L < 0.142 (deep) and H/d < 0.78 (shallow) are
checked by :func:`validate_wave`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .dispersion import solve_dispersion
from .fenton import fenton_wave
from .stokes import stokes_wave
from .waves import FourierWave, airy_wave


def airy_steepness(H, T, d) -> float:
    """H / L with L from linear dispersion (the selection metric)."""
    omega = torch.tensor(2.0 * math.pi / float(T), dtype=torch.float64)
    k = float(solve_dispersion(omega, torch.tensor(float(d),
                                                   dtype=torch.float64)))
    return float(H) * k / (2.0 * math.pi)


def validate_wave(H, T, d, strict: bool = False) -> list:
    """Check the breaking limits; raise (``strict``) or return the
    messages."""
    msgs = []
    s = airy_steepness(H, T, d)
    if s >= 0.142:
        msgs.append(f"steepness H/L = {s:.3f} exceeds deep-water breaking "
                    f"limit 0.142")
    if float(H) / float(d) >= 0.78:
        msgs.append(f"H/d = {float(H)/float(d):.3f} exceeds shallow-water "
                    f"breaking limit 0.78")
    if strict and msgs:
        raise ValueError("; ".join(msgs))
    return msgs


def make_wave(H, T, d, U_c=0.0, model: str = "auto", N: int = 10,
              n_modes: int | None = None,
              dtype: torch.dtype = torch.float64, device=None) -> FourierWave:
    """Build a wave of the requested (or auto-selected) theory;
    ``n_modes`` zero-pads the coefficients to a fixed size;
    ``device=None`` is the CUDA card."""
    model = model.lower()
    if model == "auto":
        s = airy_steepness(H, T, d)
        if s < 0.01:
            model, N = "airy", 1
        elif s < 0.03:
            model, N = "stokes", 3
        elif s < 0.06:
            model, N = "stokes", 5
        else:
            model, N = "fenton", int(np.clip(int(s * 200), 10, 20))

    if model == "airy":
        return airy_wave(H, T, d, U_c, n_modes=n_modes or 1, dtype=dtype,
                         device=device)
    if model == "stokes":
        return stokes_wave(H, T, d, U_c, order=min(int(N), 5),
                           n_modes=n_modes or 5, dtype=dtype, device=device)
    if model == "fenton":
        return fenton_wave(H, T, d, U_c, N=int(N), n_modes=n_modes,
                           dtype=dtype, device=device)
    raise ValueError(f"unknown wave model {model!r} "
                     "(expected auto/airy/stokes/fenton)")
