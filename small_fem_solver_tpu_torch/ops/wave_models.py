"""Wave-model facade (PyTorch counterpart of
``small_fem_solver_tpu/ops/wave_models.py``).

Ported theories: 'airy' (linear) and 'fenton' (stream function with N
modes).  'stokes' and the steepness-based 'auto' selection wait for the
port of ``ops/stokes.py`` (ROADMAP.md, Queue A item 1) and raise.
"""
from __future__ import annotations

import torch

from .fenton import fenton_wave
from .waves import FourierWave, airy_wave


def make_wave(H, T, d, U_c=0.0, model: str = "auto", N: int = 10,
              n_modes: int | None = None,
              dtype: torch.dtype = torch.float64, device="cpu") -> FourierWave:
    """Build a wave of the requested theory; ``n_modes`` zero-pads the
    coefficients to a fixed size."""
    model = model.lower()
    if model == "airy":
        return airy_wave(H, T, d, U_c, n_modes=n_modes or 1, dtype=dtype,
                         device=device)
    if model == "fenton":
        return fenton_wave(H, T, d, U_c, N=int(N), n_modes=n_modes,
                           dtype=dtype, device=device)
    if model in ("stokes", "auto"):
        raise NotImplementedError(
            f"wave model {model!r} is not ported yet (ROADMAP.md, Queue A "
            "item 1: Stokes waves and auto selection)")
    raise ValueError(f"unknown wave model {model!r} "
                     "(expected auto/airy/stokes/fenton)")
