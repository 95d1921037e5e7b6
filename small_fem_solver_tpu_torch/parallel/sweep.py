"""Case batches for design envelopes (PyTorch counterpart of the batch
constructors of ``small_fem_solver_tpu/parallel/sweep.py``).

A batch of waves is one :class:`~..ops.waves.FourierWave` with a leading
case axis on every tensor field; a batch of load cases is one
:class:`~..api.LoadCase` whose numeric fields are ``[C]`` tensors.  Both
feed :func:`~..api.design_envelope_condensed`.

``design_sweep`` and ``critical_case`` are not ported yet (ROADMAP.md,
Queue A item 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import LoadCase
from ..ops.fenton import fenton_wave_batch
from ..ops.stokes import stokes_wave
from ..ops.waves import FourierWave, airy_wave, stack_waves

__all__ = ["make_case_batch", "make_wave_batch", "stack_waves"]


def make_wave_batch(H, T, d, U_c=0.0, model: str = "stokes", N: int = 5,
                    n_modes: int = 20, dtype: torch.dtype = torch.float32,
                    device=None) -> FourierWave:
    """A batched FourierWave from arrays of (H, T) [and scalar d, U_c].

    'airy' and 'stokes' (order min(N, 5)) build each case and stack them;
    'fenton' runs one batched float64 Newton over all cases on the CPU
    (:func:`..ops.fenton.fenton_wave_batch`).  ``device=None`` is the CUDA
    card.
    """
    H = np.atleast_1d(np.asarray(H, dtype=np.float64))
    T = np.broadcast_to(np.asarray(T, dtype=np.float64), H.shape)
    if model == "airy":
        return stack_waves(airy_wave(h, t, d, U_c, n_modes=n_modes,
                                     dtype=dtype, device=device)
                           for h, t in zip(H, T))
    if model == "stokes":
        return stack_waves(stokes_wave(h, t, d, U_c, order=min(N, 5),
                                       n_modes=n_modes, dtype=dtype,
                                       device=device)
                           for h, t in zip(H, T))
    if model == "fenton":
        return fenton_wave_batch(H, T, d, U_c, N=N, n_modes=n_modes,
                                 dtype=dtype, device=device)
    raise ValueError(f"unknown wave model {model!r}")


def make_case_batch(base: LoadCase, **overrides) -> LoadCase:
    """Broadcast a LoadCase to a batch, overriding per-case fields.

    ``overrides`` maps field name -> [B] array; the other numeric fields
    broadcast.  Numeric fields become float64 ``[B]`` tensors (cast with
    :meth:`LoadCase.cast`).
    """
    sizes = {np.asarray(v).shape[0] for v in overrides.values()
             if np.asarray(v).ndim > 0}
    if len(sizes) > 1:
        raise ValueError(f"per-case overrides differ in length: {sizes}")
    B = sizes.pop() if sizes else 1
    vals = {}
    for f in dataclasses.fields(base):
        if f.name in LoadCase._STATIC_FIELDS:
            continue
        v = torch.as_tensor(np.asarray(overrides.get(f.name,
                                                     getattr(base, f.name)),
                                       dtype=np.float64))
        vals[f.name] = v.expand(B).clone() if v.ndim == 0 else v
    return dataclasses.replace(base, **vals)
