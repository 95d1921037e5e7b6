"""Case batches and design sweeps (PyTorch counterpart of
``small_fem_solver_tpu/parallel/sweep.py``).

A batch of waves is one :class:`~..ops.waves.FourierWave` with a leading
case axis on every tensor field; a batch of load cases is one
:class:`~..api.LoadCase` whose numeric fields are ``[C]`` tensors.  Both
feed the design envelopes (:func:`~..api.design_envelope`,
:func:`~..api.design_envelope_condensed`) and :func:`design_sweep`, whose
per-case pointwise loads run as one case-batched evaluation
(``torch.func.vmap``).  ``design_sweep`` lives in ``api.py`` beside
``design_envelope``, whose set-up it shares, and is re-exported here under
its JAX name.  ``mesh=`` (a 1-D DeviceMesh) shards the case axis over
the ranks of its group (:mod:`.comm`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..api import AnalysisResults, LoadCase, design_sweep
from ..ops.fenton import fenton_wave_batch
from ..ops.stokes import stokes_wave
from ..ops.waves import FourierWave, airy_wave, stack_waves
from ..utils import spans

__all__ = ["critical_case", "design_sweep", "make_case_batch",
           "make_wave_batch", "stack_waves"]


def make_wave_batch(H, T, d, U_c=0.0, model: str = "stokes", N: int = 5,
                    n_modes: int = 20, dtype: torch.dtype = torch.float32,
                    device=None) -> FourierWave:
    """A batched FourierWave from arrays of (H, T) [and scalar d, U_c].

    'airy' runs its dispersion Newton once, elementwise over all cases on
    ``device``; 'stokes' (order min(N, 5)) its elementwise float64 Newton
    once over all cases, and 'fenton' one batched float64 Newton
    (:func:`..ops.fenton.fenton_wave_batch`), both on the CPU.
    ``device=None`` is the CUDA card.
    """
    H = np.atleast_1d(np.asarray(H, dtype=np.float64))
    T = np.broadcast_to(np.asarray(T, dtype=np.float64), H.shape)
    if model == "airy":     # elementwise: one build for the whole batch
        return airy_wave(H, T.copy(), np.full(H.shape, np.float64(d)),
                         np.full(H.shape, np.float64(U_c)), n_modes=n_modes,
                         dtype=dtype, device=device)
    if model == "stokes":   # elementwise: one solve for the whole batch
        return stokes_wave(H, T.copy(), np.full(H.shape, np.float64(d)),
                           np.full(H.shape, np.float64(U_c)),
                           order=min(N, 5), n_modes=n_modes, dtype=dtype,
                           device=device)
    if model == "fenton":
        return fenton_wave_batch(H, T, d, U_c, N=N, n_modes=n_modes,
                                 dtype=dtype, device=device)
    raise ValueError(f"unknown wave model {model!r}")


@spans.spanned(spans.ENTRY)
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


def critical_case(results: AnalysisResults) -> dict:
    """The governing case of a sweep (largest utilization): its index,
    maximum utilization and largest displacement."""
    util = torch.amax(results.utilization, dim=-1)          # [C]
    i = torch.argmax(util)
    return {"index": i, "max_utilization": util[i],
            "max_displacement_mm": results.max_displacement_mm[i]}
