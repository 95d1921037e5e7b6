"""Piecewise-linear table interpolation with the JAX package's conventions.

:func:`interp` is ``jnp.interp`` (``numpy.interp``'s semantics): the
segment of ``x`` is ``[xp[i - 1], xp[i]]`` with ``i`` the right-side
``searchsorted`` index clipped to ``[1, len(xp) - 1]``, so a knot takes
the segment to its right (the last knot the one to its left), and the
table's end values hold outside it.  :func:`interp_slope` is the
derivative ``jax.grad`` gives of that expression: the chosen segment's
slope, so the right one at an interior knot, and 0 outside the table.
The soil curves' Newton iteration starts exactly on such knots
(``ops/soil.py``), so its first tangent, and with it every iterate,
depends on this choice.
"""
from __future__ import annotations

import numpy as np
import torch


def _table(x: torch.Tensor, xp, fp):
    xp = torch.as_tensor(xp, dtype=x.dtype, device=x.device)
    fp = torch.as_tensor(fp, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    # a zero-width segment (a repeated knot) takes its left value
    np_dtype = np.float32 if x.dtype == torch.float32 else np.float64
    dx0 = torch.abs(dx) <= float(np.spacing(np.finfo(np_dtype).eps))
    outside = torch.logical_or(x < xp[0], x > xp[-1])
    return xp, fp, i, df, torch.where(dx0, torch.ones_like(dx), dx), dx0, \
        outside


def interp(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)``: linear interpolation of the sorted table
    (``xp``, ``fp``) at ``x`` (any shape), clamped to the end values."""
    xp, fp, i, df, dx, dx0, _ = _table(x, xp, fp)
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + ((x - xp[i - 1]) / dx) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def interp_slope(x: torch.Tensor, xp, fp) -> torch.Tensor:
    """d :func:`interp` / dx as ``jax.grad`` evaluates it: the slope of
    the segment :func:`interp` uses (the right one at an interior knot),
    0 outside the table and on a zero-width segment."""
    _, _, _, df, dx, dx0, outside = _table(x, xp, fp)
    slope = torch.where(dx0, torch.zeros_like(df), df / dx)
    return torch.where(outside, torch.zeros_like(slope), slope)
