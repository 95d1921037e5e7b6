"""Carry state from the JAX package into this one.

Each function takes the leaves of a JAX object as numpy arrays (the caller
does ``np.asarray``) and returns the port's object on ``device`` with
floating-point tensors of ``dtype``.  Nested factor objects are passed as
dicts of their fields (``namedtuple._asdict()`` with arrays converted).
This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import CondensedPrepared, LoadCase
from .models.model import JacketModel
from .ops.condense import ChainFactor, NestedChainFactor
from .ops.sections import TubeSections
from .ops.solve import DenseFactor
from .ops.waves import FourierWave


def _float(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def _index(a, device) -> torch.Tensor:
    return torch.tensor(np.array(a, dtype=np.int64), device=device)


def model_from_numpy(coords, conn, sect_id, sections: dict, fixed_mask,
                     top_mask, node_names=(), member_names=(),
                     member_types=(), app_conn=None, release=None,
                     device="cpu",
                     dtype: torch.dtype = torch.float64) -> JacketModel:
    """A :class:`JacketModel` from a JAX model's leaves; ``sections`` maps
    each ``TubeSections`` field name to its array."""
    return JacketModel(
        coords=_float(coords, dtype, device),
        conn=_index(conn, device),
        sect_id=_index(sect_id, device),
        sections=TubeSections(**{k: _float(sections[k], dtype, device)
                                 for k in TubeSections._fields}),
        fixed_mask=torch.tensor(np.array(fixed_mask, bool),
                                   device=device),
        top_mask=torch.tensor(np.array(top_mask, bool), device=device),
        node_names=tuple(node_names), member_names=tuple(member_names),
        member_types=tuple(member_types),
        app_conn=None if app_conn is None else _index(app_conn, device),
        release=None if release is None else _index(release, device))


def wave_from_numpy(k, omega, c, d, U_c, H, T, E, U, clamp_z=False,
                    dt_fd=1e-3, model="airy", order=1, device="cpu",
                    dtype: torch.dtype = torch.float64) -> FourierWave:
    """A :class:`FourierWave` from a JAX wave's leaves."""
    arrays = dict(k=k, omega=omega, c=c, d=d, U_c=U_c, H=H, T=T, E=E, U=U)
    return FourierWave(**{n: _float(v, dtype, device)
                          for n, v in arrays.items()},
                       clamp_z=bool(clamp_z), dt_fd=float(dt_fd),
                       model=str(model), order=int(order))


def case_from_numpy(**fields) -> LoadCase:
    """A :class:`LoadCase` from a JAX case's fields (numeric fields become
    Python floats; cast with :meth:`LoadCase.cast`)."""
    return LoadCase(**{
        name: (v if name in LoadCase._STATIC_FIELDS else float(np.asarray(v)))
        for name, v in fields.items()})


def _chain_factor(f: dict, dtype, device) -> ChainFactor:
    return ChainFactor(**{k: _float(f[k], dtype, device)
                          for k in ChainFactor._fields})


def prepared_from_numpy(coarse: JacketModel, refined: JacketModel, Kg, KT,
                        L_m, fac: dict, dfac: dict, K_I, free, fixed, E, nu,
                        n_seg: int, chain_solver: str, device="cpu",
                        dtype: torch.dtype = torch.float64
                        ) -> CondensedPrepared:
    """A :class:`CondensedPrepared` from a JAX handle's leaves.

    ``fac`` holds the ``ChainFactor`` fields, or for the nested solver
    ``K_super``, ``fac1`` and ``fac2`` (each a ``ChainFactor`` dict);
    ``dfac`` holds the ``DenseFactor`` fields.
    """
    if "fac1" in fac:
        factor = NestedChainFactor(
            K_super=_float(fac["K_super"], dtype, device),
            fac1=_chain_factor(fac["fac1"], dtype, device),
            fac2=_chain_factor(fac["fac2"], dtype, device))
    else:
        factor = _chain_factor(fac, dtype, device)
    dense = DenseFactor(chol=_float(dfac["chol"], dtype, device),
                        scale=_float(dfac["scale"], dtype, device),
                        K_ff=_float(dfac["K_ff"], dtype, device),
                        free_dofs=_index(dfac["free_dofs"], device),
                        n_dof=int(dfac["n_dof"]))
    return CondensedPrepared(
        coarse=coarse, refined=refined, Kg=_float(Kg, dtype, device),
        KT=_float(KT, dtype, device), L_m=_float(L_m, dtype, device),
        fac=factor, dfac=dense, K_I=_float(K_I, dtype, device),
        free=_index(free, device), fixed=_index(fixed, device),
        E=_float(E, dtype, device), nu=_float(nu, dtype, device),
        n_seg=int(n_seg), chain_solver=str(chain_solver))
