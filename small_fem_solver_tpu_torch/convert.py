"""Carry state from the JAX package into this one.

Each function takes the leaves of a JAX object as numpy arrays (the caller
does ``np.asarray``) and returns the port's object on ``device`` (``None``: the CUDA card) with
floating-point tensors of ``dtype``.  Nested factor objects are passed as
dicts of their fields (``namedtuple._asdict()`` with arrays converted).
This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .api import AnalysisResults, CondensedPrepared, LoadCase
from .device import resolve_device
from .models.model import JacketModel
from .ops.condense import ChainFactor, NestedChainFactor
from .ops.metocean import JointHsTp
from .ops.morison import MorisonLoads
from .ops.sections import TubeSections
from .ops.soil import Pile, SoilLayer
from .ops.solve import DenseFactor
from .ops.spectrum import SpectralSea
from .ops.waves import FourierWave


def _float(a, dtype, device) -> torch.Tensor:
    return torch.tensor(np.array(a), dtype=dtype, device=device)


def _index(a, device) -> torch.Tensor:
    return torch.tensor(np.array(a, dtype=np.int64), device=device)


def model_from_numpy(coords, conn, sect_id, sections: dict, fixed_mask,
                     top_mask, node_names=(), member_names=(),
                     member_types=(), app_conn=None, app_D_mm=None,
                     app_cd_mult=None, app_cm_mult=None, app_names=(),
                     release=None, device=None,
                     dtype: torch.dtype = torch.float64) -> JacketModel:
    """A :class:`JacketModel` from a JAX model's leaves; ``sections`` maps
    each ``TubeSections`` field name to its array; the appurtenance and
    release leaves are ``None`` when the model has none."""
    device = resolve_device(device)

    def optional(a, convert):
        return None if a is None else convert(a)
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
        app_conn=optional(app_conn, lambda a: _index(a, device)),
        app_D_mm=optional(app_D_mm, lambda a: _float(a, dtype, device)),
        app_cd_mult=optional(app_cd_mult, lambda a: _float(a, dtype, device)),
        app_cm_mult=optional(app_cm_mult, lambda a: _float(a, dtype, device)),
        app_names=tuple(app_names),
        release=optional(release, lambda a: _index(a, device)))


def wave_from_numpy(k, omega, c, d, U_c, H, T, E, U, clamp_z=False,
                    dt_fd=1e-3, model="airy", order=1, device=None,
                    dtype: torch.dtype = torch.float64) -> FourierWave:
    """A :class:`FourierWave` from a JAX wave's leaves (a batched wave's
    leaves keep their leading case axis)."""
    device = resolve_device(device)
    arrays = dict(k=k, omega=omega, c=c, d=d, U_c=U_c, H=H, T=T, E=E, U=U)
    return FourierWave(**{n: _float(v, dtype, device)
                          for n, v in arrays.items()},
                       clamp_z=bool(clamp_z), dt_fd=float(dt_fd),
                       model=str(model), order=int(order))


def sea_from_numpy(omega, k, a, phi, E, U, d, U_c, Hs, Tp, dir_deg=None,
                   spectrum: str = "jonswap", device=None,
                   dtype: torch.dtype = torch.float64) -> SpectralSea:
    """A :class:`SpectralSea` from a JAX sea's leaves (``dir_deg`` None for
    a long-crested sea)."""
    device = resolve_device(device)
    f = {n: _float(v, dtype, device) for n, v in
         dict(omega=omega, k=k, a=a, phi=phi, E=E, U=U, d=d, U_c=U_c, Hs=Hs,
              Tp=Tp).items()}
    return SpectralSea(**f, dir_deg=None if dir_deg is None
                       else _float(dir_deg, dtype, device), spectrum=spectrum)


def case_from_numpy(**fields) -> LoadCase:
    """A :class:`LoadCase` from a JAX case's fields: scalar numeric fields
    become Python floats, per-case ``[C]`` fields of a case batch float64
    tensors; cast with :meth:`LoadCase.cast`."""
    def numeric(v):
        a = np.asarray(v, np.float64)
        return float(a) if a.ndim == 0 else torch.tensor(a)
    return LoadCase(**{
        name: (v if name in LoadCase._STATIC_FIELDS else numeric(v))
        for name, v in fields.items()})


def _chain_factor(f: dict, dtype, device) -> ChainFactor:
    return ChainFactor(**{k: _float(f[k], dtype, device)
                          for k in ChainFactor._fields})


def prepared_from_numpy(coarse: JacketModel, refined: JacketModel, Kg, KT,
                        L_m, fac: dict, dfac: dict, K_I, free, fixed, E, nu,
                        n_seg: int, chain_solver: str, ks_nodes=None,
                        device=None, dtype: torch.dtype = torch.float64
                        ) -> CondensedPrepared:
    """A :class:`CondensedPrepared` from a JAX handle's leaves.

    ``fac`` holds the ``ChainFactor`` fields, or for the nested solver
    ``K_super``, ``fac1`` and ``fac2`` (each a ``ChainFactor`` dict);
    ``dfac`` holds the ``DenseFactor`` fields; ``ks_nodes`` the foundation
    springs (``None``: clamped).
    """
    device = resolve_device(device)
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
        ks_nodes=None if ks_nodes is None else _float(ks_nodes, dtype,
                                                      device),
        free=_index(free, device), fixed=_index(fixed, device),
        E=_float(E, dtype, device), nu=_float(nu, dtype, device),
        n_seg=int(n_seg), chain_solver=str(chain_solver))


def soil_from_fields(layers) -> list[SoilLayer]:
    """The port's soil profile from a JAX profile's layers, each given as
    a dict of its fields (``dataclasses.asdict``)."""
    return [SoilLayer(**layer) for layer in layers]


def pile_from_fields(**fields) -> Pile:
    """The port's :class:`Pile` from a JAX pile's fields."""
    return Pile(**fields)


def joint_from_fields(**fields) -> JointHsTp:
    """The port's :class:`JointHsTp` from a JAX joint (Hs, Tp) model's
    fields (``_asdict()``): scalars as floats, the bin tables as float64
    numpy arrays (the model is host numpy in both packages)."""
    return JointHsTp(**{k: float(v) if np.ndim(v) == 0
                        else np.array(v, np.float64)
                        for k, v in fields.items()})


def results_from_numpy(fields: dict, device=None,
                       dtype: torch.dtype = torch.float64) -> AnalysisResults:
    """An :class:`AnalysisResults` from a JAX result's fields as numpy
    arrays (``morison`` a dict of the ``MorisonLoads`` fields; ``None``
    fields stay ``None``; the displacement node an index)."""
    device = resolve_device(device)

    def convert(name, v):
        if v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.item() is None):
            return None
        if name == "morison":
            return MorisonLoads(**{k: _float(a, dtype, device)
                                   for k, a in v.items()})
        if name in ("max_displacement_node", "solver_iters"):
            return _index(v, device)
        return _float(v, dtype, device)
    return AnalysisResults(**{name: convert(name, fields.get(name))
                              for name in AnalysisResults._fields})
