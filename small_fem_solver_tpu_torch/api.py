"""Condensed phase-scan entry points: wave -> Morison -> condensed FEM -> stresses.

PyTorch counterpart of the condensed-scan part of
``small_fem_solver_tpu/api.py``.  :func:`phase_scan_condensed` runs a full
FEM solve of a refined jacket at every wave phase through exact chain
condensation (``ops/condense.py``): Morison loads for all phases in one
batch, loads built directly in the chain layout, one multi-RHS condensed
solve plus iterative refinement, member-end forces and von Mises
utilization.

``kinematics='fused'`` (the default) evaluates the loads with the
hand-written CUDA kernel (``ops/hopper_kernels.py``) and needs CUDA
tensors; ``'separable'`` uses its plain PyTorch version.

Load application: topside interface loads split equally over the top
nodes (shear along the wave heading, axial as -Z, torsion and overturning
moments per node); Morison forces on translation DOFs; self-weight
'calculated' (half of each member's weight to each end node), 'custom'
(tonnes * 1000 * g spread over every node) or 'none'.

Every matrix product on the solver path runs in full float32 precision
(TF32 off), the counterpart of the JAX package's "highest" precision.
"""
from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from .constants import G_GRAV
from .models.model import JacketModel
from .ops import condense as condense_mod
from .ops import solve as solve_mod
from .ops.assembly import assemble_dense
from .ops.beams import element_stiffness, matvec12
from .ops.hopper_kernels import morison_phase_batch_cuda
from .ops.morison import hydro_members, morison_phase_batch
from .ops.sections import von_mises_8pt
from .ops.waves import FourierWave

_NOT_PORTED_LOADS = ("is not ported yet (ROADMAP.md, Queue A item 3: model "
                     "and load options)")


@dataclasses.dataclass(frozen=True)
class LoadCase:
    """Load-case parameters.  Numeric fields are numbers or 0-d tensors
    (:meth:`cast` makes them tensors); ``sw_mode`` and the options after it
    are static settings."""

    E: float = 210000.0            # MPa
    nu: float = 0.3
    fy: float = 355.0              # MPa
    rho_water: float = 1025.0      # kg/m^3
    wave_dir_deg: float = 0.0      # compass, deg from North clockwise
    current_dir_deg: float = 0.0
    Cd: float = 0.7
    Cm: float = 2.0
    F_axial_kN: float = 0.0        # topside axial (compression +down)
    F_shear_kN: float = 0.0        # topside shear along wave heading
    M_moment_kNm: float = 0.0      # overturning moment
    M_torsion_kNm: float = 0.0     # torsion
    custom_sw_tonnes: float = 0.0  # used when sw_mode == 'custom'
    t_analysis: float = 0.0        # wave phase time [s]
    marine_growth_mm: float = 0.0  # adds 2 t to the hydrodynamic diameter
    # static:
    sw_mode: str = "custom"        # 'custom' | 'calculated' | 'none'
    buoyancy: str = "none"         # only 'none' is ported
    slam_cs: float = 0.0           # slamming: pointwise paths only
    wind_speed_ms: float = 0.0     # only 0 (no wind) is ported
    wind_dir_deg: float = 0.0
    wind_Cs: float = 0.5
    wind_topside_area_m2: float = 0.0
    wind_topside_Cs: float = 1.0

    _STATIC_FIELDS = ("sw_mode", "buoyancy", "slam_cs", "wind_speed_ms",
                      "wind_dir_deg", "wind_Cs", "wind_topside_area_m2",
                      "wind_topside_Cs")

    def cast(self, dtype: torch.dtype, device="cpu") -> "LoadCase":
        """Numeric fields as 0-d tensors of ``dtype`` on ``device``."""
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name), dtype=dtype,
                                    device=device)
            for f in dataclasses.fields(self)
            if f.name not in LoadCase._STATIC_FIELDS})


class CondensedScanResults(NamedTuple):
    """Results of a condensed multi-phase scan (leading axis = phase)."""

    ts: torch.Tensor               # [S] phase times
    U: torch.Tensor                # [S, n_dof_refined] displacements (mm/rad)
    von_mises: torch.Tensor        # [S, M_refined] MPa
    utilization: torch.Tensor      # [S, M_refined]
    reactions: torch.Tensor        # [S, n_fixed, 6]
    total_morison: torch.Tensor    # [S, 3] N
    critical_index: torch.Tensor   # argmax_s max_m utilization


@dataclasses.dataclass(frozen=True)
class CondensedPrepared:
    """Case-independent factorization handle for repeated condensed scans:
    everything that depends only on (model, E, nu) — the refined element
    stiffness, the chain factorization, the interface Cholesky and the
    stress-recovery fold."""

    coarse: JacketModel
    refined: JacketModel
    Kg: torch.Tensor         # [Mr, 12, 12] element stiffness (solve dtype)
    KT: torch.Tensor         # [Mr, 12, 12] K_local @ T recovery fold
    L_m: torch.Tensor        # [Mr] refined element lengths [m]
    fac: object              # ChainFactor / NestedChainFactor
    dfac: solve_mod.DenseFactor
    K_I: torch.Tensor        # [6 nc, 6 nc] interface stiffness
    free: torch.Tensor
    fixed: torch.Tensor
    E: torch.Tensor
    nu: torch.Tensor
    n_seg: int
    chain_solver: str


@contextlib.contextmanager
def _full_f32_matmul():
    """Full float32 matrix products (no TF32) for the enclosed solver work."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev[1])
        torch.backends.cuda.matmul.allow_tf32 = prev[0]


def _topside_per_node(case: LoadCase, top_mask, dtype) -> torch.Tensor:
    """Per-top-node interface load [6] (N / N*mm); ``case`` is cast."""
    top = top_mask.to(dtype)
    # no top nodes: interface loads are dropped instead of giving 0/0
    n_top = torch.clamp(torch.sum(top), min=1.0)
    theta = torch.deg2rad(90.0 - case.wave_dir_deg)
    F_shear_N = case.F_shear_kN * 1000.0
    return torch.stack([
        F_shear_N * torch.cos(theta) / n_top,
        F_shear_N * torch.sin(theta) / n_top,
        -(case.F_axial_kN * 1000.0) / n_top,
        case.M_torsion_kNm * 1e6 / n_top,
        case.M_moment_kNm * 1e6 / n_top,
        torch.zeros_like(theta),
    ])


def _check_refined_layout(coarse: JacketModel, refined: JacketModel,
                          n_seg: int) -> None:
    """The condensation solver requires refine_model's member-major layout."""
    Mc = coarse.n_members
    if (refined.n_members != Mc * n_seg
            or refined.n_nodes != coarse.n_nodes + Mc * (n_seg - 1)):
        raise ValueError(
            "refined model does not match refine_model(coarse, n_seg) sizes")
    rc = refined.conn.cpu().numpy()
    cc = coarse.conn.cpu().numpy()
    if not (np.array_equal(rc[::n_seg, 0], cc[:, 0])
            and np.array_equal(rc[n_seg - 1::n_seg, 1], cc[:, 1])):
        raise ValueError(
            "refined model connectivity is not in refine_model's "
            "member-major chain layout")


def _resolve_chain_solver(n_seg: int, chain_solver: str) -> str:
    """'auto' -> 'nested' when n_seg >= 16 and composite, else 'thomas'."""
    if chain_solver == "auto":
        chain_solver = "thomas"
        if n_seg >= 16:
            try:
                condense_mod.nested_split(n_seg)
            except ValueError:
                pass  # prime depth: no balanced split, keep thomas
            else:
                chain_solver = "nested"
    if chain_solver not in ("thomas", "nested"):
        raise ValueError(f"unknown chain_solver {chain_solver!r}")
    return chain_solver


def _chain_fns(chain_solver: str):
    """(factor_fn, condense_fn, backsub_fn) for a resolved chain solver."""
    if chain_solver == "thomas":
        return (condense_mod.factor_chains, condense_mod.condense_loads,
                condense_mod.back_substitute)
    return (condense_mod.factor_chains_nested,
            condense_mod.condense_loads_nested,
            condense_mod.back_substitute_nested)


def _chain_layout_loads(coarse: JacketModel, refined: JacketModel,
                        case: LoadCase, F1, F2, L_m, n_seg: int):
    """Load vectors built directly in the condensed solver's chain layout.

    Chain node p joins element p-1's far end and element p's near end, so
    every interior load is a slice sum; only the 2 Mc chain ends go onto
    the coarse interface nodes.  ``F1``/``F2``: [S, Mr, 3] Morison member
    end forces (N); ``L_m``: [Mr] refined element lengths (m).
    Returns (F_I_nodes [S, nc, 6], g [S, n_int, Mc, 6]).
    """
    if case.buoyancy != "none":
        raise NotImplementedError(f"buoyancy {_NOT_PORTED_LOADS}")
    if case.wind_speed_ms:
        raise NotImplementedError(f"wind loading {_NOT_PORTED_LOADS}")
    dtype = F1.dtype
    nc, Mc = coarse.n_nodes, coarse.n_members
    S = F1.shape[0]
    F1c = F1.reshape(S, Mc, n_seg, 3)
    F2c = F2.reshape(S, Mc, n_seg, 3)

    g3 = F2c[:, :, :-1] + F1c[:, :, 1:]                 # [S, Mc, n_int, 3]
    g = torch.cat([g3, torch.zeros_like(g3)], dim=-1)

    per_top = _topside_per_node(case, coarse.top_mask, dtype)
    top = coarse.top_mask.to(dtype)
    F_I = (top[:, None] * per_top[None, :]).expand(S, nc, 6).clone()
    nodes = torch.cat([coarse.conn[:, 0], coarse.conn[:, 1]])
    ends = torch.cat([F1c[:, :, 0], F2c[:, :, -1]], dim=1)   # [S, 2Mc, 3]
    F_I[..., :3] += condense_mod.node_sum(ends, nodes, nc)

    if case.sw_mode == "calculated":
        mass_per_m = refined.sections.mass_per_m[refined.sect_id]
        half = (mass_per_m.to(dtype) * G_GRAV * L_m.to(dtype)
                / 2.0).reshape(Mc, n_seg)                   # N
        g[..., 2] += -(half[:, :-1] + half[:, 1:])
        wI = condense_mod.node_sum(
            torch.cat([half[:, 0], half[:, -1]])[:, None], nodes, nc)
        F_I[..., 2] += -wI[:, 0]
    elif case.sw_mode == "custom":
        per_node = case.custom_sw_tonnes * 1000.0 * G_GRAV / refined.n_nodes
        g[..., 2] += -per_node
        F_I[..., 2] += -per_node
    elif case.sw_mode != "none":
        raise ValueError(f"unknown self-weight mode {case.sw_mode!r}")
    return F_I, g.transpose(1, 2)


def _ssi_spring_nodes(coarse: JacketModel, support_stiffness):
    """(free_np, fixed_np) DOF index arrays of the clamped supports;
    foundation springs (SSI) are not ported yet."""
    if support_stiffness is not None:
        raise NotImplementedError(
            f"foundation springs (support_stiffness) {_NOT_PORTED_LOADS}")
    return solve_mod.free_fixed_dofs(coarse.fixed_mask)


def _refine_mask(coarse: JacketModel, solve_dtype):
    """Free-equation mask [nc, 6] for the refinement residual."""
    return solve_mod.dof_free_mask(coarse.fixed_mask).to(solve_dtype) \
        .reshape(coarse.n_nodes, 6)


def _condensed_solve(F_I_nodes, g, fac, dfac, _condense, _backsub, node1,
                     node2):
    """One condensed direct solve in the chain layout.

    Returns (U_In [S, nc, 6], v [S, n_int, Mc, 6], F_cond_flat [S, 6 nc],
    U_I [S, 6 nc]).
    """
    S, nc = F_I_nodes.shape[:2]
    fI, fJ, v_g = _condense(fac, g)
    F_cond = F_I_nodes + condense_mod.node_sum(
        torch.cat([fI, fJ], dim=1), torch.cat([node1, node2]), nc)
    F_cond_flat = F_cond.reshape(S, -1)
    U_I = solve_mod.solve_factored(dfac, F_cond_flat)
    U_In = U_I.reshape(S, nc, 6)
    v = _backsub(fac, v_g, U_In[:, node1], U_In[:, node2])
    return U_In, v, F_cond_flat, U_I


def _refine_condensed(Kg, n_seg, conn_coarse, fixed_free_mask, solve_once,
                      F_I_nodes, g, U_In, v, U_I, refine_steps):
    """Iterative refinement in the chain layout: residual via
    ``chain_matvec``, one more condensed solve per round."""
    for _ in range(refine_steps):
        y_I, y_int = condense_mod.chain_matvec(Kg, n_seg, conn_coarse,
                                               U_In, v)
        r_I = (F_I_nodes - y_I) * fixed_free_mask      # fixed rows -> 0
        dU_In, dv, _, dU_I = solve_once(r_I, g - y_int)
        U_In, v, U_I = U_In + dU_In, v + dv, U_I + dU_I
    return U_In, v, U_I


def _condensed_rows(coarse, n_seg, chain_solver, solve_dtype, refine_steps,
                    Kg, KT6, fac, dfac, K_I, F_I_nodes, g):
    """Condensed multi-RHS solve + linear recovery: full displacement
    vectors, member node-1 end forces and interface reaction rows."""
    S = F_I_nodes.shape[0]
    node1, node2 = coarse.conn[:, 0], coarse.conn[:, 1]
    _condense, _backsub = _chain_fns(chain_solver)[1:]
    solve_once = partial(_condensed_solve, fac=fac, dfac=dfac,
                         _condense=_condense, _backsub=_backsub,
                         node1=node1, node2=node2)
    U_In, v, F_cond_flat, U_I = solve_once(F_I_nodes, g)
    if refine_steps > 0:
        U_In, v, U_I = _refine_condensed(
            Kg, n_seg, coarse.conn, _refine_mask(coarse, solve_dtype),
            solve_once, F_I_nodes, g, U_In, v, U_I, refine_steps)

    U = torch.cat([U_In.reshape(S, -1),
                   v.transpose(1, 2).reshape(S, -1)], dim=1)

    # von Mises needs only the node-1 end forces F1 = -(K_local T u)[:6];
    # element displacement vectors come straight from the chain layout
    vext = torch.cat([U_In[:, node1][:, None], v, U_In[:, node2][:, None]],
                     dim=1)
    u_e = torch.cat([vext[:, :-1], vext[:, 1:]], dim=-1)
    u_elem = u_e.transpose(1, 2).reshape(S, -1, 12)        # member-major
    F1 = matvec12(KT6, u_elem)                             # [S, Mr, 6]
    R = U_I @ K_I.T - F_cond_flat                          # [S, 6 nc]
    return U, F1, R


def _condensed_tail(coarse, refined, case, n_seg, ts, chain_solver,
                    solve_dtype, refine_steps, fixed, Kg, KT6, fac, dfac,
                    K_I, F_I_nodes, g, total_morison):
    """Condensed solve + recovery from chain-layout loads."""
    S = ts.shape[0]
    U, F1, R = _condensed_rows(coarse, n_seg, chain_solver, solve_dtype,
                               refine_steps, Kg, KT6, fac, dfac, K_I,
                               F_I_nodes, g)
    vm = von_mises_8pt(refined.sections.to(solve_dtype), refined.sect_id,
                       *(F1[..., c] for c in range(6)))
    util = vm / case.fy
    return CondensedScanResults(
        ts=ts, U=U, von_mises=vm, utilization=util,
        reactions=R[:, fixed].reshape(S, -1, 6),
        total_morison=total_morison,
        critical_index=torch.argmax(torch.amax(util, dim=1)))


def _condensed_scan_body(coarse, refined, wave: FourierWave, case, n_seg,
                         n_steps, n_gauss, kinematics, chain_solver,
                         solve_dtype, refine_steps, stretching,
                         current_alpha, fixed, Kg, KT6, L_m, fac, dfac, K_I):
    """Per-scan (wave/case-dependent) work of the condensed phase scan."""
    ldtype, device = refined.dtype, refined.device
    ts = (torch.arange(n_steps, dtype=ldtype, device=device)
          * wave.T.to(ldtype) / n_steps)
    case_l = case.cast(ldtype, device)
    if case_l.slam_cs:
        raise ValueError(
            "slamming (slam_cs > 0) runs on the pointwise kinematics paths "
            "only — the crossing-band impact term does not separate over the "
            "phase matmul")
    conn_h, D_m, Cd_h, Cm_h = hydro_members(refined, case_l.marine_growth_mm,
                                            case_l.Cd, case_l.Cm)
    if kinematics == "fused":
        batch_fn = morison_phase_batch_cuda
    elif kinematics == "separable":
        batch_fn = morison_phase_batch
    elif kinematics == "pointwise":
        raise NotImplementedError(
            "kinematics='pointwise' is not ported yet (ROADMAP.md, Queue A "
            "item 2: pointwise kinematics and analyze)")
    else:
        raise ValueError(f"unknown kinematics mode {kinematics!r}")
    mb = batch_fn(wave, refined.coords, conn_h, D_m, case_l.wave_dir_deg,
                  case_l.current_dir_deg, Cd_h, Cm_h, case_l.rho_water, ts,
                  n_gauss=n_gauss, current_alpha=current_alpha,
                  stretching=stretching)
    F_I_nodes, g = _chain_layout_loads(coarse, refined, case_l,
                                       mb.F1.to(ldtype), mb.F2.to(ldtype),
                                       L_m.to(ldtype), n_seg)
    return _condensed_tail(coarse, refined, case, n_seg, ts, chain_solver,
                           solve_dtype, refine_steps, fixed, Kg, KT6, fac,
                           dfac, K_I, F_I_nodes.to(solve_dtype),
                           g.to(solve_dtype), mb.total_morison.to(ldtype))


def prepare_condensed(coarse: JacketModel, refined: JacketModel, n_seg: int,
                      E=210000.0, nu=0.3, chain_solver: str = "auto",
                      solve_dtype: torch.dtype = torch.float64,
                      support_stiffness=None) -> CondensedPrepared:
    """Factor the case-independent part of the condensed scan once: the
    refined element stiffness, the chain factorization, the interface
    Cholesky and the recovery fold depend only on (model, E, nu)."""
    _check_refined_layout(coarse, refined, n_seg)
    free_np, fixed_np = _ssi_spring_nodes(coarse, support_stiffness)
    resolved = _resolve_chain_solver(n_seg, chain_solver)
    device = refined.device
    free = torch.as_tensor(free_np, device=device)
    fixed = torch.as_tensor(fixed_np, device=device)
    E = torch.as_tensor(E, dtype=solve_dtype, device=device)
    nu = torch.as_tensor(nu, dtype=solve_dtype, device=device)
    with _full_f32_matmul():
        G = E / (2.0 * (1.0 + nu))
        Kg, K_local, T, L_m = element_stiffness(
            refined.coords.to(solve_dtype), refined.conn,
            refined.sections.to(solve_dtype), refined.sect_id, E, G)
        fac = _chain_fns(resolved)[0](Kg, n_seg)
        K_I = assemble_dense(fac.K_super, coarse.conn, 6 * coarse.n_nodes)
        dfac = solve_mod.factor_dense(K_I, free)
        KT = K_local @ T
    return CondensedPrepared(
        coarse=coarse, refined=refined, Kg=Kg, KT=KT, L_m=L_m, fac=fac,
        dfac=dfac, K_I=K_I, free=free, fixed=fixed, E=E, nu=nu,
        n_seg=n_seg, chain_solver=resolved)


def _scan_prepared(prep: CondensedPrepared, wave, case: LoadCase, n_steps,
                   n_gauss, kinematics, refine_steps, stretching,
                   current_alpha) -> CondensedScanResults:
    with _full_f32_matmul():
        return _condensed_scan_body(
            prep.coarse, prep.refined, wave, case, prep.n_seg, n_steps,
            n_gauss, kinematics, prep.chain_solver, prep.K_I.dtype,
            refine_steps, stretching, current_alpha, prep.fixed, prep.Kg,
            -prep.KT[:, :6, :], prep.L_m, prep.fac, prep.dfac, prep.K_I)


def phase_scan_prepared(prep: CondensedPrepared, wave, case: LoadCase,
                        n_steps: int = 360, n_gauss: int = 15,
                        kinematics: str = "fused", refine_steps: int = 1,
                        stretching: str = "none",
                        current_alpha=None) -> CondensedScanResults:
    """Condensed phase scan through a :func:`prepare_condensed` handle:
    only the wave/case-dependent work runs.  ``case.E``/``case.nu`` must
    match the handle (raises on mismatch)."""
    solve_dtype = prep.K_I.dtype
    for name in ("E", "nu"):
        # compare in the handle's dtype (0.3 in f64 against an f32 handle
        # must not trip on representation rounding)
        want = getattr(prep, name).cpu()
        got = torch.as_tensor(getattr(case, name)).to(want.dtype).cpu()
        if not torch.allclose(got, want, rtol=1e-6):
            raise ValueError(
                f"case.{name} ({float(got)!r}) does not match the prepared "
                f"factorization's {name} ({float(want)!r}); re-run "
                "prepare_condensed for a new material")
    return _scan_prepared(prep, wave, case.cast(solve_dtype,
                                                prep.refined.device),
                          n_steps, n_gauss, kinematics, refine_steps,
                          stretching, current_alpha)


def phase_scan_condensed(coarse: JacketModel, refined: JacketModel,
                         n_seg: int, wave: FourierWave, case: LoadCase,
                         n_steps: int = 360, n_gauss: int = 15,
                         kinematics: str = "fused",
                         chain_solver: str = "auto",
                         solve_dtype: torch.dtype = torch.float64,
                         refine_steps: int = 1, stretching: str = "none",
                         current_alpha=None,
                         support_stiffness=None) -> CondensedScanResults:
    """Full FEM phase scan of a refined jacket via exact chain condensation.

    Loads are evaluated in the model dtype; the condensation, solve and
    recovery run in ``solve_dtype``.  ``refined`` must come from
    ``refine_model(coarse, n_seg)``.  ``refine_steps`` rounds of iterative
    refinement follow the direct solve.

    Repeated calls with the same model objects and material reuse the
    case-independent factorization (a bounded identity-keyed cache of
    :func:`prepare_condensed` handles, up to 4 models); use
    :func:`prepare_condensed` + :func:`phase_scan_prepared` to manage the
    handle explicitly.
    """
    _check_refined_layout(coarse, refined, n_seg)
    prep = _cached_prepared(coarse, refined, n_seg, case, chain_solver,
                            solve_dtype, support_stiffness)
    return _scan_prepared(prep, wave, case.cast(solve_dtype, refined.device),
                          n_steps, n_gauss, kinematics, refine_steps,
                          stretching, current_alpha)


_PREP_CACHE: dict = {}


def _cached_prepared(coarse, refined, n_seg, case, chain_solver, solve_dtype,
                     support_stiffness) -> CondensedPrepared:
    """prepare_condensed memoized on model identity + material + solver
    config (bounded; holds strong model references so the id keys stay
    valid)."""
    key = (id(coarse), id(refined), n_seg, float(case.E), float(case.nu),
           chain_solver, str(solve_dtype))
    hit = _PREP_CACHE.get(key)
    if hit is None:
        if len(_PREP_CACHE) >= 4:
            _PREP_CACHE.clear()
        prep = prepare_condensed(coarse, refined, n_seg, E=case.E,
                                 nu=case.nu, chain_solver=chain_solver,
                                 solve_dtype=solve_dtype,
                                 support_stiffness=support_stiffness)
        hit = (coarse, refined, prep)
        _PREP_CACHE[key] = hit
    return hit[2]
