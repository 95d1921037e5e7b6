"""Analysis entry points: wave -> Morison -> FEM -> stresses (PyTorch
counterpart of ``small_fem_solver_tpu/api.py``).

- :func:`analyze` is the reference's single static analysis: pointwise
  Morison loads at ``case.t_analysis``, dense assembly, LU (with an
  optional least-squares fallback) or Cholesky solve, reactions, member
  end forces and von Mises utilization; with ``solver='pcg'`` the
  assembly is block-sparse (BCSR) and the solve matrix-free
  preconditioned CG (block-Jacobi or two-level), for meshes a dense
  solve cannot hold.  :func:`analyze_phase_batch` factors K once and
  solves every phase of one wave period.
- :func:`analyze_condensed` (one-shot) and :func:`analyze_prepared`
  (through a :func:`prepare_condensed` handle) run the same analysis on a
  refined jacket through exact chain condensation (``ops/condense.py``),
  the ~100k-DOF path.
- :func:`phase_scan_condensed` runs a full FEM solve of a refined jacket at
  every wave phase through the condensation: Morison loads for all phases
  in one batch, one multi-RHS condensed solve plus iterative refinement,
  member-end forces and von Mises utilization.
  :func:`design_envelope_condensed` runs that scan for a batch of wave
  cases on one case-independent factorization and keeps only the
  utilization reductions.

- :func:`sea_scan_prepared` / :func:`sea_response_batch` solve the full
  FEM at every sample of a random sea (``ops/spectrum.py``);
  :func:`spectral_transfer_prepared` / :func:`spectral_response_prepared`
  and their Craig-Bampton ``*_dynamic`` forms give its frequency-domain
  statistics (``ops/freqdomain.py``); :func:`scatter_fatigue`,
  :func:`scatter_fatigue_spectral` and :func:`long_term_extremes` sum
  them over a scatter diagram.

``kinematics='fused'`` (the default of the scan and the envelope; the
JAX package's name ``'pallas'`` is an alias) evaluates the loads in the
model's dtype: with the hand-written CUDA kernel (``ops/hopper_kernels.py``,
its float32 or float64 instance) on CUDA tensors, and with its plain
PyTorch version on the CPU, where it equals ``'separable'`` (the plain
version everywhere, the JAX package's default); both build the loads
directly in the chain layout.  Past the
kernel's limits (more than 32 wave modes or 16 Gauss points) ``'fused'``
runs the plain version on the card too, as the JAX package's default
does, while ``'pallas'`` raises there, as the JAX kernel path does.
``'pointwise'`` evaluates the kinematics per phase with the reference's
exact semantics (``accel``, the evaluation-height clamp, slamming), as
:func:`analyze` does, as member end forces in the chain layout: with the
pointwise CUDA kernel on CUDA tensors (any number of Gauss points and
modes) and its plain version on the CPU.  On CUDA tensors the condensed
solves always run the chain-sweep kernel.

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
import math
import warnings
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from .constants import G_GRAV
from .device import resolve_device
from .models.model import JacketModel
from .ops import coarse as coarse_mod
from .ops import condense as condense_mod
from .ops import solve as solve_mod
from .ops.assembly import (assemble_bcsr, assemble_dense, bcsr_block_diagonal,
                           bcsr_matvec, build_bcsr_pattern,
                           element_dof_indices, node_gather_table,
                           node_sum_ordered)
from .ops.beams import element_stiffness, internal_forces, matvec12
from .ops.buckling import element_geometric_stiffness, model_release_W
from .ops.fatigue import SECONDS_PER_YEAR
from .ops.hopper_kernels import (cast_operands, kernel_route,
                                 morison_end_forces_batch_cuda,
                                 morison_end_forces_cuda,
                                 morison_pointwise_end_forces_cuda,
                                 morison_sea_end_forces_cuda)
from .ops.morison import (POINTWISE_CHUNK_ELEMS, MorisonLoads, hydro_members,
                          morison_end_forces, morison_end_forces_batch,
                          morison_loads)
from .ops.sections import TubeSections, normal_stress_8pt, von_mises_8pt
from .ops.spectrum import (SpectralSea, make_random_sea, morison_sea_batch,
                           morison_sea_end_forces, spectral_fatigue_screen)
from .ops.waves import FourierWave
from .ops.wind import (wind_member_ends, wind_member_forces,
                       wind_topside_force)
from .parallel import comm
from .utils import spans
from .utils.persist import _case_slice

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
    buoyancy: str = "none"         # 'none' | 'sealed' | 'flooded' |
                                   # 'legs-flooded'
    slam_cs: float = 0.0           # slamming: pointwise paths only
    wind_speed_ms: float = 0.0     # 1-hour mean at 10 m; 0: no wind
    wind_dir_deg: float = 0.0
    wind_Cs: float = 0.5
    wind_topside_area_m2: float = 0.0
    wind_topside_Cs: float = 1.0

    _STATIC_FIELDS = ("sw_mode", "buoyancy", "slam_cs", "wind_speed_ms",
                      "wind_dir_deg", "wind_Cs", "wind_topside_area_m2",
                      "wind_topside_Cs")

    def cast(self, dtype: torch.dtype, device=None) -> "LoadCase":
        """Numeric fields as 0-d tensors of ``dtype`` on ``device``
        (``None``: the CUDA card, :func:`..device.resolve_device`)."""
        device = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(getattr(self, f.name), dtype=dtype,
                                    device=device)
            for f in dataclasses.fields(self)
            if f.name not in LoadCase._STATIC_FIELDS})

    def case(self, i: int) -> "LoadCase":
        """Case ``i`` of a batch (see ``parallel.sweep.make_case_batch``):
        every ``[C]`` numeric field is indexed, scalars stay."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name)[i]
            for f in dataclasses.fields(self)
            if f.name not in LoadCase._STATIC_FIELDS
            and torch.is_tensor(getattr(self, f.name))
            and getattr(self, f.name).ndim > 0})


class AnalysisResults(NamedTuple):
    """Results of one analysis (units noted per field); a phase batch
    carries a leading phase axis on every field."""

    U: torch.Tensor                # [n_dof] displacements, mm / rad
    reactions: torch.Tensor        # [n_fixed_nodes, 6] N / N*mm
    F_applied: torch.Tensor        # [n_dof] assembled load vector, N / N*mm
    F1_local: torch.Tensor         # [M, 6] node-1 end forces (local axes)
    F2_local: torch.Tensor         # [M, 6] node-2 end forces (local axes)
    von_mises: torch.Tensor        # [M] max over 8 points at node 1, MPa
    utilization: torch.Tensor      # [M] von_mises / fy
    length_m: torch.Tensor         # [M]
    morison: MorisonLoads
    max_displacement_mm: torch.Tensor
    max_displacement_node: torch.Tensor   # int index
    total_reaction: torch.Tensor   # [6] sums of reaction components
    # iterations and relative residual of the PCG solve (solver='pcg');
    # the P-delta amplification (analyze_pdelta, analyze_pdelta_condensed)
    solver_iters: torch.Tensor | None = None
    solver_residual: torch.Tensor | None = None
    pdelta_amplification: torch.Tensor | None = None


class CondensedScanResults(NamedTuple):
    """Results of a condensed multi-phase scan (leading axis = phase)."""

    ts: torch.Tensor               # [S] phase times
    U: torch.Tensor                # [S, n_dof_refined] displacements (mm/rad)
    von_mises: torch.Tensor        # [S, M_refined] MPa
    utilization: torch.Tensor      # [S, M_refined]
    reactions: torch.Tensor        # [S, n_fixed, 6]
    total_morison: torch.Tensor    # [S, 3] N
    critical_index: torch.Tensor   # argmax_s max_m utilization


class EnvelopeResults(NamedTuple):
    """Design-envelope results over a case batch (leading axis = case)."""

    ts: torch.Tensor                  # [C, S] phase times (periods differ)
    utilization: torch.Tensor | None  # None: the condensed envelope keeps
                                      # only the reductions below
    max_util_per_phase: torch.Tensor  # [C, S]
    max_util_per_case: torch.Tensor   # [C]
    critical_phase: torch.Tensor      # [C] phase index of each case's max
    governing_case: torch.Tensor      # [] argmax over cases
    member_envelope: torch.Tensor     # [M] max utilization over all cases+phases
    total_morison: torch.Tensor       # [C, S, 3]


@dataclasses.dataclass(frozen=True)
class CondensedPrepared:
    """Case-independent factorization handle for repeated condensed scans:
    everything that depends only on (model, E, nu, foundation springs) —
    the refined element stiffness, the chain factorization, the interface
    Cholesky and the stress-recovery fold."""

    coarse: JacketModel
    refined: JacketModel
    Kg: torch.Tensor         # [Mr, 12, 12] element stiffness (solve dtype)
    KT: torch.Tensor         # [Mr, 12, 12] K_local @ T recovery fold
    L_m: torch.Tensor        # [Mr] refined element lengths [m]
    fac: object              # ChainFactor / NestedChainFactor
    dfac: solve_mod.DenseFactor  # of the spring-grounded interface system
    K_I: torch.Tensor        # [6 nc, 6 nc] springless interface stiffness
    ks_nodes: torch.Tensor | None  # [nc, 6] foundation springs, or None
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


def _member_buoyancy(coords, conn, sec: TubeSections, sect_id, member_types,
                     rho_water, mode: str, L_m):
    """Still-water buoyant uplift per member: (F_b [M] in N, +up; c [M],
    the wetted span's centroid in [0, 1] from node 1).

    The displaced area is the full pi D^2 / 4 of a 'sealed' member and the
    steel annulus of a 'flooded' one ('legs-flooded' floods the legs and
    seals the rest), on the bare steel OD (marine growth earns no credit).
    """
    dtype = coords.dtype
    D_m = sec.D_outer[sect_id] / 1000.0
    A_sealed = math.pi * D_m**2 / 4.0                      # m^2
    A_flooded = sec.Ax[sect_id] * 1e-6
    if mode == "sealed":
        A = A_sealed
    elif mode == "flooded":
        A = A_flooded
    elif mode == "legs-flooded":
        types = member_types or ("brace",) * conn.shape[0]
        is_leg = torch.tensor([t == "leg" for t in types],
                              device=coords.device)
        A = torch.where(is_leg, A_flooded, A_sealed)
    else:
        raise ValueError(f"unknown buoyancy mode {mode!r}; use "
                         "'none', 'sealed', 'flooded' or 'legs-flooded'")
    # wetted parameter span [a, b] of z(t) < 0, t from node 1 to node 2
    z1, z2 = coords[conn[:, 0], 2], coords[conn[:, 1], 2]
    slope = z2 - z1
    near0 = torch.abs(slope) < 1e-9
    t0 = -z1 / torch.where(near0, torch.ones_like(slope), slope)
    tc = torch.clamp(t0, 0.0, 1.0)
    zero, one = torch.zeros_like(slope), torch.ones_like(slope)
    a = torch.where(near0, zero, torch.where(slope > 0, zero, tc))
    b = torch.where(near0, (z1 < 0.0).to(dtype),
                    torch.where(slope > 0, tc, one))
    wet = torch.clamp(b - a, min=0.0)
    c = torch.where(wet > 0, (a + b) / 2.0, 0.5 * one)
    F_b = rho_water * G_GRAV * A * L_m * wet               # N, +up
    return F_b.to(dtype), c.to(dtype)


def _wind_topside(coords, top_mask, case: LoadCase, dtype):
    """Per-top-node wind block force (Fx, Fy) in N and the top mask."""
    top = top_mask.to(dtype)
    n_top = torch.clamp(torch.sum(top), min=1.0)
    z_top = torch.sum(coords[:, 2].to(dtype) * top) / n_top
    per = wind_topside_force(case.wind_speed_ms, case.wind_topside_area_m2,
                             z_top, Cs=case.wind_topside_Cs).to(dtype) / n_top
    th = math.radians(90.0 - case.wind_dir_deg)
    return top * per * math.cos(th), top * per * math.sin(th)


def assemble_loads(model: JacketModel, case: LoadCase,
                   morison_nodal: torch.Tensor,
                   L_m: torch.Tensor) -> torch.Tensor:
    """Global load vector [..., n_dof] (N / N*mm) from the Morison nodal
    forces [..., n_nodes, 3] (a leading phase axis rides along): topside
    interface loads, Morison forces on the translation DOFs, self-weight,
    still-water buoyancy and wind (steady: the same for every phase).
    ``case`` must be cast (:meth:`LoadCase.cast`) to the model's dtype and
    device.  Nodal sums run in a fixed order."""
    dtype, n = model.dtype, model.n_nodes
    batch = morison_nodal.shape[:-2]
    top = model.top_mask.to(dtype)
    per_top = _topside_per_node(case, model.top_mask, dtype)
    F = (top[:, None] * per_top[None, :]).expand(*batch, n, 6).clone()
    F[..., :3] += morison_nodal
    table = None
    if case.sw_mode == "calculated" or case.buoyancy != "none":
        table = node_gather_table(torch.cat([model.conn[:, 0],
                                             model.conn[:, 1]]), n)
    if case.sw_mode == "calculated":
        half = (model.sections.mass_per_m[model.sect_id] * G_GRAV * L_m
                / 2.0)                                         # N
        F[..., 2] -= node_sum_ordered(torch.cat([half, half])[:, None],
                                      table)[:, 0]
    elif case.sw_mode == "custom":
        F[..., 2] -= case.custom_sw_tonnes * 1000.0 * G_GRAV / n
    elif case.sw_mode != "none":
        raise ValueError(f"unknown self-weight mode {case.sw_mode!r}")
    if case.buoyancy != "none":
        F_b, c = _member_buoyancy(model.coords, model.conn, model.sections,
                                  model.sect_id, model.member_types,
                                  case.rho_water, case.buoyancy, L_m)
        F[..., 2] += node_sum_ordered(
            torch.cat([F_b * (1.0 - c), F_b * c])[:, None], table)[:, 0]
    if case.wind_speed_ms:
        D_struct = model.sections.D_outer[model.sect_id] / 1000.0
        F[..., :3] += wind_member_forces(model.coords, model.conn, D_struct,
                                         case.wind_speed_ms,
                                         case.wind_dir_deg,
                                         Cs=case.wind_Cs)[0]
        if case.wind_topside_area_m2:
            fx, fy = _wind_topside(model.coords, model.top_mask, case, dtype)
            F[..., 0] += fx
            F[..., 1] += fy
    return F.reshape(*batch, -1)


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
    the coarse interface nodes.  ``F1``/``F2``: [S, Mr + A, 3] Morison
    member end forces (N), the A appurtenance rows last (their end forces
    go to their coarse guide nodes); ``L_m``: [Mr] refined element lengths
    (m).  Self-weight, buoyancy and wind are spread over the refined mesh.
    Returns (F_I_nodes [S, nc, 6], g [S, n_int, Mc, 6]).
    """
    dtype = F1.dtype
    nc, Mc = coarse.n_nodes, coarse.n_members
    S, Mr = F1.shape[0], Mc * n_seg
    F1c = F1[:, :Mr].reshape(S, Mc, n_seg, 3)
    F2c = F2[:, :Mr].reshape(S, Mc, n_seg, 3)

    g3 = F2c[:, :, :-1] + F1c[:, :, 1:]                 # [S, Mc, n_int, 3]
    g = torch.cat([g3, torch.zeros_like(g3)], dim=-1)

    per_top = _topside_per_node(case, coarse.top_mask, dtype)
    top = coarse.top_mask.to(dtype)
    F_I = (top[:, None] * per_top[None, :]).expand(S, nc, 6).clone()
    nodes = torch.cat([coarse.conn[:, 0], coarse.conn[:, 1]])
    ends = torch.cat([F1c[:, :, 0], F2c[:, :, -1]], dim=1)   # [S, 2Mc, 3]
    end_nodes = nodes
    if F1.shape[1] > Mr:   # appurtenance end forces -> their guide nodes
        ends = torch.cat([ends, F1[:, Mr:], F2[:, Mr:]], dim=1)
        end_nodes = torch.cat([nodes, coarse.app_conn[:, 0],
                               coarse.app_conn[:, 1]])
    F_I[..., :3] += condense_mod.node_sum(ends, end_nodes, nc)

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

    def add_member_ends(w1, w2, cols):
        """Refined member end loads w1/w2 [Mc, n_seg, c] onto the chain
        nodes and the interface nodes (columns ``cols``)."""
        g[..., cols] += w2[:, :-1] + w1[:, 1:]
        F_I[..., cols] += condense_mod.node_sum(
            torch.cat([w1[:, 0], w2[:, -1]]), nodes, nc)

    if case.buoyancy != "none":
        F_b, cw = _member_buoyancy(refined.coords, refined.conn,
                                   refined.sections, refined.sect_id,
                                   refined.member_types, case.rho_water,
                                   case.buoyancy, L_m)
        add_member_ends((F_b * (1.0 - cw)).reshape(Mc, n_seg, 1).to(dtype),
                        (F_b * cw).reshape(Mc, n_seg, 1).to(dtype),
                        slice(2, 3))
    if case.wind_speed_ms:
        D_struct = (refined.sections.D_outer[refined.sect_id]
                    / 1000.0).to(dtype)
        F1w, F2w = wind_member_ends(refined.coords.to(dtype), refined.conn,
                                    D_struct, case.wind_speed_ms,
                                    case.wind_dir_deg, Cs=case.wind_Cs)
        add_member_ends(F1w.reshape(Mc, n_seg, 3), F2w.reshape(Mc, n_seg, 3),
                        slice(0, 3))
        if case.wind_topside_area_m2:
            fx, fy = _wind_topside(coarse.coords, coarse.top_mask, case,
                                   dtype)
            F_I[..., 0] += fx
            F_I[..., 1] += fy
    return F_I, g.transpose(1, 2)


def _ssi_spring_nodes(coarse: JacketModel, support_stiffness, solve_dtype):
    """Foundation-spring set-up of the spring-supported paths: (ks_nodes,
    free_np, fixed_np) with ``ks_nodes`` the [nc, 6] spring diagonal on
    the model's device (zero off the supports; ``None`` when clamped) and
    the free / fixed DOF index arrays: with springs every DOF is free."""
    free_np, fixed_np = solve_mod.free_fixed_dofs(coarse.fixed_mask)
    if support_stiffness is None:
        return None, free_np, fixed_np
    ks = solve_mod.support_spring_nodes(coarse.fixed_mask, support_stiffness)
    return (torch.as_tensor(ks, dtype=solve_dtype, device=coarse.device),
            np.arange(6 * coarse.n_nodes), fixed_np)


def _spring_dfac(K, ks_nodes, free) -> solve_mod.DenseFactor:
    """Factor K, grounded through the foundation springs when there are
    any.  K itself stays springless, so the reaction recovery
    ``R = K U - F`` gives the spring forces exactly."""
    if ks_nodes is None:
        return solve_mod.factor_dense(K, free)
    return solve_mod.factor_dense(K + torch.diag(ks_nodes.reshape(-1)), free)


def _refine_mask(coarse: JacketModel, ks_nodes, solve_dtype):
    """Free-equation mask [nc, 6] for the refinement residual: clamped rows
    are zeroed; with springs nothing is clamped."""
    if ks_nodes is not None:
        return torch.ones(coarse.n_nodes, 6, dtype=solve_dtype,
                          device=coarse.device)
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
                      F_I_nodes, g, U_In, v, U_I, refine_steps,
                      ks_nodes=None):
    """Iterative refinement in the chain layout: residual via
    ``chain_matvec``, one more condensed solve per round.  ``ks_nodes``
    ([nc, 6] foundation springs) joins the residual: the solved operator
    is K + diag(ks)."""
    for _ in range(refine_steps):
        y_I, y_int = condense_mod.chain_matvec(Kg, n_seg, conn_coarse,
                                               U_In, v)
        r_I = F_I_nodes - y_I
        if ks_nodes is not None:
            r_I = r_I - ks_nodes * U_In
        r_I = r_I * fixed_free_mask                    # fixed rows -> 0
        dU_In, dv, _, dU_I = solve_once(r_I, g - y_int)
        U_In, v, U_I = U_In + dU_In, v + dv, U_I + dU_I
    return U_In, v, U_I


def _check_no_slam(case: LoadCase, path: str) -> None:
    """The phase-batch kinematics paths cannot carry the slam term."""
    if case.slam_cs:
        raise ValueError(
            f"{path}: slamming (slam_cs > 0) runs on the pointwise "
            "kinematics paths only (analyze, analyze_phase_batch, "
            "analyze_condensed, analyze_prepared, kinematics='pointwise') — "
            "the crossing-band impact term does not separate over the phase "
            "matmul")


_KERNEL_KINEMATICS = ("fused", "pallas")


def _check_batch_kinematics(kinematics: str) -> None:
    """The phase-batch ``kinematics`` modes (the pointwise mode aside)."""
    if kinematics not in (*_KERNEL_KINEMATICS, "separable"):
        raise ValueError(f"unknown kinematics mode {kinematics!r}")


def _fused_loads(kinematics: str, device: torch.device, n_gauss: int,
                 n_modes: int) -> bool:
    """Whether a condensed scan's phase-batch loads go through the Morison
    kernel's wrapper.  ``'pallas'`` (the JAX package's name of its kernel
    path) always does, so on the card it raises past the kernel's limits
    as the JAX kernel path does.  ``'fused'`` does unless the shapes pass
    those limits on the card (:func:`.ops.hopper_kernels.kernel_route`):
    then the plain version runs in the model's dtype, as the JAX
    package's default ``'separable'`` does at any size."""
    if kinematics == "pallas":
        return True
    return kinematics == "fused" and kernel_route(device, n_gauss, n_modes)


def _pointwise_morison(model: JacketModel, wave: FourierWave,
                       case: LoadCase, t, n_gauss, accel,
                       stretching="none", current_alpha=None) -> MorisonLoads:
    """:func:`morison_loads` of a model's members at time(s) ``t`` with the
    case's coefficients (``case`` cast to the model's dtype)."""
    conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                            case.Cd, case.Cm)
    return morison_loads(wave, model.coords, conn_h, D_m, case.wave_dir_deg,
                         case.current_dir_deg, Cd_h, Cm_h, case.rho_water, t,
                         n_gauss=n_gauss, accel=accel, stretching=stretching,
                         current_alpha=current_alpha, slam_cs=case.slam_cs)


def _global_to_chain(F: torch.Tensor, coarse: JacketModel, n_seg: int):
    """Refined global vectors [S, n_dof] in ``refine_model``'s layout as
    views in the chain layout: (F_I_nodes [S, nc, 6], g [S, n_int, Mc, 6])."""
    S, nc = F.shape[0], coarse.n_nodes
    Fn = F.reshape(S, -1, 6)
    return (Fn[:, :nc], Fn[:, nc:].reshape(S, coarse.n_members, n_seg - 1, 6)
            .transpose(1, 2))


def _chain_to_global(U_In: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_global_to_chain` for displacements: [S, n_dof]."""
    S = U_In.shape[0]
    return torch.cat([U_In.reshape(S, -1), v.transpose(1, 2).reshape(S, -1)],
                     dim=1)


@spans.spanned(spans.LOADS)
def _scan_loads(prep: "CondensedPrepared", wave: FourierWave, case, n_steps,
                n_gauss, kinematics, stretching, current_alpha,
                accel="analytic"):
    """Per-scan (wave/case-dependent) loads in the chain layout.

    Returns (ts [S] and total_morison [S, 3] in the model dtype,
    F_I_nodes [S, nc, 6] and g [S, n_int, Mc, 6] in the solve dtype).
    ``accel`` applies to ``kinematics='pointwise'`` only.
    """
    coarse, refined = prep.coarse, prep.refined
    ldtype, device = refined.dtype, refined.device
    solve_dtype = prep.K_I.dtype
    ts = (torch.arange(n_steps, dtype=ldtype, device=device)
          * wave.T.to(ldtype) / n_steps)
    case_l = case.cast(ldtype, device)
    L_m = prep.L_m.to(ldtype)
    if kinematics != "pointwise":
        _check_batch_kinematics(kinematics)
        _check_no_slam(case_l, "the condensed phase scan")
    conn_h, D_m, Cd_h, Cm_h = hydro_members(
        refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
    wk, xyz, D_k, *per_member, ts_k, alpha = cast_operands(
        ldtype, device, wave, refined.coords, D_m, case_l.wave_dir_deg,
        case_l.current_dir_deg, Cd_h, Cm_h, case_l.rho_water, ts,
        current_alpha)
    if kinematics == "pointwise":
        # the reference's pointwise kinematics with the slam term, as
        # member end forces (the pointwise kernel on the card)
        F1, F2, drag, inertia = morison_pointwise_end_forces_cuda(
            wk, xyz, conn_h, D_k, *per_member, ts_k, n_gauss, accel,
            stretching, alpha, case_l.slam_cs)
    else:
        fused = _fused_loads(kinematics, device, n_gauss, wave.n_modes)
        batch_fn = morison_end_forces_cuda if fused else morison_end_forces
        F1, F2, drag, inertia = batch_fn(
            wk, xyz, conn_h, D_k, *per_member, ts_k, n_gauss=n_gauss,
            current_alpha=alpha, stretching=stretching)
    F_I_nodes, g = _chain_layout_loads(coarse, refined, case_l, F1, F2, L_m,
                                       prep.n_seg)
    total = drag + inertia
    return (ts, F_I_nodes.to(solve_dtype), g.to(solve_dtype),
            total.to(ldtype))


@spans.spanned(spans.CONDENSE)
def _condensed_solution(prep: "CondensedPrepared", F_I_nodes, g,
                        refine_steps: int):
    """Condensed multi-RHS solve plus ``refine_steps`` refinement rounds.

    Returns (U_In [S, nc, 6], v [S, n_int, Mc, 6], F_cond_flat [S, 6 nc],
    U_I [S, 6 nc]).
    """
    coarse = prep.coarse
    node1, node2 = coarse.conn[:, 0], coarse.conn[:, 1]
    _condense, _backsub = _chain_fns(prep.chain_solver)[1:]
    solve_once = partial(_condensed_solve, fac=prep.fac, dfac=prep.dfac,
                         _condense=_condense, _backsub=_backsub,
                         node1=node1, node2=node2)
    U_In, v, F_cond_flat, U_I = solve_once(F_I_nodes, g)
    if refine_steps > 0:
        U_In, v, U_I = _refine_condensed(
            prep.Kg, prep.n_seg, coarse.conn,
            _refine_mask(coarse, prep.ks_nodes, prep.K_I.dtype), solve_once,
            F_I_nodes, g, U_In, v, U_I, refine_steps, prep.ks_nodes)
    return U_In, v, F_cond_flat, U_I


def _node1_forces(prep: "CondensedPrepared", U_In, v) -> torch.Tensor:
    """Node-1 end forces F1 = -(K_local T u)[:6] [S, Mr, 6] of every
    refined element, the element displacement vectors read straight from
    the chain layout."""
    S = U_In.shape[0]
    node1, node2 = prep.coarse.conn[:, 0], prep.coarse.conn[:, 1]
    vext = torch.cat([U_In[:, node1][:, None], v, U_In[:, node2][:, None]],
                     dim=1)
    u_e = torch.cat([vext[:, :-1], vext[:, 1:]], dim=-1)
    u_elem = u_e.transpose(1, 2).reshape(S, -1, 12)        # member-major
    return matvec12(-prep.KT[:, :6, :], u_elem)


def _von_mises(prep: "CondensedPrepared", U_In, v) -> torch.Tensor:
    """Von Mises stress [S, Mr] (MPa) of every refined element (only the
    node-1 end forces are needed)."""
    F1 = _node1_forces(prep, U_In, v)
    refined = prep.refined
    return von_mises_8pt(refined.sections.to(prep.K_I.dtype),
                         refined.sect_id, *(F1[..., c] for c in range(6)))


@spans.spanned(spans.PREPARE)
def prepare_condensed(coarse: JacketModel, refined: JacketModel, n_seg: int,
                      E=210000.0, nu=0.3, chain_solver: str = "auto",
                      solve_dtype: torch.dtype = torch.float64,
                      support_stiffness=None) -> CondensedPrepared:
    """Factor the case-independent part of the condensed scan once: the
    refined element stiffness (end releases condensed), the chain
    factorization, the interface Cholesky and the recovery fold depend
    only on (model, E, nu, springs).  ``support_stiffness`` ([6] or
    [n_fixed, 6], N/mm and N*mm/rad) puts the supports on foundation
    springs: they ground the interface factorization, and the handle's
    reactions are the spring forces."""
    _check_refined_layout(coarse, refined, n_seg)
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(coarse, support_stiffness,
                                                    solve_dtype)
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
            refined.sections.to(solve_dtype), refined.sect_id, E, G,
            release=refined.release)
        fac = _chain_fns(resolved)[0](Kg, n_seg)
        K_I = assemble_dense(fac.K_super, coarse.conn, 6 * coarse.n_nodes)
        dfac = _spring_dfac(K_I, ks_nodes, free)
        KT = K_local @ T
    return CondensedPrepared(
        coarse=coarse, refined=refined, Kg=Kg, KT=KT, L_m=L_m, fac=fac,
        dfac=dfac, K_I=K_I, ks_nodes=ks_nodes, free=free, fixed=fixed, E=E,
        nu=nu, n_seg=n_seg, chain_solver=resolved)


def _scan_prepared(prep: CondensedPrepared, wave, case: LoadCase, n_steps,
                   n_gauss, kinematics, refine_steps, stretching,
                   current_alpha, accel) -> CondensedScanResults:
    """One condensed scan through a handle; ``case`` is cast to the solve
    dtype."""
    with _full_f32_matmul():
        ts, F_I_nodes, g, total_morison = _scan_loads(
            prep, wave, case, n_steps, n_gauss, kinematics, stretching,
            current_alpha, accel)
        return _prepared_results(prep, case, ts, F_I_nodes, g,
                                 total_morison, refine_steps)


def _prepared_results(prep: CondensedPrepared, case: LoadCase, ts,
                      F_I_nodes, g, total_morison,
                      refine_steps: int) -> CondensedScanResults:
    """Condensed solve and recovery from chain-layout loads (solve dtype):
    shared by the steady-wave scans and the irregular-sea scan."""
    U_In, v, F_cond_flat, U_I = _condensed_solution(prep, F_I_nodes, g,
                                                    refine_steps)
    S = ts.shape[0]
    with spans.span(spans.RECOVER):
        vm = _von_mises(prep, U_In, v)
        util = vm / case.fy
        R = U_I @ prep.K_I.T - F_cond_flat                 # [S, 6 nc]
        return CondensedScanResults(
            ts=ts, U=_chain_to_global(U_In, v), von_mises=vm,
            utilization=util, reactions=R[:, prep.fixed].reshape(S, -1, 6),
            total_morison=total_morison,
            critical_index=torch.argmax(torch.amax(util, dim=1)))


def _check_material(prep: CondensedPrepared, case: LoadCase) -> None:
    """``case.E``/``case.nu`` must match the handle's factorization."""
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


@spans.spanned(spans.ENTRY)
def phase_scan_prepared(prep: CondensedPrepared, wave, case: LoadCase,
                        n_steps: int = 360, n_gauss: int = 15,
                        accel: str = "analytic", kinematics: str = "fused",
                        refine_steps: int = 1, stretching: str = "none",
                        current_alpha=None) -> CondensedScanResults:
    """Condensed phase scan through a :func:`prepare_condensed` handle:
    only the wave/case-dependent work runs.  ``case.E``/``case.nu`` must
    match the handle (raises on mismatch).  ``accel`` applies to
    ``kinematics='pointwise'`` only."""
    _check_material(prep, case)
    return _scan_prepared(prep, wave, case.cast(prep.K_I.dtype,
                                                prep.refined.device),
                          n_steps, n_gauss, kinematics,
                          refine_steps,
                          stretching, current_alpha, accel)


def phase_scan_condensed(coarse: JacketModel, refined: JacketModel,
                         n_seg: int, wave: FourierWave, case: LoadCase,
                         n_steps: int = 360, n_gauss: int = 15,
                         accel: str = "analytic",
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
    refinement follow the direct solve.  ``kinematics='pointwise'``
    evaluates the reference's pointwise kinematics with ``accel``
    ('analytic' or the reference's finite difference 'fd') and carries the
    slam term; the other modes ignore ``accel``.

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
                          n_steps, n_gauss, kinematics,
                          refine_steps,
                          stretching, current_alpha, accel)


_PREP_CACHE: dict = {}


def _cached_prepared(coarse, refined, n_seg, case, chain_solver, solve_dtype,
                     support_stiffness) -> CondensedPrepared:
    """prepare_condensed memoized on model identity + material + solver
    config + foundation springs (bounded; holds strong model references so
    the id keys stay valid)."""
    ss_key = None if support_stiffness is None \
        else np.asarray(support_stiffness, np.float64).tobytes()
    key = (id(coarse), id(refined), n_seg, float(case.E), float(case.nu),
           chain_solver, str(solve_dtype), ss_key)
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


# ---------------------------------------------------------------------------
# Single analyses: dense (analyze, analyze_phase_batch) and condensed
# ---------------------------------------------------------------------------

def _analysis_results(sections: TubeSections, sect_id, fy, U, F, F1, F2,
                      reactions, L_m, mor: MorisonLoads) -> AnalysisResults:
    """Stresses, utilization and the displacement / reaction summaries of
    one solution (a leading phase axis rides along)."""
    vm = von_mises_8pt(sections, sect_id, *(F1[..., c] for c in range(6)))
    disp = torch.linalg.norm(U.reshape(*U.shape[:-1], -1, 6)[..., :3],
                             dim=-1)
    imax = torch.argmax(disp, dim=-1)
    return AnalysisResults(
        U=U, reactions=reactions, F_applied=F, F1_local=F1, F2_local=F2,
        von_mises=vm, utilization=vm / fy,
        length_m=L_m.expand(*U.shape[:-1], L_m.shape[-1]), morison=mor,
        max_displacement_mm=torch.take_along_dim(disp, imax[..., None],
                                                 dim=-1)[..., 0],
        max_displacement_node=imax,
        total_reaction=torch.sum(reactions, dim=-2))


def _recover(model: JacketModel, case: LoadCase, K, U, F, fixed_dofs,
             K_local, T, L_m, mor: MorisonLoads) -> AnalysisResults:
    """Reactions R = K U - F at the fixed DOFs, member end forces, stresses
    (von Mises from the node-1 forces, as the reference does); ``U`` and
    ``F`` are [n_dof] or [S, n_dof]."""
    F1, F2 = internal_forces(K_local, T, U[..., element_dof_indices(
        model.conn)])
    return _analysis_results(model.sections, model.sect_id, case.fy, U, F,
                             F1, F2,
                             solve_mod.reactions_dense(K, U, F, fixed_dofs),
                             L_m, mor)


def _dense_system(model: JacketModel, case: LoadCase):
    """(K [n_dof, n_dof], K_local, T, L_m) of a model in its dtype."""
    G = case.E / (2.0 * (1.0 + case.nu))
    Kg, K_local, T, L_m = element_stiffness(model.coords, model.conn,
                                            model.sections, model.sect_id,
                                            case.E, G, release=model.release)
    return assemble_dense(Kg, model.conn, model.n_dof), K_local, T, L_m


def analyze(model: JacketModel, wave: FourierWave, case: LoadCase,
            solver: str = "chol", n_gauss: int = 15, accel: str = "fd",
            pcg_tol: float = 1e-10, pcg_maxiter: int = 2000,
            pcg_precond: str = "auto", pcg_chunk: int = 0,
            lstsq_fallback: bool = False, mesh=None,
            stretching: str = "none",
            current_alpha=None) -> AnalysisResults:
    """Single linear static analysis, the reference's RUN-ANALYSIS
    pipeline: Morison loads at ``case.t_analysis`` (pointwise kinematics,
    ``accel`` 'fd' as the reference or 'analytic'), topside and self-weight
    loads, dense assembly, solve, reactions, member end forces and von
    Mises utilization, on the model's device in its dtype.

    ``solver``: 'lu' (the reference's dense LU; ``lstsq_fallback`` solves
    a singular free-free block by minimum-norm least squares, as the
    reference's except branch does), 'chol' (Jacobi-scaled Cholesky
    with one refinement round) or 'pcg' (matrix-free preconditioned CG on
    BCSR, for meshes a dense solve cannot hold; :func:`_analyze_pcg`).
    The dense solvers ignore ``pcg_tol``, ``pcg_maxiter`` and
    ``pcg_chunk``; an unknown ``pcg_precond`` raises ``ValueError``
    whatever the solver, as in the JAX package.

    PCG converges on ||r|| / ||b|| <= ``pcg_tol`` within ``pcg_maxiter``
    iterations and fills ``solver_iters`` and ``solver_residual``; it
    warns when it does not converge (a NaN residual included).
    ``pcg_precond``: 'block_jacobi' (the 6x6 nodal smoother),
    'two_level' (block-Jacobi plus a rigid-body-aggregate coarse
    correction, ``ops/coarse.py``) or 'auto' (two-level from 120 nodes
    on).  ``pcg_chunk``: iterations between the host's convergence reads
    (0: ``ops.solve.PCG_CHECK_EVERY``); the result is the same for every
    value.

    With ``mesh`` (a 1-D :class:`~torch.distributed.device_mesh.DeviceMesh`,
    any axis name; every rank of its group makes the same call) and
    ``solver='pcg'``, the linear solve is the row-sharded distributed PCG
    (:func:`.parallel.pcg_dist.distributed_pcg`): K's 6x6 node-block rows
    are split over the ranks, and loads, assembly and recovery stay
    replicated (O(n), cheap next to the solve).  Every rank returns the
    whole result.  ``mesh`` with another solver raises ``ValueError``, as
    in the JAX package.
    """
    if pcg_precond not in ("auto", "block_jacobi", "two_level"):
        raise ValueError(f"unknown pcg_precond {pcg_precond!r}")
    if mesh is not None:
        if solver != "pcg":
            raise ValueError("mesh-distributed analyze requires "
                             "solver='pcg'")
        comm.mesh_info(mesh)
    if solver not in ("lu", "chol", "pcg"):
        raise ValueError(f"unknown solver {solver!r}")
    case = case.cast(model.dtype, model.device)
    if solver == "pcg":
        if pcg_precond == "auto":
            pcg_precond = ("two_level" if model.n_nodes >= 120
                           else "block_jacobi")
        res = _analyze_pcg(model, wave, case, n_gauss, accel, stretching,
                           current_alpha, pcg_tol, pcg_maxiter, pcg_precond,
                           pcg_chunk, mesh)
        rel = float(res.solver_residual)
        if not rel <= pcg_tol:     # catches NaN too
            warnings.warn(
                f"{'distributed ' if mesh is not None else ''}"
                f"PCG did not converge: relative residual {rel:.2e} > tol "
                f"{pcg_tol:.1e} after {int(res.solver_iters)} iterations "
                f"(maxiter {pcg_maxiter}); results may be inaccurate",
                stacklevel=2)
        return res
    free, fixed = solve_mod.free_fixed_dofs(model.fixed_mask)
    with _full_f32_matmul():
        mor = _pointwise_morison(model, wave, case, case.t_analysis, n_gauss,
                                 accel, stretching, current_alpha)
        K, K_local, T, L_m = _dense_system(model, case)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        if solver == "lu":
            U = solve_mod.solve_dense(K, F, free, lstsq_fallback)
        else:
            U = solve_mod.solve_factored(solve_mod.factor_dense(K, free), F)
        return _recover(model, case, K, U, F, fixed, K_local, T, L_m, mor)


# The BCSR pattern and the aggregation depend only on the connectivity;
# they are built on the host, so they are memoized (bounded) on it.
_PATTERN_CACHE: dict = {}
_AGG_CACHE: dict = {}


def _cached_bcsr_pattern(conn: torch.Tensor, n_nodes: int):
    """:func:`.ops.assembly.build_bcsr_pattern` of ``conn``, memoized on
    the connectivity and its device (one copy to the host a miss)."""
    key = (n_nodes, str(conn.device), conn.cpu().numpy().tobytes())
    pat = _PATTERN_CACHE.get(key)
    if pat is None:
        if len(_PATTERN_CACHE) >= 8:
            _PATTERN_CACHE.clear()
        pat = _PATTERN_CACHE[key] = build_bcsr_pattern(conn, n_nodes)
    return pat


def _cached_aggregates(pattern):
    """(agg, n_agg, plan) of the two-level preconditioner
    (:func:`.ops.coarse.aggregates_from_pattern`, :func:`.ops.coarse
    .plan_sparse_p`), memoized on the pattern object."""
    key = id(pattern)
    hit = _AGG_CACHE.get(key)
    if hit is None or hit[0] is not pattern:
        if len(_AGG_CACHE) >= 8:
            _AGG_CACHE.clear()
        agg = coarse_mod.aggregates_from_pattern(pattern)
        n_agg = int(agg.max()) + 1
        hit = _AGG_CACHE[key] = (pattern, agg, n_agg,
                                 coarse_mod.plan_sparse_p(pattern, agg,
                                                          n_agg))
    return hit[1:]


def _pcg_operators(A, model: JacketModel, precond: str):
    """(free-DOF mask, BC-projected operator, preconditioner) of the
    assembled BCSR stiffness ``A`` for PCG; ``precond`` 'block_jacobi' or
    'two_level' (its coarse space built here, once a solve)."""
    fmask = solve_mod.dof_free_mask(model.fixed_mask).to(A.blocks.dtype)
    op = solve_mod.projected_operator(lambda x: bcsr_matvec(A, x), fmask)
    pre = solve_mod.block_jacobi_preconditioner(bcsr_block_diagonal(A),
                                                fmask)
    if precond == "two_level":
        pre = coarse_mod.two_level_preconditioner(pre,
                                                  _coarse_space(A, model))
    return fmask, op, pre


def _coarse_space(A, model: JacketModel):
    """The two-level preconditioner's coarse space of ``A`` (the
    aggregation memoized on the pattern)."""
    agg, n_agg, plan = _cached_aggregates(A.pattern)
    return coarse_mod.build_coarse_space(A, model.coords, model.fixed_mask,
                                         agg=agg, n_agg=n_agg, plan=plan)


def _analyze_pcg(model: JacketModel, wave: FourierWave, case: LoadCase,
                 n_gauss, accel, stretching, current_alpha, tol: float,
                 maxiter: int, precond: str, chunk: int,
                 mesh=None) -> AnalysisResults:
    """:func:`analyze` with ``solver='pcg'`` (``case`` in the model's dtype
    and device): pointwise loads, BCSR assembly, the BC-projected operator
    and ``precond`` ('block_jacobi' or 'two_level'), PCG on the free
    loads (row-sharded over ``mesh`` when given), then reactions R = K U -
    F and the recovery.  One code path
    whatever ``chunk``.  The JAX package's chunked route runs entry-major
    band operators on chain-refined meshes
    (``small_fem_solver_tpu/api.py:558-610``, ``ops/structured.py``), a
    TPU layout of the same mat-vec and preconditioner in (8, 128) tiles;
    it is not ported, and the generic BCSR operators serve every route."""
    fixed = solve_mod.free_fixed_dofs(model.fixed_mask)[1]
    with _full_f32_matmul():
        mor = _pointwise_morison(model, wave, case, case.t_analysis, n_gauss,
                                 accel, stretching, current_alpha)
        G = case.E / (2.0 * (1.0 + case.nu))
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id, case.E,
            G, release=model.release)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        A = assemble_bcsr(Kg, _cached_bcsr_pattern(model.conn,
                                                   model.n_nodes))
        check_every = chunk or solve_mod.PCG_CHECK_EVERY
        if mesh is None:
            fmask, op, pre = _pcg_operators(A, model, precond)
            res = solve_mod.pcg(op, fmask * F, precond=pre, tol=tol,
                                maxiter=maxiter, check_every=check_every)
            U = fmask * res.x
        else:
            from .parallel.pcg_dist import distributed_pcg
            U, n_iter, resid = distributed_pcg(
                A, F, model.fixed_mask, mesh, tol=tol, maxiter=maxiter,
                coarse=(_coarse_space(A, model) if precond == "two_level"
                        else None), check_every=check_every)
            res = solve_mod.PCGResult(x=U, n_iter=n_iter, residual=resid)
        R = bcsr_matvec(A, U) - F
        F1, F2 = internal_forces(K_local, T,
                                 U[element_dof_indices(model.conn)])
        reactions = R[torch.as_tensor(fixed, device=R.device)].reshape(-1, 6)
        return _analysis_results(
            model.sections, model.sect_id, case.fy, U, F, F1, F2, reactions,
            L_m, mor)._replace(solver_iters=res.n_iter,
                               solver_residual=res.residual)


def analyze_phase_batch(model: JacketModel, wave: FourierWave,
                        case: LoadCase, n_steps: int = 36, n_gauss: int = 15,
                        accel: str = "analytic"
                        ) -> tuple[torch.Tensor, AnalysisResults]:
    """The full structural problem at every phase t_i = i T / n_steps of
    one wave period: K is factored once (Cholesky) and all phases are one
    multi-RHS solve.  ``accel`` defaults to 'analytic': the reference's
    dt = 1e-3 finite difference gives an O(u / dt) inertia spike at a phase
    where a quadrature point emerges within dt, which dense phase batches
    hit; pass 'fd' for the reference's semantics.

    Returns (ts [S], AnalysisResults with a leading phase axis).
    """
    free, fixed = solve_mod.free_fixed_dofs(model.fixed_mask)
    case = case.cast(model.dtype, model.device)
    with _full_f32_matmul():
        ts = (torch.arange(n_steps, dtype=model.dtype, device=model.device)
              * wave.T.to(model.dtype) / n_steps)
        K, K_local, T, L_m = _dense_system(model, case)
        fac = solve_mod.factor_dense(K, free)
        mor = _pointwise_morison(model, wave, case, ts, n_gauss, accel)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)   # [S, n_dof]
        U = solve_mod.solve_factored(fac, F)
        return ts, _recover(model, case, K, U, F, fixed, K_local, T, L_m,
                            mor)


def analyze_ssi(model: JacketModel, wave: FourierWave, case: LoadCase,
                support_stiffness, n_gauss: int = 15, accel: str = "fd",
                stretching: str = "none",
                current_alpha=None) -> AnalysisResults:
    """Linear soil-structure interaction: :func:`analyze` with the rigid
    support clamp replaced by a 6-DOF linear spring at each support node.

    ``K + diag(k)`` is solved over all DOFs (Cholesky); the reactions are
    recovered through the springless K, which gives exactly the spring
    forces ``-k u_support``.  ``support_stiffness`` is [6] (every support
    alike) or [n_fixed, 6], in N/mm for translations and N*mm/rad for
    rotations; as k grows the clamped solution is recovered.  A dense
    path, for the coarse model or mild refinements."""
    case = case.cast(model.dtype, model.device)
    ks_nodes, free, fixed = _ssi_spring_nodes(model, support_stiffness,
                                              model.dtype)
    with _full_f32_matmul():
        mor = _pointwise_morison(model, wave, case, case.t_analysis, n_gauss,
                                 accel, stretching, current_alpha)
        K, K_local, T, L_m = _dense_system(model, case)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        U = solve_mod.solve_factored(_spring_dfac(K, ks_nodes, free), F)
        return _recover(model, case, K, U, F, fixed, K_local, T, L_m, mor)


def _analyze_prepared(prep: CondensedPrepared, wave: FourierWave,
                      case: LoadCase, n_gauss, accel,
                      refine_steps) -> AnalysisResults:
    """Single-phase condensed analysis through a handle; ``case`` is cast
    to the solve dtype.  Loads are evaluated in the model dtype and built
    as global vectors, then read in the chain layout."""
    coarse, refined = prep.coarse, prep.refined
    solve_dtype = prep.K_I.dtype
    case_l = case.cast(refined.dtype, refined.device)
    with _full_f32_matmul():
        mor = _pointwise_morison(refined, wave, case_l, case_l.t_analysis,
                                 n_gauss, accel)
        F = assemble_loads(refined, case_l, mor.nodal_forces,
                           prep.L_m.to(refined.dtype)).to(solve_dtype)
        F_I_nodes, g = _global_to_chain(F[None], coarse, prep.n_seg)
        U_In, v, F_cond_flat, U_I = _condensed_solution(prep, F_I_nodes, g,
                                                        refine_steps)
        U = _chain_to_global(U_In, v)[0]
        # recovery through the prepared K_local @ T fold (the reference's
        # signs: F1 = -(K_local T u)[:6], F2 = +(K_local T u)[6:])
        F_loc = matvec12(prep.KT, U[element_dof_indices(refined.conn)])
        R = U_I @ prep.K_I.T - F_cond_flat                 # [1, 6 nc]
        return _analysis_results(
            refined.sections.to(solve_dtype), refined.sect_id, case.fy, U, F,
            -F_loc[:, :6], F_loc[:, 6:], R[0, prep.fixed].reshape(-1, 6),
            prep.L_m, mor)


def analyze_prepared(prep: CondensedPrepared, wave: FourierWave,
                     case: LoadCase, n_gauss: int = 15,
                     accel: str = "analytic",
                     refine_steps: int = 1) -> AnalysisResults:
    """Single-phase condensed analysis through a :func:`prepare_condensed`
    handle: loads, condensation, one interface solve plus ``refine_steps``
    refinement rounds, recovery.  The same results as
    :func:`analyze_condensed` without its factorization;
    ``case.E``/``case.nu`` must match the handle (raises on mismatch)."""
    _check_material(prep, case)
    return _analyze_prepared(prep, wave, case.cast(prep.K_I.dtype,
                                                   prep.refined.device),
                             n_gauss, accel, refine_steps)


def analyze_condensed(coarse: JacketModel, refined: JacketModel, n_seg: int,
                      wave: FourierWave, case: LoadCase, n_gauss: int = 15,
                      accel: str = "analytic",
                      solve_dtype: torch.dtype = torch.float64,
                      refine_steps: int = 1, chain_solver: str = "auto",
                      support_stiffness=None) -> AnalysisResults:
    """Full single-phase analysis of a refined jacket through exact chain
    condensation, the large-mesh counterpart of :func:`analyze` (at
    ``n_seg = 327`` the default jacket has 99,882 DOF): element stiffness
    and chain factorization (one shot, no cache), pointwise loads at
    ``case.t_analysis``, condensed solve plus ``refine_steps`` refinement
    rounds, recovery, and reactions from the interface system.  ``refined``
    must come from ``refine_model(coarse, n_seg)``."""
    prep = prepare_condensed(coarse, refined, n_seg, E=case.E, nu=case.nu,
                             chain_solver=chain_solver,
                             solve_dtype=solve_dtype,
                             support_stiffness=support_stiffness)
    return _analyze_prepared(prep, wave, case.cast(solve_dtype,
                                                   refined.device),
                             n_gauss, accel, refine_steps)


# ---------------------------------------------------------------------------
# Second-order (P-delta) analyses
# ---------------------------------------------------------------------------

def _amplification(U1: torch.Tensor, U2: torch.Tensor) -> torch.Tensor:
    """The largest nodal translation ratio of the second-order solution
    ``U2`` over the first-order ``U1`` (nodes that do not move count 1)."""
    d1 = torch.linalg.norm(U1.reshape(-1, 6)[:, :3], dim=-1)
    d2 = torch.linalg.norm(U2.reshape(-1, 6)[:, :3], dim=-1)
    moved = d1 > 0
    return torch.amax(torch.where(
        moved, d2 / torch.where(moved, d1, torch.ones_like(d1)),
        torch.ones_like(d1)))


def analyze_pdelta(model: JacketModel, wave: FourierWave, case: LoadCase,
                   n_iter: int = 3, n_gauss: int = 15, accel: str = "fd",
                   stretching: str = "none", current_alpha=None,
                   support_stiffness=None) -> AnalysisResults:
    """Second-order (P-delta) static analysis: equilibrium on the deformed
    geometry, linearized through the consistent geometric stiffness
    (:func:`.ops.buckling.element_geometric_stiffness`).  Solves ``(K -
    K_G(N)) U = F`` with ``N`` the member axial forces (positive in
    compression), fixed-point iterated ``n_iter`` times from the linear
    solution; for a member at axial load P the lateral response amplifies
    by ~1 / (1 - P / P_cr).

    Past the elastic buckling load (lambda_cr < 1 in
    :func:`.ops.buckling.buckling_analysis`) the corrected system is not
    positive definite and the Cholesky gives NaN, the signal that no
    second-order static equilibrium exists (no error is raised).  Results
    carry ``pdelta_amplification``, the largest nodal displacement ratio
    against the first-order solution.  ``support_stiffness`` combines
    P-delta with foundation springs (:func:`analyze_ssi`): the corrected
    system is K + diag(k) - K_G.  Dense, on the model's device in its
    dtype."""
    case = case.cast(model.dtype, model.device)
    ks_nodes, free, fixed = _ssi_spring_nodes(model, support_stiffness,
                                              model.dtype)
    with _full_f32_matmul():
        mor = _pointwise_morison(model, wave, case, case.t_analysis, n_gauss,
                                 accel, stretching, current_alpha)
        K, K_local, T, L_m = _dense_system(model, case)
        W = model_release_W(model, case.E, case.nu)
        F = assemble_loads(model, case, mor.nodal_forces, L_m)
        U1 = U = solve_mod.solve_factored(_spring_dfac(K, ks_nodes, free), F)
        dofs = element_dof_indices(model.conn)
        K2 = K
        for _ in range(n_iter):
            N = -internal_forces(K_local, T, U[dofs])[0][:, 0]
            K2 = K - assemble_dense(element_geometric_stiffness(
                model.coords, model.conn, N, W=W), model.conn, model.n_dof)
            U = solve_mod.solve_factored(_spring_dfac(K2, ks_nodes, free), F)
        res = _recover(model, case, K2, U, F, fixed, K_local, T, L_m, mor)
        return res._replace(pdelta_amplification=_amplification(U1, U))


def analyze_pdelta_condensed(coarse: JacketModel, refined: JacketModel,
                             n_seg: int, wave, case: LoadCase,
                             n_iter: int = 3, n_gauss: int = 15,
                             accel: str = "analytic",
                             solve_dtype: torch.dtype = torch.float64,
                             chain_solver: str = "auto",
                             support_stiffness=None) -> AnalysisResults:
    """Second-order (P-delta) analysis of a chain-refined mesh: the fixed
    point of :func:`analyze_pdelta` (solve, member axial forces, subtract
    the consistent geometric stiffness, solve again), every solve through
    the exact chain condensation, so it reaches the sizes of
    :func:`analyze_condensed`.  The chains are refactored each round from
    ``Kg - K_G(N)`` (their pivots stay positive definite below elastic
    buckling; past it they give NaN, as on the dense path), and on the card
    every condensed solve runs the chain-sweep kernel.  Loads are pointwise
    at ``case.t_analysis`` in the model's dtype; the solves run in
    ``solve_dtype`` with no refinement round, as in the JAX package.  Equals
    :func:`analyze_pdelta` on the same refined mesh, since both iterate the
    same linearized system."""
    _check_refined_layout(coarse, refined, n_seg)
    ks_nodes, free_np, fixed_np = _ssi_spring_nodes(coarse, support_stiffness,
                                                    solve_dtype)
    device = refined.device
    free = torch.as_tensor(free_np, device=device)
    fixed = torch.as_tensor(fixed_np, device=device)
    factor, _condense, _backsub = _chain_fns(_resolve_chain_solver(
        n_seg, chain_solver))
    case_s = case.cast(solve_dtype, device)
    case_l = case.cast(refined.dtype, device)
    node1, node2 = coarse.conn[:, 0], coarse.conn[:, 1]
    with _full_f32_matmul():
        coords_s = refined.coords.to(solve_dtype)
        sec_s = refined.sections.to(solve_dtype)
        G = case_s.E / (2.0 * (1.0 + case_s.nu))
        Kg, K_local, T, L_m = element_stiffness(
            coords_s, refined.conn, sec_s, refined.sect_id, case_s.E, G,
            release=refined.release)
        W = model_release_W(dataclasses.replace(refined, coords=coords_s,
                                                sections=sec_s),
                            case_s.E, case_s.nu)
        mor = _pointwise_morison(refined, wave, case_l, case_l.t_analysis,
                                 n_gauss, accel)
        F = assemble_loads(refined, case_l, mor.nodal_forces,
                           L_m.to(refined.dtype)).to(solve_dtype)
        F_I_nodes, g = _global_to_chain(F[None], coarse, n_seg)
        dofs = element_dof_indices(refined.conn)

        def solve_with(K_elems):
            fac = factor(K_elems, n_seg)
            K_I = assemble_dense(fac.K_super, coarse.conn, 6 * coarse.n_nodes)
            U_In, v, F_cond, U_I = _condensed_solve(
                F_I_nodes, g, fac, _spring_dfac(K_I, ks_nodes, free),
                _condense, _backsub, node1, node2)
            return _chain_to_global(U_In, v)[0], K_I, F_cond, U_I

        U1, K_I, F_cond, U_I = solve_with(Kg)
        U = U1
        for _ in range(n_iter):
            N = -internal_forces(K_local, T, U[dofs])[0][:, 0]
            U, K_I, F_cond, U_I = solve_with(
                Kg - element_geometric_stiffness(coords_s, refined.conn, N,
                                                 W=W))
        F1, F2 = internal_forces(K_local, T, U[dofs])
        R = U_I @ K_I.T - F_cond                           # [1, 6 nc]
        return _analysis_results(
            sec_s, refined.sect_id, case_s.fy, U, F, F1, F2,
            R[0, fixed].reshape(-1, 6), L_m, mor)._replace(
                pdelta_amplification=_amplification(U1, U))


# ---------------------------------------------------------------------------
# Design envelopes: dense and condensed
# ---------------------------------------------------------------------------

def _check_shared_material(cases: LoadCase) -> None:
    """Envelope solvers factor K once, so E/nu must not vary across cases."""
    for name in ("E", "nu"):
        v = torch.as_tensor(getattr(cases, name))
        if v.ndim > 0 and not bool(torch.all(v == v.reshape(-1)[0])):
            raise ValueError(
                f"design envelopes share one stiffness factorization: "
                f"case field {name!r} must be identical across the batch")


def _case_batch(waves: FourierWave, cases: LoadCase, dtype, device):
    """(C, cases with every numeric field a [C] tensor of ``dtype`` on
    ``device``) for a wave batch of C cases; raises on a wave without a
    case axis or a case field of another length."""
    if waves.E.ndim != 2:
        raise ValueError("waves must be a batch with a leading case axis "
                         "(parallel.sweep.make_wave_batch / stack_waves)")
    C = waves.E.shape[0]
    for f in dataclasses.fields(cases):
        v = getattr(cases, f.name)
        if torch.is_tensor(v) and v.ndim > 0 and tuple(v.shape) != (C,):
            raise ValueError(f"case field {f.name!r} has shape "
                             f"{tuple(v.shape)}; the wave batch has {C} cases")
    cases = cases.cast(dtype, device)
    return C, dataclasses.replace(cases, **{
        f.name: getattr(cases, f.name).expand(C)
        for f in dataclasses.fields(cases)
        if f.name not in LoadCase._STATIC_FIELDS})


@spans.spanned(spans.PREPARE)
def _dense_batch(model: JacketModel, waves: FourierWave, cases: LoadCase,
                 support_stiffness):
    """The set-up of the dense design tier (:func:`design_envelope`,
    :func:`design_sweep`): the case batch in the model's dtype, K of case 0
    (E and nu are shared) factored once with the springs, if any.  Returns
    (C, cases, fixed DOFs, (K, K_local, T, L_m), factor); call it under
    :func:`_full_f32_matmul`."""
    _check_shared_material(cases)
    C, cases = _case_batch(waves, cases, model.dtype, model.device)
    ks_nodes, free, fixed = _ssi_spring_nodes(model, support_stiffness,
                                              model.dtype)
    system = _dense_system(model, cases.case(0))
    return C, cases, fixed, system, _spring_dfac(system[0], ks_nodes, free)


def _mesh_cases(mesh, C: int, what: str) -> tuple:
    """(slice of this rank's cases, every rank's block size) of a batch of
    ``C`` cases sharded over ``mesh`` in contiguous equal blocks; a count
    the mesh does not divide raises, as the JAX package's ``P('cases')``
    placement does."""
    _, rank, W = comm.mesh_info(mesh)
    if C % W:
        raise ValueError(
            f"{what}: {C} cases do not divide evenly over the mesh's {W} "
            "ranks (the case axis is sharded in equal blocks, as by the JAX "
            "package's P('cases'))")
    per = C // W
    return slice(rank * per, (rank + 1) * per), [per] * W


def _tensor_fields(obj) -> list:
    """Names of the tensor fields of a wave or case dataclass."""
    return [f.name for f in dataclasses.fields(obj)
            if torch.is_tensor(getattr(obj, f.name))]


@spans.spanned(spans.ENTRY)
def design_envelope(model: JacketModel, waves: FourierWave, cases: LoadCase,
                    n_steps: int = 36, n_gauss: int = 15, mesh=None,
                    current_alpha=None, support_stiffness=None,
                    stretching: str = "none") -> EnvelopeResults:
    """Full-FEM storm envelope of a model: every case x every wave phase.

    ``waves`` is a batched :class:`FourierWave` and ``cases`` a
    :class:`LoadCase` with ``[C]`` numeric fields (see
    ``parallel.sweep.make_wave_batch`` / ``make_case_batch``); E and nu
    must be shared by all cases.  K is factored once (Cholesky; grounded
    through ``support_stiffness`` springs, see :func:`analyze_ssi`).  The
    phase loads of all cases come from the separable Morison engine in the
    model's dtype, as in the JAX package (``jax.vmap`` there): on CUDA
    tensors one launch of the Morison kernel's case-batched instance of
    the model's dtype for the whole batch (float64, or the case-batched
    float32 instance), on the CPU its plain version (``torch.func.vmap``
    over the cases); waves of more than 32
    modes or ``n_gauss`` > 16 run the plain version on the card too (no
    launch; one ``morison_phase_batch_cuda.plain_routes``).  Everything
    else runs once for the batch: the hydrodynamic set, the nodal sums
    and the load assembly (``torch.func.vmap`` over the cases), then all
    C x S load vectors are one multi-RHS solve, and the recovery is
    batched.  The result keeps the full utilization field [C, S, M].

    With ``mesh`` (a 1-D DeviceMesh, axis 'cases'; every rank of its group
    makes the same call) the case batch is split into equal contiguous
    rank blocks: each rank factors K and runs its block (one launch of
    K1's case-batched instance on its slice of the batch), and the blocks
    are all-gathered, so every rank returns the whole envelope.
    """
    _check_no_slam(cases, "design_envelope")
    dtype, dev = model.dtype, model.device
    with _full_f32_matmul():
        C, cases, _, (K, K_local, T, L_m), fac = _dense_batch(
            model, waves, cases, support_stiffness)
        if mesh is not None:
            block, sizes = _mesh_cases(mesh, C, "design_envelope")
            waves, cases = _case_slice(waves, block), _case_slice(cases,
                                                                  block)
            C = sizes[0]
        fields = _tensor_fields(cases)
        with spans.span(spans.LOADS):
            ts = (torch.arange(n_steps, dtype=dtype, device=dev)
                  * waves.T.to(dtype)[:, None] / n_steps)      # [C, S]
            conn_h = hydro_members(model, 0.0, 1.0, 1.0)[0]
            D_h, Cd_h, Cm_h = torch.func.vmap(
                lambda mg, cd, cm: hydro_members(model, mg, cd, cm)[1:])(
                    cases.marine_growth_mm, cases.Cd, cases.Cm)
            wk, = cast_operands(dtype, dev, waves)
            # Cd / Cm per case [C, 1] or per case and member [C, M']
            # past the kernel's limits on the card: the plain version in
            # the model's dtype (kernel_route counts the route)
            batch_fn = (morison_end_forces_batch_cuda
                        if kernel_route(dev, n_gauss, waves.n_modes)
                        else morison_end_forces_batch)
            F1, F2, drag, inertia = batch_fn(
                wk, model.coords, conn_h, D_h, cases.wave_dir_deg,
                cases.current_dir_deg, Cd_h.reshape(C, -1),
                Cm_h.reshape(C, -1), cases.rho_water, ts, n_gauss=n_gauss,
                current_alpha=current_alpha, stretching=stretching)
            F12 = torch.cat([F1, F2], dim=2)               # [C, S, 2M', 3]
            tot = drag + inertia
            table = node_gather_table(
                torch.cat([conn_h[:, 0], conn_h[:, 1]]), model.n_nodes)
            nodal = node_sum_ordered(F12, table)           # [C, S, n, 3]
            F = torch.func.vmap(lambda c, nodal_c: assemble_loads(
                model, dataclasses.replace(cases, **dict(zip(fields, c))),
                nodal_c, L_m))(tuple(getattr(cases, n) for n in fields),
                               nodal)
        with spans.span(spans.DENSE_SOLVE):
            U = solve_mod.solve_factored(fac, F.reshape(C * n_steps, -1))
        with spans.span(spans.RECOVER):
            F1 = matvec12(-(K_local @ T)[:, :6, :],
                          U[:, element_dof_indices(model.conn)])
            vm = von_mises_8pt(model.sections, model.sect_id,
                               *(F1[..., c] for c in range(6)))
            util = vm.reshape(C, n_steps, -1) / cases.fy[:, None, None]
    if mesh is not None:
        ts, util, tot = comm.gather_tree((ts, util, tot), mesh, sizes)
    return _envelope_from_reductions(
        ts, torch.amax(util, dim=-1), torch.amax(util, dim=(0, 1)),
        tot)._replace(utilization=util)


def design_sweep(model: JacketModel, waves: FourierWave, cases: LoadCase,
                 solver: str = "chol", n_gauss: int = 15,
                 accel: str = "analytic", mesh=None,
                 support_stiffness=None) -> AnalysisResults:
    """:func:`analyze` of a batch of (wave, case) pairs at each case's
    ``t_analysis``, with one stiffness factorization (the JAX package's
    ``parallel.sweep.design_sweep``; ``parallel.sweep`` re-exports it).

    E and nu must be shared by the batch, so K is factored once
    (Cholesky, grounded through ``support_stiffness`` springs when given;
    'lu' and 'chol' solve the same SPD system); the pointwise Morison and
    load assembly of all cases run as one case-batched evaluation (in
    chunks of at most ``POINTWISE_CHUNK_ELEMS`` kinematics elements), then
    one multi-RHS solve and a batched recovery.  Returns
    :class:`AnalysisResults` with a leading case axis.  With ``mesh`` (a
    1-D DeviceMesh, axis 'cases') each rank runs its equal contiguous
    block of cases and every rank returns the whole batch (all-gathered).
    """
    if solver not in ("chol", "lu"):
        raise ValueError(f"design_sweep supports dense solvers "
                         f"('chol'/'lu'); got {solver!r}")
    waves = waves.to(model.dtype, model.device)
    per_case = ((model.n_members + model.n_appurtenances) * n_gauss
                * waves.n_modes)
    step = max(1, POINTWISE_CHUNK_ELEMS // per_case)
    with _full_f32_matmul():
        C, cases, fixed, (K, K_local, T, L_m), fac = _dense_batch(
            model, waves, cases, support_stiffness)
        if mesh is not None:
            block, sizes = _mesh_cases(mesh, C, "design_sweep")
            waves, cases = _case_slice(waves, block), _case_slice(cases,
                                                                  block)
            C = sizes[0]
        wf, cf = _tensor_fields(waves), _tensor_fields(cases)

        def loads(w, c):
            case = dataclasses.replace(cases, **dict(zip(cf, c)))
            mor = _pointwise_morison(
                model, dataclasses.replace(waves, **dict(zip(wf, w))), case,
                case.t_analysis, n_gauss, accel)
            return assemble_loads(model, case, mor.nodal_forces, L_m), mor
        parts = [torch.func.vmap(loads)(
            tuple(getattr(waves, n)[lo:lo + step] for n in wf),
            tuple(getattr(cases, n)[lo:lo + step] for n in cf))
            for lo in range(0, C, step)]
        F = torch.cat([p[0] for p in parts])
        mor = type(parts[0][1])(*(torch.cat(x) for x in
                                  zip(*(p[1] for p in parts))))
        U = solve_mod.solve_factored(fac, F)               # [C, n_dof]
        res = _recover(model, dataclasses.replace(cases,
                                                  fy=cases.fy[:, None]),
                       K, U, F, fixed, K_local, T, L_m, mor)
    return res if mesh is None else comm.gather_tree(res, mesh, sizes)


@spans.spanned(spans.RECOVER)
def _envelope_from_reductions(ts, per_phase, member_envelope, tot):
    max_per_case = torch.amax(per_phase, dim=-1)
    return EnvelopeResults(
        ts=ts, utilization=None,
        max_util_per_phase=per_phase,
        max_util_per_case=max_per_case,
        critical_phase=torch.argmax(per_phase, dim=-1),
        governing_case=torch.argmax(max_per_case),
        member_envelope=member_envelope,
        total_morison=tot)


def _condensed_envelope_chunk(prep: CondensedPrepared, waves: FourierWave,
                              cases: LoadCase, lo: int, hi: int, n_steps,
                              n_gauss, kinematics, stretching, current_alpha):
    """The per-case body of the condensed envelope over cases lo..hi-1:
    each case's loads, then ONE condensed solve of all their phases.
    Returns the reductions only (ts [c, S], max over members [c, S], max
    over phases [c, Mr], total Morison [c, S, 3]); no displacement field
    or reaction is built.  ``cases`` is cast to the solve dtype."""
    ts, F_I_nodes, g, tot = zip(*(
        _scan_loads(prep, waves.case(i), cases.case(i), n_steps, n_gauss,
                    kinematics, stretching, current_alpha)
        for i in range(lo, hi)))
    U_In, v, _, _ = _condensed_solution(prep, torch.cat(F_I_nodes),
                                        torch.cat(g), refine_steps=1)
    with spans.span(spans.RECOVER):
        vm = _von_mises(prep, U_In, v).reshape(hi - lo, n_steps, -1)
        util = vm / cases.fy[lo:hi, None, None]
        return (torch.stack(ts), torch.amax(util, dim=2),
                torch.amax(util, dim=1), torch.stack(tot).to(prep.K_I.dtype))


@spans.spanned(spans.ENTRY)
def design_envelope_condensed(coarse: JacketModel, refined: JacketModel,
                              n_seg: int, waves: FourierWave,
                              cases: LoadCase, n_steps: int = 36,
                              n_gauss: int = 15,
                              solve_dtype: torch.dtype = torch.float32,
                              case_batch: int = 32,
                              kinematics: str = "fused",
                              chain_solver: str = "auto",
                              current_alpha=None, support_stiffness=None,
                              mesh=None,
                              stretching: str = "none") -> EnvelopeResults:
    """Storm envelope on a refined mesh: every case x phase, full FEM.

    ``waves`` is a batched :class:`FourierWave` and ``cases`` a
    :class:`LoadCase` with ``[C]`` numeric fields (see
    ``parallel.sweep.make_wave_batch`` / ``make_case_batch``); E and nu
    must be shared by all cases.  The case-independent factorization
    (:func:`prepare_condensed`) is built once per call; each case then
    costs its Morison loads, a condensed solve of its ``n_steps`` phases
    with one round of iterative refinement, and the recovery, of which
    only reductions are kept: per-(case, phase) maximum utilization and
    the member envelope.

    The refinement round is the condensed scan's default; the JAX
    package's envelope has none, which leaves its float32 chain sweeps
    ~4e-3 off float64 at the 9,612-DOF flagship mesh.  With it, envelope
    case ``i`` equals ``phase_scan_prepared`` of case ``i``.

    ``kinematics='fused'`` (the default, as in the scan) runs the loads
    through the CUDA kernel and streams cases one at a time, so that each
    case equals its prepared scan bit for bit; ``'separable'`` (its plain
    version) solves ``case_batch`` cases per condensed solve.  In float64
    results do not depend on ``case_batch``.

    With ``mesh`` (a 1-D DeviceMesh, axis 'cases'; every rank of its group
    makes the same call) every rank factors the case-independent chains
    itself and streams its equal contiguous block of cases; the per-case
    reductions are all-gathered and the member envelope is one
    all-reduce-max, so every rank returns the whole envelope, bit-equal
    to the unsharded call where a case's arithmetic does not depend on its
    batch (``kinematics='fused'``, or a ``case_batch`` that divides the
    rank blocks).
    """
    _check_shared_material(cases)
    _check_no_slam(cases, "design_envelope_condensed")
    _check_batch_kinematics(kinematics)
    if case_batch < 1:
        raise ValueError(f"case_batch must be >= 1, got {case_batch}")
    # every numeric field as [C] in the solve dtype, so each case indexes
    C, cases = _case_batch(waves, cases, solve_dtype, refined.device)
    if mesh is not None:
        block, sizes = _mesh_cases(mesh, C, "design_envelope_condensed")
        waves, cases = _case_slice(waves, block), _case_slice(cases, block)
        C = sizes[0]
    prep = prepare_condensed(
        coarse, refined, n_seg, E=cases.E[0], nu=cases.nu[0],
        chain_solver=chain_solver, solve_dtype=solve_dtype,
        support_stiffness=support_stiffness)
    # One condensed solve of all cases is 1.7-3.2x faster on an H100, but
    # its float32 interface solve rounds differently from a per-case one:
    # 5.8e-5 off the per-case scans, though as close to float64 (PERF.md).
    bs = 1 if kinematics in _KERNEL_KINEMATICS else case_batch
    with _full_f32_matmul():
        chunks = [_condensed_envelope_chunk(
            prep, waves, cases, lo, min(lo + bs, C), n_steps, n_gauss,
            kinematics, stretching, current_alpha)
            for lo in range(0, C, bs)]
    ts, per_phase, member_max, tot = (torch.cat(x) for x in zip(*chunks))
    member_env = torch.amax(member_max, dim=0)
    if mesh is not None:
        ts, per_phase, tot = comm.gather_tree((ts, per_phase, tot), mesh,
                                              sizes)
        member_env = comm.all_reduce_max(member_env, mesh)
    return _envelope_from_reductions(ts, per_phase, member_env, tot)


# ---------------------------------------------------------------------------
# Irregular seas and the frequency domain
# ---------------------------------------------------------------------------
#
# ``ops.dynamics`` imports this module, so the dynamic spectral paths import
# it inside their functions.

def sea_scan_prepared(prep: CondensedPrepared, sea: SpectralSea,
                      case: LoadCase, ts, n_gauss: int = 15,
                      refine_steps: int = 1, stretching: str = "none",
                      current_alpha=None) -> CondensedScanResults:
    """Irregular-sea time-history response on a prepared condensed model:
    the full refined FEM problem at every sample time ``ts`` [S] of a
    random-sea realization (:func:`.ops.spectrum.make_random_sea`).  The
    loads of all components at all times are one launch of the fused
    Morison kernel's general-mode instance on the card (the model's
    dtype; the plain version on the CPU, and on the card at ``n_gauss`` >
    16, with no launch and one plain route counted), condensed onto the
    handle's interface factorization, and all S solves are one multi-RHS
    condensed solve.  ``stretching='wheeler'`` is the standard crest
    treatment for linear irregular seas (API RP 2A).  Feed ``von_mises`` to
    :func:`.ops.spectrum.spectral_fatigue_screen`."""
    _check_no_slam(case, "sea_scan_prepared")
    refined = prep.refined
    ldtype, dev = refined.dtype, refined.device
    case_s = case.cast(prep.K_I.dtype, dev)
    with _full_f32_matmul():
        case_l = case_s.cast(ldtype, dev)
        ts = torch.as_tensor(ts, dtype=ldtype, device=dev)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
        sea_fn = (morison_sea_end_forces_cuda if kernel_route(dev, n_gauss)
                  else morison_sea_end_forces)
        F1, F2, drag, inertia = sea_fn(
            sea.to(ldtype, dev), refined.coords, conn_h, D_m,
            case_l.wave_dir_deg, case_l.current_dir_deg, Cd_h, Cm_h,
            case_l.rho_water, ts, n_gauss=n_gauss,
            current_alpha=current_alpha, stretching=stretching)
        F_I_nodes, g = _chain_layout_loads(prep.coarse, refined, case_l, F1,
                                           F2, prep.L_m.to(ldtype),
                                           prep.n_seg)
        return _prepared_results(prep, case_s, ts,
                                 F_I_nodes.to(prep.K_I.dtype),
                                 g.to(prep.K_I.dtype), drag + inertia,
                                 refine_steps)


class FreqTransfer(NamedTuple):
    """Per-component transfer rows of one sea state: the response to
    component i is ``X_cos[i] cos(w_i t) + X_sin[i] sin(w_i t)`` about
    ``X_mean`` (which carries all static loading).  Feed to
    :func:`.ops.freqdomain.spectral_stats`."""

    omega: torch.Tensor        # [N] component frequencies (rad/s)
    U_mean: torch.Tensor       # [n_dof] displacements (mm), refined layout
    U_cos: torch.Tensor        # [N, n_dof]
    U_sin: torch.Tensor        # [N, n_dof]
    stress_mean: torch.Tensor  # [Mr, 8] normal stress at the 8 points (MPa)
    stress_cos: torch.Tensor   # [N, Mr, 8]
    stress_sin: torch.Tensor   # [N, Mr, 8]
    totals: torch.Tensor       # [2N+1, 3] global hydro force rows (N)
    sigma_v_max: torch.Tensor  # linearization diagnostics
    c_lin_mean: torch.Tensor
    totals_moment: torch.Tensor  # [2N+1, 3] moment rows about the mudline


def _wave_only(case: LoadCase) -> LoadCase:
    """``case`` with every static load stripped (topside, self-weight,
    buoyancy, wind): the component rows carry pure wave loading."""
    zero = torch.zeros_like(torch.as_tensor(case.F_axial_kN))
    return dataclasses.replace(
        case, F_axial_kN=zero, F_shear_kN=zero, M_moment_kNm=zero,
        M_torsion_kNm=zero, custom_sw_tonnes=zero, sw_mode="none",
        buoyancy="none", wind_speed_ms=0.0)


def _sea_transfer_loads(prep: CondensedPrepared, sea: SpectralSea,
                        case_l: LoadCase, n_gauss: int, current_alpha):
    """The Borgman-linearized load rows of a sea in the chain layout (the
    model's dtype): (lin, F_I [2N+1, nc, 6], g [2N+1, n_int, Mc, 6]); the
    mean row carries the full case, the component rows wave loading
    only."""
    from .ops.freqdomain import linearized_sea_loads
    coarse, refined = prep.coarse, prep.refined
    conn_h, D_m, Cd_h, Cm_h = hydro_members(
        refined, case_l.marine_growth_mm, case_l.Cd, case_l.Cm)
    lin = linearized_sea_loads(sea, refined.coords, conn_h, D_m,
                               case_l.wave_dir_deg, case_l.current_dir_deg,
                               Cd_h, Cm_h, case_l.rho_water, n_gauss=n_gauss,
                               current_alpha=current_alpha)
    L_m = prep.L_m.to(refined.dtype)
    F_I_m, g_m = _chain_layout_loads(coarse, refined, case_l, lin.F1[:1],
                                     lin.F2[:1], L_m, prep.n_seg)
    F_I_d, g_d = _chain_layout_loads(coarse, refined, _wave_only(case_l),
                                     lin.F1[1:], lin.F2[1:], L_m, prep.n_seg)
    return lin, torch.cat([F_I_m, F_I_d]), torch.cat([g_m, g_d])


def _spectral_transfer(prep: CondensedPrepared, sea: SpectralSea,
                       case: LoadCase, n_gauss: int, refine_steps: int,
                       current_alpha) -> FreqTransfer:
    """:func:`spectral_transfer_prepared` with ``case`` on the model's
    device."""
    refined = prep.refined
    sea = sea.to(refined.dtype, refined.device)
    return _transfer_rows(prep, sea, *_sea_transfer_loads(
        prep, sea, case.cast(refined.dtype, refined.device), n_gauss,
        current_alpha), refine_steps)


def _transfer_rows(prep: CondensedPrepared, sea: SpectralSea, lin, F_I, g,
                   refine_steps: int) -> FreqTransfer:
    """The quasi-static transfer rows of the load rows ``F_I`` / ``g``
    (:func:`_sea_transfer_loads`): all 2N+1 rows in one condensed
    multi-RHS solve, stresses by ``normal_stress_8pt`` in the solve
    dtype."""
    refined = prep.refined
    solve_dtype = prep.K_I.dtype
    U_In, v, _, _ = _condensed_solution(prep, F_I.to(solve_dtype),
                                        g.to(solve_dtype), refine_steps)
    U = _chain_to_global(U_In, v)
    F1e = _node1_forces(prep, U_In, v)
    s8 = normal_stress_8pt(refined.sections.to(solve_dtype), refined.sect_id,
                           F1e[..., 0], F1e[..., 4], F1e[..., 5])
    N = sea.n_modes
    return FreqTransfer(
        omega=sea.omega.to(solve_dtype), U_mean=U[0], U_cos=U[1:1 + N],
        U_sin=U[1 + N:], stress_mean=s8[0], stress_cos=s8[1:1 + N],
        stress_sin=s8[1 + N:], totals=lin.totals.to(solve_dtype),
        sigma_v_max=lin.sigma_v_max, c_lin_mean=lin.c_lin_mean,
        totals_moment=lin.totals_moment.to(solve_dtype))


def spectral_transfer_prepared(prep: CondensedPrepared, sea: SpectralSea,
                               case: LoadCase, n_gauss: int = 15,
                               refine_steps: int = 1,
                               current_alpha=None) -> FreqTransfer:
    """The 2N+1 Borgman-linearized transfer solves of a sea state (the
    mean row with the full case, the component rows with wave loading
    only), returning the raw per-component response rows."""
    _check_no_slam(case, "spectral_transfer_prepared")
    with _full_f32_matmul():
        return _spectral_transfer(
            prep, sea, case.cast(prep.K_I.dtype, prep.refined.device),
            n_gauss, refine_steps, current_alpha)


def _stats(tr: FreqTransfer, case: LoadCase, T_storm_s, exposure_years,
           curve, scf, occurrence):
    """:func:`.ops.freqdomain.spectral_stats` of transfer rows, the numbers
    in their dtype on their device."""
    from .ops.freqdomain import spectral_stats
    ref = tr.U_mean

    def num(v):
        return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)
    return spectral_stats(
        tr.omega, tr.stress_mean, tr.stress_cos, tr.stress_sin, tr.U_mean,
        tr.U_cos, tr.U_sin, tr.totals, num(case.fy), num(T_storm_s),
        num(exposure_years), curve=curve, scf=num(scf),
        occurrence=num(occurrence), sigma_v_max=tr.sigma_v_max,
        c_lin_mean=tr.c_lin_mean, totals_moment=tr.totals_moment)


def spectral_response_prepared(prep: CondensedPrepared, sea: SpectralSea,
                               case: LoadCase,
                               T_storm_s: float = 3.0 * 3600.0,
                               exposure_years: float = 1.0,
                               curve: str = "D-sea-cp", scf=1.0,
                               occurrence: float = 1.0, n_gauss: int = 15,
                               refine_steps: int = 1, current_alpha=None):
    """Frequency-domain stochastic response of one sea state: the 2N+1
    transfer solves of :func:`spectral_transfer_prepared`, then closed-form
    statistics (:class:`.ops.freqdomain.FreqDomainResponse`: stress
    standard deviations, upcrossing rates, narrow-band and Wirsching-Light
    fatigue over ``exposure_years`` x ``occurrence``, MPM extremes over
    ``T_storm_s``).  ``scf`` is a scalar or per-refined-member [Mr]."""
    tr = spectral_transfer_prepared(prep, sea, case, n_gauss=n_gauss,
                                    refine_steps=refine_steps,
                                    current_alpha=current_alpha)
    return _stats(tr, case, T_storm_s, exposure_years, curve, scf,
                  occurrence)


_CB_CACHE: dict = {}


def _cached_cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                      n_chain_modes, support_stiffness, added_mass_Ca,
                      rho_water):
    """Craig-Bampton reduction memoized on the models' identity and every
    other input (springs and added mass by value): it does not depend on
    the sea state, so scatter sweeps pay it once."""
    from .ops.dynamics import _cb_reduce
    ss_key = None if support_stiffness is None \
        else np.asarray(support_stiffness, np.float64).tobytes()
    ca_key = None if added_mass_Ca is None \
        else np.asarray(added_mass_Ca, np.float64).tobytes()
    key = (id(coarse), id(refined), n_seg, float(E), float(nu),
           float(topside_mass_t), int(n_chain_modes), ss_key, ca_key,
           float(rho_water))
    hit = _CB_CACHE.get(key)
    if hit is None:
        if len(_CB_CACHE) >= 4:
            _CB_CACHE.clear()
        cb = _cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                        n_chain_modes, support_stiffness=support_stiffness,
                        added_mass_Ca=added_mass_Ca, rho_water=rho_water)
        hit = (coarse, refined, cb)       # strong refs pin the id keys
        _CB_CACHE[key] = hit
    return hit[2]


_MODAL_CACHE: dict = {}


def _cb_modal_basis(cb, damping: str, damping_ratio: float,
                    n_modes_device: int = 64):
    """Mass-normalized full modal basis of the reduced (K, M) and the
    per-mode damping coefficients, memoized on the reduction's identity:
    (w2n [n_f], phi [n_f, n_f], c_j [n_f]).  ``torch.linalg.eigh`` runs on
    the card as on the CPU, so the basis is always complete;
    ``n_modes_device`` (the JAX package's truncation for a device without
    eigh) is accepted and not used."""
    from .ops.dynamics import _reduced_ff
    key = (id(cb), damping, damping_ratio)
    hit = _MODAL_CACHE.get(key)
    if hit is not None:
        return hit[1:]
    dtype = cb.K_red.dtype
    with _full_f32_matmul():
        K_ff, M_ff = _reduced_ff(cb)
        Lm = torch.linalg.cholesky(M_ff)
        Y = torch.linalg.solve_triangular(Lm, K_ff, upper=False)
        Am = torch.linalg.solve_triangular(Lm, Y.mT, upper=False)
        w2n, V = torch.linalg.eigh(0.5 * (Am + Am.mT))
        w2n = torch.clamp(w2n, min=0.0)
        wn = torch.sqrt(w2n)
        phi = torch.linalg.solve_triangular(Lm.mT, V, upper=True)
    if damping == "modal":
        c_j = (2.0 * damping_ratio * wn).to(dtype)
    else:                                              # 'rayleigh'
        wn_np = wn.cpu().numpy()
        w1 = float(wn_np[0])
        w2r = next((float(v) for v in wn_np[1:] if v > 1.01 * w1), 3.0 * w1)
        alpha = damping_ratio * 2.0 * w1 * w2r / (w1 + w2r)
        beta = damping_ratio * 2.0 / (w1 + w2r)
        c_j = (alpha + beta * w2n).to(dtype)
    if len(_MODAL_CACHE) >= 8:
        _MODAL_CACHE.clear()
    _MODAL_CACHE[key] = (cb, w2n, phi, c_j)   # strong ref pins the id key
    return w2n, phi, c_j


def _check_damping(damping: str, damping_ratio: float) -> None:
    if damping not in ("modal", "rayleigh"):
        raise ValueError("damping must be 'modal' or 'rayleigh', got "
                         f"{damping!r}")
    if not 0.0 < float(damping_ratio) < 1.0:
        raise ValueError("damping_ratio must be in (0, 1), got "
                         f"{damping_ratio}")


def _dynamic_transfer_core(prep: CondensedPrepared, cb, w2n, phi, c_j,
                           sea: SpectralSea, case: LoadCase, n_gauss: int,
                           current_alpha,
                           hydro_damping: bool = False) -> FreqTransfer:
    """Per-sea dynamic transfer rows by mode acceleration: the exact static
    rows of the condensed solve plus the expanded modal correction q(w) -
    q(0) on the Craig-Bampton basis.  ``hydro_damping=True`` adds the
    Borgman-linearized relative-velocity drag damping projected on the
    modal diagonal."""
    from .ops.dynamics import (_cb_expand, _cb_reduce_forces,
                               element_hydro_damping)
    refined, n_seg = prep.refined, prep.n_seg
    dtype, dev = refined.dtype, refined.device
    sea = sea.to(dtype, dev)
    lin, F_I, g = _sea_transfer_loads(prep, sea, case.cast(dtype, dev),
                                      n_gauss, current_alpha)
    tr_s = _transfer_rows(prep, sea, lin, F_I, g, 1)
    # work-conjugate projection of the rows to the reduced space
    F_red = _cb_reduce_forces(cb, _chain_to_global(F_I, g), cb.nc, n_seg,
                              dtype)
    F_f = F_red[:, cb.free]
    edofs = element_dof_indices(refined.conn)
    if hydro_damping:
        # modal-diagonal projection of the linearized drag damping
        # (structural members only; appurtenance damping neglected)
        Mr = refined.conn.shape[0]
        C_e = element_hydro_damping(refined.coords, refined.conn,
                                    lin.c_damp[:Mr])
        P_red = phi.new_zeros(phi.shape[1], cb.n_red)
        P_red[:, cb.free] = phi.mT
        pe = _cb_expand(cb, P_red)[:, edofs]           # [n_modes, Mr, 12]
        c_h = torch.einsum("nmi,mij,nmj->n", pe, C_e, pe)
        c_j = c_j + torch.clamp(c_h, min=0.0)

    N = sea.n_modes
    w = sea.omega
    fc = F_f[1:1 + N] @ phi                            # [N, n_f]
    fs = F_f[1 + N:] @ phi
    d_ = w2n[None, :] - (w**2)[:, None]
    cw = c_j[None, :] * w[:, None]
    det = d_**2 + cw**2
    qc = (d_ * fc - cw * fs) / det
    qs = (cw * fc + d_ * fs) / det
    # mode acceleration: each mode's static response comes out, the exact
    # static content comes from the condensed solve
    w2s = torch.clamp(w2n, min=1e-30)
    Xc = (qc - fc / w2s) @ phi.mT
    Xs = (qs - fs / w2s) @ phi.mT
    X = torch.cat([Xc.new_zeros(1, Xc.shape[1]), Xc, Xs])
    U_red = X.new_zeros(X.shape[0], cb.n_red)
    U_red[:, cb.free] = X
    U = _cb_expand(cb, U_red) + torch.cat(
        [tr_s.U_mean[None], tr_s.U_cos, tr_s.U_sin]).to(dtype)
    F1e = matvec12(-(cb.K_local @ cb.T)[:, :6, :], U[:, edofs])
    s8 = normal_stress_8pt(refined.sections, refined.sect_id, F1e[..., 0],
                           F1e[..., 4], F1e[..., 5])
    return FreqTransfer(
        omega=w, U_mean=U[0], U_cos=U[1:1 + N], U_sin=U[1 + N:],
        stress_mean=s8[0], stress_cos=s8[1:1 + N], stress_sin=s8[1 + N:],
        totals=lin.totals.to(dtype), sigma_v_max=lin.sigma_v_max,
        c_lin_mean=lin.c_lin_mean, totals_moment=lin.totals_moment.to(dtype))


def spectral_transfer_dynamic(coarse: JacketModel, refined: JacketModel,
                              n_seg: int, sea: SpectralSea, case: LoadCase,
                              damping_ratio: float = 0.02,
                              damping: str = "modal",
                              n_chain_modes: int = 12,
                              topside_mass_t: float | None = None,
                              support_stiffness=None, added_mass_Ca=None,
                              n_gauss: int = 15, current_alpha=None,
                              prep: CondensedPrepared | None = None,
                              hydro_damping: bool = False) -> FreqTransfer:
    """Per-component dynamic transfer rows (mode acceleration): the exact
    quasi-static rows of :func:`spectral_transfer_prepared` (``prep`` is
    built when not given) plus, per retained mode j and component i, the
    closed-form modal amplification with d = w_j^2 - w_i^2, c = c_j w_i:
    q_cos = (d f_cos - c f_sin) / det, q_sin = (c f_cos + d f_sin) / det,
    minus its static part.  ``damping``: 'modal' (c_j = 2 zeta w_j) or
    'rayleigh' (anchored at the first two distinct frequencies).  The
    Craig-Bampton reduction (``_cached_cb_reduce``) and its modal basis
    (``_cb_modal_basis``) are cached across calls."""
    _check_no_slam(case, "spectral_transfer_dynamic")
    _check_damping(damping, damping_ratio)
    case = case.cast(refined.dtype, refined.device)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    if prep is None:
        prep = prepare_condensed(coarse, refined, n_seg, E=float(case.E),
                                 nu=float(case.nu),
                                 support_stiffness=support_stiffness)
    cb = _cached_cb_reduce(coarse, refined, n_seg, float(case.E),
                           float(case.nu), topside_mass_t, n_chain_modes,
                           support_stiffness, added_mass_Ca,
                           float(case.rho_water))
    w2n, phi, c_j = _cb_modal_basis(cb, damping, float(damping_ratio))
    with _full_f32_matmul():
        return _dynamic_transfer_core(prep, cb, w2n, phi, c_j, sea, case,
                                      n_gauss, current_alpha,
                                      hydro_damping=hydro_damping)


def spectral_response_dynamic(coarse: JacketModel, refined: JacketModel,
                              n_seg: int, sea: SpectralSea, case: LoadCase,
                              damping_ratio: float = 0.02,
                              damping: str = "modal",
                              T_storm_s: float = 3.0 * 3600.0,
                              exposure_years: float = 1.0,
                              curve: str = "D-sea-cp", scf=1.0,
                              occurrence: float = 1.0,
                              n_chain_modes: int = 12,
                              topside_mass_t: float | None = None,
                              support_stiffness=None, added_mass_Ca=None,
                              n_gauss: int = 15, current_alpha=None,
                              prep: CondensedPrepared | None = None,
                              hydro_damping: bool = False):
    """Dynamic frequency-domain stochastic response: the transfer of
    :func:`spectral_transfer_dynamic` (resonance-band energy amplified by
    the Craig-Bampton dynamic transfer), then the closed-form statistics
    of :func:`spectral_response_prepared`."""
    tr = spectral_transfer_dynamic(
        coarse, refined, n_seg, sea, case, damping_ratio=damping_ratio,
        damping=damping, n_chain_modes=n_chain_modes,
        topside_mass_t=topside_mass_t, support_stiffness=support_stiffness,
        added_mass_Ca=added_mass_Ca, n_gauss=n_gauss,
        current_alpha=current_alpha, prep=prep, hydro_damping=hydro_damping)
    return _stats(tr, case, T_storm_s, exposure_years, curve, scf,
                  occurrence)


def _scatter_states(states, name: str) -> tuple:
    """Scatter rows as float tuples (Hs, Tp, occurrence[, heading]),
    checked: at least one row, 3 or 4 columns, occurrences summing to at
    most 1."""
    states = tuple(tuple(float(v) for v in row) for row in states)
    if not states:
        raise ValueError(f"{name} needs at least one (Hs, Tp, occurrence) "
                         "state")
    if any(len(r) not in (3, 4) for r in states):
        raise ValueError("scatter rows must be (Hs, Tp, occurrence"
                         "[, heading_deg])")
    total_occ = sum(r[2] for r in states)
    if total_occ > 1.0 + 1e-9:
        raise ValueError(
            f"scatter-diagram occurrences sum to {total_occ:.3f} > 1")
    return states


class ScatterFatigue(NamedTuple):
    """Scatter-diagram fatigue accumulation over several sea states (time
    domain)."""

    damage_rainflow: torch.Tensor    # [M] Miner sum over all states
    damage_rayleigh: torch.Tensor    # [M]
    life_years_rainflow: torch.Tensor
    life_years_rayleigh: torch.Tensor
    per_state_rainflow: np.ndarray   # [n_states, M]
    states: tuple                    # ((Hs, Tp, occurrence[, heading]), ...)


def scatter_fatigue(prep: CondensedPrepared, case: LoadCase, states, d,
                    exposure_years: float, curve: str = "D-sea-cp",
                    scf: float = 1.0, n_components: int = 48,
                    n_steps: int = 1024, seed: int = 0, U_c=0.0,
                    spectrum: str = "jonswap", stretching: str = "wheeler",
                    current_alpha=None, spreading_s=None) -> ScatterFatigue:
    """Fatigue over a scatter diagram of sea states in the time domain:
    each (Hs, Tp, occurrence[, heading]) row is realized as a random sea
    (seed ``seed + i``), its full refined FEM response history solved by
    :func:`sea_scan_prepared` (``n_steps`` samples at Tp / 10), screened
    by :func:`.ops.spectrum.spectral_fatigue_screen`, and the per-member
    damages summed (Miner).  A 4th column sets the state's wave heading
    and rotates the current with it."""
    states = _scatter_states(states, "scatter_fatigue")
    rel_dir = case.current_dir_deg - case.wave_dir_deg
    refined = prep.refined
    d_rf = d_nb = None
    per_state = []
    for i, row in enumerate(states):
        Hs, Tp, occ = row[:3]
        case_i = case
        if len(row) == 4:
            case_i = dataclasses.replace(case, wave_dir_deg=row[3],
                                         current_dir_deg=row[3] + rel_dir)
        sea = make_random_sea(Hs, Tp, d, n_components=n_components,
                              seed=seed + i, spectrum=spectrum, U_c=U_c,
                              spreading_s=spreading_s, dtype=refined.dtype,
                              device=refined.device)
        dt = Tp / 10.0
        hist = sea_scan_prepared(prep, sea, case_i, np.arange(n_steps) * dt,
                                 stretching=stretching,
                                 current_alpha=current_alpha)
        scr = spectral_fatigue_screen(hist.von_mises, dt,
                                      exposure_years=exposure_years,
                                      curve=curve, scf=scf, occurrence=occ)
        rf = scr.damage_rainflow.numpy()
        nb = scr.damage_rayleigh.numpy()
        per_state.append(rf)
        d_rf = rf if d_rf is None else d_rf + rf
        d_nb = nb if d_nb is None else d_nb + nb
    with np.errstate(divide="ignore"):
        life_rf = np.where(d_rf > 0, exposure_years / d_rf, np.inf)
        life_nb = np.where(d_nb > 0, exposure_years / d_nb, np.inf)
    t = torch.from_numpy
    return ScatterFatigue(
        damage_rainflow=t(d_rf), damage_rayleigh=t(d_nb),
        life_years_rainflow=t(life_rf), life_years_rayleigh=t(life_nb),
        per_state_rainflow=np.stack(per_state), states=states)


class ScatterFatigueSpectral(NamedTuple):
    """Frequency-domain scatter-diagram fatigue (no time march)."""

    damage_nb: torch.Tensor          # [M] narrow-band Miner sum, all states
    damage_wl: torch.Tensor          # [M] Wirsching-Light corrected sum
    life_years_nb: torch.Tensor
    life_years_wl: torch.Tensor
    per_state_wl: np.ndarray         # [n_states, M]
    mpm_utilization: torch.Tensor    # [M] max over states (per-state storm)
    states: tuple                    # ((Hs, Tp, occurrence[, heading]), ...)
    per_state_sigma: np.ndarray      # [n_states, M] stress std dev (MPa)
    per_state_mean: np.ndarray       # [n_states, M] mean stress (MPa)
    per_state_nu0: np.ndarray        # [n_states, M] upcrossing rate (Hz)


def _scatter_spectral_setup(prep: CondensedPrepared, case: LoadCase, states,
                            d, *, n_components: int, seed: int,
                            spectrum: str, U_c, spreading_s):
    """The per-state inputs of :func:`scatter_fatigue_spectral`: (seas, one
    :class:`SpectralSea` a state in the model's dtype on its device, state
    headings [B] and occurrences [B] in the solve dtype, B).  The seas are
    drawn on the host (``make_random_sea``) and each moved once."""
    refined = prep.refined
    seas = [make_random_sea(r[0], r[1], d, n_components=n_components,
                            seed=seed + i, spectrum=spectrum, U_c=U_c,
                            spreading_s=spreading_s, dtype=refined.dtype,
                            device=refined.device)
            for i, r in enumerate(states)]
    heads = np.array([r[3] if len(r) == 4 else float(case.wave_dir_deg)
                      for r in states], np.float64)
    occs = np.array([r[2] for r in states], np.float64)
    opts = dict(dtype=prep.K_I.dtype, device=refined.device)
    return (seas, torch.as_tensor(heads, **opts),
            torch.as_tensor(occs, **opts), len(states))


def _scatter_spectral_one_fn(prep: CondensedPrepared, case: LoadCase, dyn,
                             n_gauss, current_alpha, curve, exposure_years,
                             storm_hours, scf, hydro_damping=False):
    """The per-state body of the scatter: quasi-static (``dyn`` None) or
    Craig-Bampton dynamic transfer rows of one (sea, heading, occurrence),
    then the closed-form statistics; returns (damage_nb, damage_wl,
    mpm_utilization, sigma, mean, nu0), each [Mr]."""
    case_s = case.cast(prep.K_I.dtype, prep.refined.device)
    rel = case_s.current_dir_deg - case_s.wave_dir_deg

    def one(sea, head, occ):
        case_i = dataclasses.replace(case_s, wave_dir_deg=head,
                                     current_dir_deg=head + rel)
        if dyn is None:
            tr = _spectral_transfer(prep, sea, case_i, n_gauss, 1,
                                    current_alpha)
        else:
            cb, w2n, phi, c_j = dyn
            tr = _dynamic_transfer_core(prep, cb, w2n, phi, c_j, sea, case_i,
                                        n_gauss, current_alpha,
                                        hydro_damping=hydro_damping)
        st = _stats(tr, case_s, storm_hours * 3600.0, exposure_years, curve,
                    scf, occ)
        return (st.damage_nb, st.damage_wl, st.mpm_utilization,
                st.sigma_stress, st.mean_stress, st.nu0_hz)
    return one


def _scatter_spectral_batched(prep, case, seas, heads, occs, dyn, n_gauss,
                              current_alpha, curve, exposure_years,
                              storm_hours, scf, hydro_damping=False):
    """The whole diagram, one state at a time (one state's memory; each
    state equals its own :func:`spectral_response_prepared` /
    :func:`spectral_response_dynamic`): six [B, Mr] stacks."""
    one = _scatter_spectral_one_fn(prep, case, dyn, n_gauss, current_alpha,
                                   curve, exposure_years, storm_hours, scf,
                                   hydro_damping)
    with _full_f32_matmul():
        rows = [one(sea, heads[i], occs[i]) for i, sea in enumerate(seas)]
    return tuple(torch.stack(x) for x in zip(*rows))


def scatter_fatigue_spectral(prep: CondensedPrepared, case: LoadCase,
                             states, d, exposure_years: float,
                             curve: str = "D-sea-cp", scf=1.0,
                             n_components: int = 48, seed: int = 0,
                             U_c=0.0, spectrum: str = "jonswap",
                             current_alpha=None, spreading_s=None,
                             n_gauss: int = 15, dynamic: bool = False,
                             damping_ratio: float = 0.02,
                             damping: str = "modal",
                             n_chain_modes: int = 12,
                             topside_mass_t: float | None = None,
                             added_mass_Ca=None, support_stiffness=None,
                             storm_hours: float = 3.0, mesh=None,
                             hydro_damping: bool = False
                             ) -> ScatterFatigueSpectral:
    """Long-term fatigue over an (Hs, Tp, occurrence[, heading]) scatter
    diagram in the frequency domain: each state costs the 2N+1 transfer
    solves of :func:`spectral_transfer_prepared` (one multi-RHS condensed
    solve) and a closed-form statistics pass, and the per-member
    narrow-band and Wirsching-Light damages add up over the states
    (Miner).  ``dynamic=True`` takes every state's transfer through the
    Craig-Bampton mode-acceleration dynamic transfer; the reduction and
    its modal basis are state-independent and built once.

    The states run one after another, each its own condensed solve (the
    JAX package streams them through ``lax.map``): one state's memory,
    and each state equals its single-state call.  With ``mesh`` (a 1-D
    DeviceMesh, axis 'cases'; every rank of its group makes the same call)
    the states are padded to a multiple of the ranks by repeating the last
    sea with zero occurrence, each rank runs its equal contiguous block,
    the per-state rows are all-gathered (the padding stripped) and summed
    in state order on every rank: the same bits as the unsharded call."""
    states = _scatter_states(states, "scatter_fatigue_spectral")
    _check_no_slam(case, "scatter_fatigue_spectral")
    if mesh is not None:        # before the state set-up and any reduction
        _, rank, W = comm.mesh_info(mesh)
    case = case.cast(prep.refined.dtype, prep.refined.device)
    dyn = None
    if dynamic:
        _check_damping(damping, damping_ratio)
        if topside_mass_t is None:
            topside_mass_t = float(case.custom_sw_tonnes)
        cb = _cached_cb_reduce(prep.coarse, prep.refined, prep.n_seg,
                               float(case.E), float(case.nu),
                               topside_mass_t, n_chain_modes,
                               support_stiffness, added_mass_Ca,
                               float(case.rho_water))
        dyn = (cb,) + _cb_modal_basis(cb, damping, float(damping_ratio))
    seas, heads, occs, B = _scatter_spectral_setup(
        prep, case, states, d, n_components=n_components, seed=seed,
        spectrum=spectrum, U_c=U_c, spreading_s=spreading_s)
    if mesh is not None:
        n_pad = (-B) % W
        seas = seas + [seas[-1]] * n_pad
        heads = torch.cat([heads, heads[-1:].expand(n_pad)])
        occs = torch.cat([occs, occs.new_zeros(n_pad)])
        per = (B + n_pad) // W
        block = slice(rank * per, (rank + 1) * per)
        seas, heads, occs = seas[block], heads[block], occs[block]
    rows = _scatter_spectral_batched(
        prep, case, seas, heads, occs, dyn, n_gauss, current_alpha, curve,
        float(exposure_years), float(storm_hours), scf, hydro_damping)
    if mesh is not None:
        rows = comm.gather_tree(rows, mesh, [per] * W)
    nb, wl, mu, sig, mean_s, nu0 = (x[:B].cpu().numpy() for x in rows)
    d_nb, d_wl = nb.sum(axis=0), wl.sum(axis=0)
    with np.errstate(divide="ignore"):
        life_nb = np.where(d_nb > 0, exposure_years / d_nb, np.inf)
        life_wl = np.where(d_wl > 0, exposure_years / d_wl, np.inf)
    t = torch.from_numpy
    return ScatterFatigueSpectral(
        damage_nb=t(d_nb), damage_wl=t(d_wl), life_years_nb=t(life_nb),
        life_years_wl=t(life_wl), per_state_wl=wl,
        mpm_utilization=t(mu.max(axis=0)), states=states,
        per_state_sigma=sig, per_state_mean=mean_s, per_state_nu0=nu0)


class LongTermExtremes(NamedTuple):
    """N-year return levels from the all-states upcrossing integral."""

    return_years: np.ndarray        # [R]
    stress_mpa: np.ndarray          # [R, M] return stress level
    utilization: np.ndarray         # [R, M] level / fy
    governing_state: np.ndarray     # [R, M] index of the dominant state


def long_term_extremes(res: ScatterFatigueSpectral, return_years=(10., 100.),
                       fy: float = 355.0) -> LongTermExtremes:
    """Long-term (all sea states) extreme response levels: the rate of
    upcrossings of level x is nu(x) = sum_i occ_i nu_i exp(-(x - m_i)^2 /
    (2 sigma_i^2)) over the states' Gaussian responses, and the N-year
    level solves nu(x) T_N = 1 (vectorized bisection over members; a
    single state with occurrence 1 gives the MPM formula m + sigma
    sqrt(2 ln(nu0 T_N))).  Host numpy post-processing of a
    :func:`scatter_fatigue_spectral` result."""
    occ = np.array([r[2] for r in res.states])[:, None]      # [B, 1]
    m = np.asarray(res.per_state_mean)                        # [B, M]
    sig = np.maximum(np.asarray(res.per_state_sigma), 0.0)
    nu = np.maximum(np.asarray(res.per_state_nu0), 0.0)
    live = (sig > 1e-12) & (occ * nu > 0)
    sig_s = np.where(live, sig, 1.0)

    def nu_of(x):                                             # x: [R, 1, M]
        ex = np.exp(-0.5 * ((x - m[None]) / sig_s[None]) ** 2)
        return np.sum(np.where(live[None], occ[None] * nu[None] * ex, 0.0),
                      axis=1)                                 # [R, M]

    R = len(return_years)
    T = np.asarray(return_years, np.float64) * SECONDS_PER_YEAR
    target = 1.0 / T[:, None]
    lo = np.broadcast_to(m.max(axis=0)[None], (R, m.shape[1])).copy()
    span = (sig * np.sqrt(2.0 * np.log(np.maximum(
        nu * T.max(), np.e)))).max(axis=0) + 1e-9
    hi = lo + 3.0 * span
    for _ in range(8):          # grow hi until nu(hi) < target everywhere
        under = nu_of(hi[:, None, :]) > target
        if not under.any():
            break
        hi = np.where(under, lo + 2.0 * (hi - lo), hi)
    for _ in range(80):                                       # bisection
        mid = 0.5 * (lo + hi)
        high_side = nu_of(mid[:, None, :]) > target
        lo = np.where(high_side, mid, lo)
        hi = np.where(high_side, hi, mid)
    x = 0.5 * (lo + hi)
    dead = ~live.any(axis=0)    # no wave-induced variance: the largest mean
    x[:, dead] = m.max(axis=0)[dead]
    ex = np.exp(-0.5 * ((x[:, None, :] - m[None]) / sig_s[None]) ** 2)
    contrib = np.where(live[None], occ[None] * nu[None] * ex, 0.0)
    return LongTermExtremes(
        return_years=np.asarray(return_years, np.float64), stress_mpa=x,
        utilization=x / float(fy), governing_state=np.argmax(contrib, axis=1))


def sea_response_batch(model: JacketModel, sea: SpectralSea, case: LoadCase,
                       ts, n_gauss: int = 15, stretching: str = "none",
                       current_alpha=None,
                       support_stiffness=None) -> CondensedScanResults:
    """Irregular-sea time-history response of an unrefined (dense) model:
    K factored once (through the foundation springs when given), the
    loads of all sample times one launch of the fused Morison kernel's
    general-mode instance on the card, every sample time a column of one
    multi-RHS solve.  Returns :class:`CondensedScanResults`."""
    _check_no_slam(case, "sea_response_batch")
    dtype, dev = model.dtype, model.device
    case = case.cast(dtype, dev)
    ks_nodes, free, fixed = _ssi_spring_nodes(model, support_stiffness, dtype)
    with _full_f32_matmul():
        ts = torch.as_tensor(ts, dtype=dtype, device=dev)
        K, K_local, T, L_m = _dense_system(model, case)
        fac = _spring_dfac(K, ks_nodes, free)
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            model, case.marine_growth_mm, case.Cd, case.Cm)
        mb = morison_sea_batch(sea.to(dtype, dev), model.coords, conn_h, D_m,
                               case.wave_dir_deg, case.current_dir_deg, Cd_h,
                               Cm_h, case.rho_water, ts, n_gauss=n_gauss,
                               current_alpha=current_alpha,
                               stretching=stretching)
        F = assemble_loads(model, case, mb.nodal_forces, L_m)
        U = solve_mod.solve_factored(fac, F)
        F1, _ = internal_forces(K_local, T,
                                U[:, element_dof_indices(model.conn)])
        vm = von_mises_8pt(model.sections, model.sect_id,
                           *(F1[..., c] for c in range(6)))
        util = vm / case.fy
        # reactions through the springless K: K U - F = -k u at a spring
        R = U @ K.T - F
        return CondensedScanResults(
            ts=ts, U=U, von_mises=vm, utilization=util,
            reactions=R[:, torch.as_tensor(fixed, device=dev)]
            .reshape(ts.shape[0], -1, 6),
            total_morison=mb.total_morison,
            critical_index=torch.argmax(torch.amax(util, dim=1)))
