"""API RP 2A-WSD simple tubular-joint (punching-shear) checks (PyTorch
counterpart of ``small_fem_solver_tpu/ops/jointcheck.py``).

API RP 2A-WSD (21st ed., section 4.3) brace-end capacities of the chord
wall at every brace-to-leg connection, with the arcsine axial + bending
interaction:

- simple joints (no overlap, ring stiffeners or grout) of a BRACE (any
  non-leg member) on a CHORD (the largest-diameter leg at the node);
- Pa = Qu Qf Fyc T^2 / (1.7 sin theta), Ma = Qu Qf Fyc T^2 (0.8 d) /
  (1.7 sin theta) (4.3-1/2), Qu per Table 4.3-1 by class (K with the gap
  factor Qg, T/Y, X with Qbeta in compression; in- and out-of-plane
  bending), the chord-load factor Qf = 1 - lambda gamma A^2 for a chord in
  compression;
- UC = |P|/Pa + (2/pi) asin sqrt((M_ipb/Ma_ipb)^2 + (M_opb/Ma_opb)^2)
  (4.3-3), continued linearly past 1;
- ``joint_class`` 'Y' (default), 'K', 'X', a per-joint array, or 'auto'
  (API 4.2 load-path fractions: K action from opposing coplanar braces on
  the same side, X from same-sense ones across the chord, the rest Y).

Joint finding and the load-path classification are host numpy (a few
rows per node); the capacities and checks are tensors on the results'
device.  Brace in-plane bending is the moment about the brace-chord plane
normal (the end moment vector, torsion excluded, rotated to global axes
by :func:`.beams.local_axes`); sin theta below 0.17 (~10 deg) is clamped
and flagged.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .beams import local_axes

_FS = 1.7          # working-stress safety factor of 4.3-1/2
_SIN_MIN = 0.17    # ~10 deg: below this a punching check is meaningless
_CLASS_CODES = {"Y": 0, "T": 0, "K": 1, "X": 2}
_COPLANAR_COS = 0.866  # ~30 deg side-vector tolerance for plane membership


class JointCheck(NamedTuple):
    """Per brace-end joint check (all arrays [J])."""

    node: np.ndarray             # joint node index
    brace: np.ndarray            # brace member index
    chord: np.ndarray            # chord (leg) member index
    joint_class: np.ndarray      # str: 'Y' | 'K' | 'X' | 'auto'
    beta: torch.Tensor           # d/D
    gamma: torch.Tensor          # D/(2T)
    tau: torch.Tensor            # t/T
    sin_theta: torch.Tensor
    P_kN: torch.Tensor           # brace axial at the joint (+compression)
    Pa_kN: torch.Tensor          # allowable axial
    M_ipb_kNm: torch.Tensor
    M_opb_kNm: torch.Tensor
    Ma_ipb_kNm: torch.Tensor
    Ma_opb_kNm: torch.Tensor
    Qf_axial: torch.Tensor
    uc_axial: torch.Tensor       # |P|/Pa
    uc_bending: torch.Tensor     # (2/pi) asin sqrt(sum of squares)
    uc: torch.Tensor             # combined interaction (4.3-3)
    degenerate: np.ndarray       # bool: sin theta clamped
    frac_K: np.ndarray           # load-path action fractions ('auto':
    frac_X: np.ndarray           #   per API 4.2; fixed classes: the 0/1
    frac_Y: np.ndarray           #   indicator of the class)


def _qbeta(beta):
    b = torch.clamp(beta, 1e-3, 1.0)
    return torch.where(beta > 0.6, 0.3 / (b * (1.0 - 0.833 * b)), 1.0)


def _qg(gap_over_T, gap_over_D, gamma):
    qg_lo = 1.8 - 0.1 * gap_over_T     # gamma <= 20 branch
    qg_hi = 1.8 - 4.0 * gap_over_D     # gamma >  20 branch
    return torch.clamp(torch.where(gamma <= 20.0, qg_lo, qg_hi), min=1.0)


def qu_all(beta, gamma, tension, gap_over_T, gap_over_D):
    """All Table 4.3-1 Qu values: (qu_ty, qu_k, qu_x, qu_ipb, qu_opb)."""
    base = 3.4 + 19.0 * beta
    qb = _qbeta(beta)
    return (base, base * _qg(gap_over_T, gap_over_D, gamma),
            torch.where(tension, base, base * qb), base,
            (3.4 + 7.0 * beta) * qb)


def qu_factors(beta, gamma, class_code, tension, gap_over_T, gap_over_D):
    """(Qu_axial, Qu_ipb, Qu_opb) per API Table 4.3-1; ``class_code`` 0 =
    T/Y, 1 = K, 2 = X; ``tension`` the sense of the brace axial load."""
    qu_ty, qu_k, qu_x, qu_ipb, qu_opb = qu_all(beta, gamma, tension,
                                               gap_over_T, gap_over_D)
    qu_ax = torch.where(class_code == 1, qu_k,
                        torch.where(class_code == 2, qu_x, qu_ty))
    return qu_ax, qu_ipb, qu_opb


def joint_capacities(beta, gamma, sin_theta, T_mm, d_mm, Fyc,
                     class_code, tension,
                     Qf_ax=1.0, Qf_ipb=1.0, Qf_opb=1.0,
                     gap_over_T=0.0, gap_over_D=0.0, fractions=None):
    """Allowable (Pa [N], Ma_ipb [N*mm], Ma_opb [N*mm]) per 4.3-1/2;
    ``fractions`` (f_Y, f_K, f_X) interpolates the axial Qu (API 4.2a)
    instead of ``class_code``."""
    if fractions is None:
        qu_ax, qu_ipb, qu_opb = qu_factors(beta, gamma, class_code, tension,
                                           gap_over_T, gap_over_D)
    else:
        qu_ty, qu_k, qu_x, qu_ipb, qu_opb = qu_all(beta, gamma, tension,
                                                   gap_over_T, gap_over_D)
        fY, fK, fX = fractions
        qu_ax = fY * qu_ty + fK * qu_k + fX * qu_x
    base = Fyc * T_mm**2 / (_FS * torch.clamp(sin_theta, min=_SIN_MIN))
    return (qu_ax * Qf_ax * base, qu_ipb * Qf_ipb * base * 0.8 * d_mm,
            qu_opb * Qf_opb * base * 0.8 * d_mm)


def _find_joints(model):
    """Host-side brace-end -> chord pairing: int arrays (brace_idx,
    brace_end, chord_idx, chord_end, node) for every non-leg member end on
    a node that also hosts a leg member; where leg segments meet, the
    largest-D (then largest-t) one is the chord."""
    conn = model.conn.cpu().numpy()
    types = model.member_types or ("brace",) * conn.shape[0]
    sid = model.sect_id.cpu().numpy()
    D = model.sections.D_outer.cpu().numpy()[sid]
    t = model.sections.t.cpu().numpy()[sid]

    legs_at = {}
    for m, ty in enumerate(types):
        if ty == "leg":
            for e in (0, 1):
                legs_at.setdefault(int(conn[m, e]), []).append((m, e))
    rows = []
    for m, ty in enumerate(types):
        if ty == "leg":
            continue
        for e in (0, 1):
            n = int(conn[m, e])
            cands = legs_at.get(n)
            if not cands:
                continue
            cm, ce = max(cands, key=lambda p: (D[p[0]], t[p[0]]))
            rows.append((m, e, cm, ce, n))
    if not rows:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z, z
    arr = np.asarray(rows, dtype=np.int64)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], arr[:, 4]


def classify_load_path(coords, conn, bi, be, ci, nodes, P):
    """API 4.2 load-path action fractions (f_K, f_X, f_Y) per joint row
    (host numpy; ``P`` the brace axial per row, +compression).

    Each brace's load perpendicular to the chord is balanced greedily:
    first by opposing perpendicular loads of coplanar same-side braces (K
    action), then by same-sense loads of coplanar opposite-side braces (X
    action); the rest is Y action.  Unloaded or chord-parallel braces are
    pure Y.
    """
    coords = np.asarray(torch.as_tensor(coords).cpu(), dtype=np.float64)
    conn = np.asarray(torch.as_tensor(conn).cpu())
    P = np.asarray(P, dtype=np.float64)
    J = bi.shape[0]

    # unit vector from the joint node into each brace, and the chord axis
    other = np.where(be == 0, conn[bi, 1], conn[bi, 0])
    e = coords[other] - coords[nodes]
    e /= np.linalg.norm(e, axis=-1, keepdims=True)
    dc = coords[conn[ci, 1]] - coords[conn[ci, 0]]
    uc = dc / np.linalg.norm(dc, axis=-1, keepdims=True)

    # perpendicular (punching) direction and signed perpendicular load:
    # q < 0 pushes the chord wall from the brace's side (compression)
    w_raw = e - np.sum(e * uc, axis=-1, keepdims=True) * uc
    s = np.linalg.norm(w_raw, axis=-1)
    w = w_raw / np.where(s < 1e-9, 1.0, s)[:, None]
    q = -P * s

    fK = np.zeros(J)
    fX = np.zeros(J)
    by_node = {}
    for r in range(J):
        by_node.setdefault(int(nodes[r]), []).append(r)
    for rows in by_node.values():
        for i in rows:
            qi = q[i]
            if abs(qi) < 1e-9 or s[i] < 1e-6:
                continue
            k_avail = x_avail = 0.0
            for j in rows:
                if j == i:
                    continue
                c = float(np.dot(w[j], w[i]))
                proj = q[j] * c                # perp load of j along w_i
                if c > _COPLANAR_COS and proj * qi < 0.0:
                    k_avail += abs(proj)       # same side, opposing
                elif c < -_COPLANAR_COS and proj * qi > 0.0:
                    x_avail += abs(proj)       # through the chord
            fK[i] = min(k_avail, abs(qi)) / abs(qi)
            fX[i] = min(x_avail, abs(qi) * (1.0 - fK[i])) / abs(qi)
    return fK, fX, 1.0 - fK - fX


def _classes(joint_class, J: int) -> np.ndarray:
    if isinstance(joint_class, str) and joint_class == "auto":
        return np.full(J, "auto")
    if isinstance(joint_class, str):
        classes = np.full(J, joint_class)
    else:
        classes = np.asarray(joint_class)
        if classes.shape != (J,):
            raise ValueError(f"joint_class must be scalar or shape ({J},)")
    bad = [c for c in np.unique(classes) if c not in _CLASS_CODES]
    if bad:
        raise ValueError(f"unknown joint class(es) {bad}; "
                         "use Y/T/K/X or 'auto'")
    return classes


def joint_code_check(model, results, Fy=None, joint_class="Y",
                     gap_mm: float = 50.0) -> JointCheck:
    """API RP 2A-WSD simple-joint checks from an analysis result (run at
    the governing phase), on the results' device.  ``Fy``: chord yield
    (MPa, default 355); ``joint_class``: 'Y' (default), 'K', 'X', 'auto'
    (API 4.2 load-path fractions, interpolated Qu) or a length-J array of
    Y/T/K/X in this function's joint order; ``gap_mm``: K-joint gap."""
    bi, be, ci, ce, nodes = _find_joints(model)
    J = bi.shape[0]
    if J == 0:
        raise ValueError("no brace-to-leg joints found (are member types "
                         "set? brace-to-brace connections are not checked)")
    classes = _classes(joint_class, J)
    dev = results.F1_local.device
    sec, sid = model.sections, model.sect_id.cpu().numpy()

    def section(field, members):
        return getattr(sec, field)[torch.as_tensor(sid[members],
                                                   device=dev)]
    d, tb = section("D_outer", bi), section("t", bi)     # brace [mm]
    D, T = section("D_outer", ci), section("t", ci)      # chord [mm]
    Ac, Wc = section("Ax", ci), section("Wy", ci)
    Fy = torch.as_tensor(355.0 if Fy is None else Fy, dtype=D.dtype,
                         device=dev)
    beta = torch.clamp(d / D, 0.0, 1.0)
    gamma = D / (2.0 * T)
    tau = tb / T

    conn = model.conn.cpu().numpy()
    coords = model.coords.to(dev)
    dLb = coords[conn[bi, 1]] - coords[conn[bi, 0]]
    dLc = coords[conn[ci, 1]] - coords[conn[ci, 0]]
    Lb = torch.linalg.norm(dLb, dim=-1)
    Lc = torch.linalg.norm(dLc, dim=-1)
    ub = dLb / Lb[:, None]
    uc_ax = dLc / Lc[:, None]
    cos_t = torch.abs(torch.sum(ub * uc_ax, dim=-1))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t**2, 0.0, 1.0))

    # brace end loads at the joint (node-1 recovery is negated, so
    # +compression is -F1[0] at end 0 and +F2[0] at end 1)
    end0 = torch.as_tensor(be == 0, device=dev)
    Fb1 = results.F1_local[torch.as_tensor(bi, device=dev)]
    Fb2 = results.F2_local[torch.as_tensor(bi, device=dev)]
    P = torch.where(end0, -Fb1[:, 0], Fb2[:, 0])          # N, +compression
    My = torch.where(end0, Fb1[:, 4], Fb2[:, 4])          # N*mm, local
    Mz = torch.where(end0, Fb1[:, 5], Fb2[:, 5])

    # the bending vector in global axes, split about the brace-chord plane
    # normal; parallel members have no plane: all bending is OPB (the
    # lower capacity)
    Rb = local_axes(dLb, Lb)                              # rows (lx,ly,lz)
    M_glob = Rb[:, 1, :] * My[:, None] + Rb[:, 2, :] * Mz[:, None]
    n_raw = torch.linalg.cross(ub, uc_ax)
    n_norm = torch.linalg.norm(n_raw, dim=-1)
    n_hat = n_raw / torch.where(n_norm < 1e-9, 1.0, n_norm)[:, None]
    M_ipb = torch.abs(torch.sum(M_glob * n_hat, dim=-1))
    M_tot2 = torch.sum(M_glob**2, dim=-1)
    M_opb = torch.sqrt(torch.clamp(M_tot2 - M_ipb**2, min=0.0))
    par = n_norm < 1e-9
    M_opb = torch.where(par, torch.sqrt(M_tot2), M_opb)
    M_ipb = torch.where(par, 0.0, M_ipb)

    # chord nominal stresses at the joint for Qf
    chord0 = torch.as_tensor(ce == 0, device=dev)
    Fc1 = results.F1_local[torch.as_tensor(ci, device=dev)]
    Fc2 = results.F2_local[torch.as_tensor(ci, device=dev)]
    Nc = torch.where(chord0, -Fc1[:, 0], Fc2[:, 0])       # +compression
    Mc = torch.where(chord0, torch.sqrt(Fc1[:, 4]**2 + Fc1[:, 5]**2),
                     torch.sqrt(Fc2[:, 4]**2 + Fc2[:, 5]**2))
    A2 = ((Nc / Ac)**2 + (Mc / Wc)**2) / (0.6 * Fy)**2
    chord_comp = Nc > 0.0

    def qf(lam):
        return torch.where(chord_comp,
                           torch.clamp(1.0 - lam * gamma * A2, 1e-3, 1.0),
                           1.0)

    Qf_ax, Qf_i, Qf_o = qf(0.030), qf(0.045), qf(0.021)

    if classes[0] == "auto":
        fK, fX, fY = classify_load_path(model.coords, conn, bi, be, ci,
                                        nodes, P.cpu().numpy())
    else:
        code = np.array([_CLASS_CODES[c] for c in classes])
        fK, fX, fY = ((code == k).astype(np.float64) for k in (1, 2, 0))

    Pa, Ma_i, Ma_o = joint_capacities(
        beta, gamma, sin_t, T, d, Fy, None, P < 0.0,
        Qf_ax=Qf_ax, Qf_ipb=Qf_i, Qf_opb=Qf_o,
        gap_over_T=gap_mm / T, gap_over_D=gap_mm / D,
        fractions=tuple(torch.as_tensor(f, dtype=D.dtype, device=dev)
                        for f in (fY, fK, fX)))

    uc_ax = torch.abs(P) / Pa
    arg = torch.sqrt(torch.clamp((M_ipb / Ma_i)**2 + (M_opb / Ma_o)**2,
                                 min=0.0))
    # over-unity bending grows linearly past the asin domain, so the
    # check stays monotone in the load
    uc_b = torch.where(arg > 1.0, 1.0 + (arg - 1.0), 2.0 / math.pi
                       * torch.arcsin(torch.clamp(arg, 0.0, 1.0)))
    return JointCheck(
        node=nodes, brace=bi, chord=ci, joint_class=classes, beta=beta,
        gamma=gamma, tau=tau, sin_theta=sin_t, P_kN=P / 1e3,
        Pa_kN=Pa / 1e3, M_ipb_kNm=M_ipb / 1e6, M_opb_kNm=M_opb / 1e6,
        Ma_ipb_kNm=Ma_i / 1e6, Ma_opb_kNm=Ma_o / 1e6, Qf_axial=Qf_ax,
        uc_axial=uc_ax, uc_bending=uc_b, uc=uc_ax + uc_b,
        degenerate=(sin_t < _SIN_MIN).cpu().numpy(), frac_K=fK, frac_X=fX,
        frac_Y=fY)
