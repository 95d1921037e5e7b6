"""Human-readable analysis report, mirroring the reference GUI's log
output (PyTorch counterpart of ``small_fem_solver_tpu/utils/report.py``).

Renders the reference's sections — sections, structure, wave model,
Morison breakdown, optional phase scan, applied loads, support reactions,
displacements, and the top-10 utilization table — and the API RP 2A member
and joint unity checks as plain strings, the same text as the JAX
package's for the same analysis.  Tensors on any device are read back to
the host.
"""
from __future__ import annotations

import numpy as np

from ..models.model import JacketModel
from .io import _np, member_force_table

BAR = "=" * 70


def render_report(model: JacketModel, wave, case, results,
                  phase_scan=None, params: dict | None = None) -> str:
    L = []
    log = L.append
    log(BAR)
    log("JACKET STRUCTURAL ANALYSIS - DETAILED OUTPUT")
    log(BAR)

    sec = model.sections
    log("\n[SECTIONS]")
    log(f"  Leg: D={float(sec.D_outer[0])}mm, t={float(sec.t[0])}mm, "
        f"D/t={float(sec.D_t_ratio[0]):.1f}")
    log(f"  Brace: D={float(sec.D_outer[1])}mm, t={float(sec.t[1])}mm, "
        f"D/t={float(sec.D_t_ratio[1]):.1f}")

    log("\n[STRUCTURE]")
    log(f"  Nodes: {model.n_nodes}, Members: {model.n_members}")
    log(f"  Fixed (support): {model.fixed_node_names()}")
    log(f"  Top (interface): {model.top_node_names()}")

    log("\n[WAVE MODEL]")
    log(f"  {wave.model_info()}")
    log(f"  H={float(wave.H)}m, T={float(wave.T)}s, d={float(wave.d)}m, "
        f"L={float(wave.length):.1f}m")
    log(f"  Wave direction: {float(case.wave_dir_deg)} deg from North")
    log(f"  Current: U_c={float(wave.U_c)}m/s, "
        f"direction={float(case.current_dir_deg)} deg from North")
    try:
        from ..ops.airgap import air_gap_check
        ag = air_gap_check(model, wave, wave_dir_deg=float(case.wave_dir_deg),
                           n_phases=72)
        log(f"  Deck air gap: crest {float(ag.crest_m):.2f}m vs deck "
            f"{ag.deck_elevation_m:.1f}m -> {float(ag.air_gap_m):.2f}m "
            + ("(OK)" if bool(ag.ok) else "(WAVE-IN-DECK RISK)"))
    except ValueError:
        pass  # no top nodes: deck elevation unknown

    mor = results.morison
    log("\n" + BAR)
    log("MORISON FORCE ANALYSIS (Pure hydrodynamic loads)")
    log(BAR)
    td = _np(mor.total_drag) / 1000
    ti = _np(mor.total_inertia) / 1000
    tm = _np(mor.total_morison) / 1000
    log(f"\n[AT TIME t = {float(case.t_analysis):.2f}s]")
    log(f"  DRAG FORCE:    Fx={td[0]:8.1f} kN, Fy={td[1]:8.1f} kN, "
        f"Fz={td[2]:8.1f} kN   |F| = {np.linalg.norm(td):.1f} kN")
    log(f"  INERTIA FORCE: Fx={ti[0]:8.1f} kN, Fy={ti[1]:8.1f} kN, "
        f"Fz={ti[2]:8.1f} kN   |F| = {np.linalg.norm(ti):.1f} kN")
    log(f"  TOTAL MORISON: Fx={tm[0]:8.1f} kN, Fy={tm[1]:8.1f} kN, "
        f"Fz={tm[2]:8.1f} kN   |F| = {np.linalg.norm(tm):.1f} kN")

    if phase_scan is not None:
        ci = int(phase_scan.critical_index)
        log("\n[PHASE SCAN - Critical Phase]")
        log(f"  Time: t = {float(phase_scan.t[ci]):.3f}s")
        log(f"  Phase angle: {float(phase_scan.phase_deg[ci]):.1f} deg (wt)")
        log(f"  Drag force: {float(phase_scan.drag_kN[ci]):.1f} kN")
        log(f"  Inertia force: {float(phase_scan.inertia_kN[ci]):.1f} kN")
        log(f"  TOTAL MORISON: {float(phase_scan.total_kN[ci]):.1f} kN (MAX)")

    log("\n" + BAR)
    log("FEM STRUCTURAL ANALYSIS (All loads combined)")
    log(BAR)
    log("\n[APPLIED LOADS]")
    log(f"  Interface loads: axial {float(case.F_axial_kN)} kN, shear "
        f"{float(case.F_shear_kN)} kN, overturning "
        f"{float(case.M_moment_kNm)} kNm, torsion "
        f"{float(case.M_torsion_kNm)} kNm")
    log(f"  Morison loads: Total |F| = {np.linalg.norm(tm):.1f} kN")
    if case.sw_mode == "custom":
        log(f"  Self-weight (custom): {float(case.custom_sw_tonnes):.1f} t")
    elif case.sw_mode == "calculated":
        log("  Self-weight: calculated from member masses")
    else:
        log("  Self-weight: EXCLUDED")
    if getattr(case, "buoyancy", "none") != "none":
        log(f"  Buoyancy: still-water uplift, '{case.buoyancy}' members")
    if getattr(case, "slam_cs", 0.0):
        log(f"  Wave slamming: Cs = {float(case.slam_cs):.2f} "
            "(splash-zone impact, folded into drag)")
    if getattr(case, "wind_speed_ms", 0.0):
        extra = (f" + topside block {case.wind_topside_area_m2:.0f} m^2"
                 if getattr(case, "wind_topside_area_m2", 0.0) else "")
        log(f"  Wind: {float(case.wind_speed_ms):.1f} m/s @ 10 m "
            f"(API profile, member drag Cs = {case.wind_Cs}{extra}), "
            f"heading {float(case.wind_dir_deg):.0f} deg")

    log("\n[SUPPORT REACTIONS]")
    reac = _np(results.reactions) / 1000
    names = model.fixed_node_names()
    for n, R in zip(names, reac):
        log(f"  {n}: Rx={R[0]:8.1f}kN, Ry={R[1]:8.1f}kN, Rz={R[2]:8.1f}kN")
    tot = reac.sum(axis=0)
    log(f"  TOTAL: Rx={tot[0]:.1f}kN, Ry={tot[1]:.1f}kN, Rz={tot[2]:.1f}kN")

    log("\n[DISPLACEMENTS]")
    node = model.node_names[int(results.max_displacement_node)]
    log(f"  Maximum: {float(results.max_displacement_mm):.2f} mm "
        f"at node {node}")

    log("\n[STRESS CHECK]")
    log(f"  Yield Strength: fy = {float(case.fy)} MPa")
    rows = member_force_table(model, results)
    rows.sort(key=lambda r: r["utilization"], reverse=True)
    log("\n[CRITICAL MEMBERS - Top 10 by utilization]")
    log(f"  {'Member':<25} {'VM [MPa]':>10} {'Util':>10}")
    log(f"  {'-'*45}")
    for r in rows[:10]:
        log(f"  {r['member']:<25} {r['von_mises_max_MPa']:>10.1f} "
            f"{r['utilization']:>10.2%}")

    max_util = rows[0]["utilization"]
    if max_util > 1.0:
        log(f"\n  *** WARNING: Max utilization {max_util:.2%} EXCEEDS YIELD! ***")
    else:
        log(f"\n  Maximum utilization: {max_util:.2%} (< 100%, OK)")

    log("\n" + BAR)
    log("ANALYSIS COMPLETE")
    log(BAR)
    return "\n".join(L)


def render_code_checks(model: JacketModel, results, Fy: float | None = None,
                       joint_class: str = "auto",
                       top_n: int = 15) -> str:
    """API RP 2A-WSD member + joint unity-check report as a plain string
    (display-independent, so a front end and the tests share it)."""
    from ..ops.codecheck import member_code_check
    from ..ops.jointcheck import joint_code_check

    L = []
    log = L.append
    log(BAR)
    log("API RP 2A-WSD CODE CHECKS (working stress design)")
    log(BAR)

    chk = member_code_check(model, results, Fy=Fy)
    uc = _np(chk.uc)
    order = np.argsort(uc)[::-1][:top_n]
    log(f"\n[MEMBER STRENGTH - Top {min(top_n, uc.shape[0])} by unity check]")
    log(f"  {'Member':<25} {'UC':>6} {'governing':>12} {'KL/r':>6}")
    log(f"  {'-'*53}")
    for e in order:
        log(f"  {model.member_names[e]:<25} {uc[e]:>6.3f} "
            f"{chk.governing[e]:>12} {float(chk.KL_over_r[e]):>6.1f}")
    if uc.max() > 1.0:
        log(f"\n  *** WARNING: member UC {uc.max():.3f} > 1.0 ***")
    else:
        log(f"\n  All members pass (max UC {uc.max():.3f})")

    try:
        jchk = joint_code_check(model, results, Fy=Fy,
                                joint_class=joint_class)
    except ValueError as e:
        log(f"\n[JOINTS] skipped: {e}")
        log(BAR)
        return "\n".join(L)
    juc = _np(jchk.uc)
    order = np.argsort(juc)[::-1][:top_n]
    log(f"\n[SIMPLE JOINTS ({joint_class}) - Top "
        f"{min(top_n, juc.shape[0])} by unity check]")
    log(f"  {'Brace':<25} {'UC':>6} {'beta':>5} {'K/X/Y':>12}")
    log(f"  {'-'*51}")
    for j in order:
        frac = (f"{float(jchk.frac_K[j]):.1f}/{float(jchk.frac_X[j]):.1f}/"
                f"{float(jchk.frac_Y[j]):.1f}")
        log(f"  {model.member_names[int(jchk.brace[j])]:<25} {juc[j]:>6.3f} "
            f"{float(jchk.beta[j]):>5.2f} {frac:>12}")
    if juc.max() > 1.0:
        log(f"\n  *** WARNING: joint UC {juc.max():.3f} > 1.0 ***")
    else:
        log(f"\n  All joints pass (max UC {juc.max():.3f})")
    log(BAR)
    return "\n".join(L)
