"""Command-line interface of the PyTorch/CUDA port: the JAX package's
``small_fem_solver_tpu/cli.py`` with the same subcommands, flags, defaults
and printed text, on the port's library.

Every tab of the reference GUI maps to a flag or a JSON model file:

  geometry/members tabs  -> --model jacket.json (or the built-in default;
                            the JSON schema also carries appurtenances —
                            hydro-only risers/conductors with Cd/Cm factors —
                            and per-member end releases: "release":
                            "pinned"/"pinned1"/"pinned2" for pin-ended braces)
  material tab           -> --E --nu --fy --rho-steel --rho-water
                            --D-leg --t-leg --D-brace --t-brace
  wave tab               -> --H --T --d --Uc --wave-dir --current-dir
                            --wave-model --N --Cd --Cm
  loads tab              -> --F-axial --F-shear --M-moment --M-torsion
                            --self-weight {calculated,custom,none} --custom-sw
                            --buoyancy {none,sealed,flooded,legs-flooded}
  analysis tab           -> run --t / --phase-scan [--phase-steps]
  results tab            -> --csv out.csv --plot out.png (+ printed report)

Extra subcommands beyond the GUI: ``sweep`` (batched design envelope),
``refined`` (condensed large-mesh phase scan), ``envelope`` (multi-case
storm envelope), ``modes`` / ``dynamic`` (Craig-Bampton-reduced for
``--refine``), ``buckling``, ``pdelta`` (second-order amplification),
``optimize`` (differentiable sizing), ``fatigue`` (S-N / spectral screen),
``code-check`` (API RP 2A-WSD / ISO 19902 member checks), ``joint-check``
(punching shear), ``viv`` (vortex-shedding screen), ``pile`` (p-y/t-z/Q-z
foundation springs), ``seismic`` (response-spectrum earthquake check),
``transient`` (Newmark time integration, optional relative-velocity
drag), ``pushover`` (reserve strength ratio, optional directional rose),
``robustness`` (ALS member-removal screen), ``contour`` (N-year IFORM
environmental contours), ``reliability`` (direct FORM failure
probability under the climate), ``air-gap`` (crest clearance),
``save-default`` (write the default jacket JSON).

Every subcommand runs on the CUDA card, float64 unless ``--f32``; the
port-only flag ``--device`` names another device (``--device cpu`` runs
on the CPU; without a card and without it the CLI exits non-zero).  No
path moves work to the CPU behind the caller's back: float64 Cholesky,
LU and ``eigh`` run on the card.  Results come to the host through one
helper (``utils.io._np``) for printing.

Usage examples:
    python -m small_fem_solver_tpu_torch.cli run --phase-scan --csv forces.csv
    python -m small_fem_solver_tpu_torch.cli run --model my_jacket.json --H 12 --T 10
    python -m small_fem_solver_tpu_torch.cli sweep --H-range 4 18 8 --T 9.4
    python -m small_fem_solver_tpu_torch.cli refined --n-seg 32 --phase-steps 360
    python -m small_fem_solver_tpu_torch.cli run --phase-scan --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys

from .utils.io import _np


def _add_device_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the current CUDA "
                         "card; 'cpu' runs on the CPU)")


def _add_common(ap: argparse.ArgumentParser):
    g = ap.add_argument_group("geometry")
    g.add_argument("--model", help="jacket model JSON (default: built-in 3-leg jacket)")
    g.add_argument("--z-water-ref", type=float, default=47.0,
                   help="water-level datum shift for the default jacket")
    m = ap.add_argument_group("material & sections (GUI tab 3)")
    m.add_argument("--E", type=float, default=210000.0, help="Young's modulus [MPa]")
    m.add_argument("--nu", type=float, default=0.3, help="Poisson ratio")
    m.add_argument("--fy", type=float, default=355.0, help="yield strength [MPa]")
    m.add_argument("--rho-steel", type=float, default=7850.0, help="[kg/m^3]")
    m.add_argument("--rho-water", type=float, default=1025.0, help="[kg/m^3]")
    m.add_argument("--D-leg", type=float, default=2000.0, help="leg OD [mm]")
    m.add_argument("--t-leg", type=float, default=75.0, help="leg wall [mm]")
    m.add_argument("--D-brace", type=float, default=800.0, help="brace OD [mm]")
    m.add_argument("--t-brace", type=float, default=30.0, help="brace wall [mm]")
    w = ap.add_argument_group("wave (GUI tab 4)")
    w.add_argument("--H", type=float, default=17.038, help="wave height [m]")
    w.add_argument("--T", type=float, default=9.4, help="period [s]")
    w.add_argument("--d", type=float, default=50.0, help="water depth [m]")
    w.add_argument("--Uc", type=float, default=1.7, help="current speed [m/s]")
    w.add_argument("--wave-dir", type=float, default=38.0,
                   help="wave direction [deg from North, clockwise]")
    w.add_argument("--current-dir", type=float, default=38.0)
    w.add_argument("--wave-model", default="auto",
                   choices=["auto", "airy", "stokes", "fenton"])
    w.add_argument("--N", type=int, default=10, help="wave order / modes")
    w.add_argument("--doppler", action="store_true",
                   help="wave-current interaction: build the wave with the "
                        "APPARENT period (API RP 2A Doppler correction from "
                        "the along-wave current component)")
    w.add_argument("--Cd", type=float, default=0.7, help="drag coefficient")
    w.add_argument("--Cm", type=float, default=2.0, help="inertia coefficient")

    def _nonneg(v):
        v = float(v)
        if v < 0:
            raise argparse.ArgumentTypeError(
                "marine growth thickness must be >= 0 mm")
        return v

    w.add_argument("--marine-growth", type=_nonneg, default=0.0,
                   help="radial marine-growth thickness [mm]; adds 2t to "
                        "the hydrodynamic diameter only (API RP 2A)")
    l = ap.add_argument_group("loads (GUI tab 5)")
    l.add_argument("--F-axial", type=float, default=25100.0, help="[kN]")
    l.add_argument("--F-shear", type=float, default=2900.0, help="[kN]")
    l.add_argument("--M-moment", type=float, default=0.0, help="[kNm]")
    l.add_argument("--M-torsion", type=float, default=0.0, help="[kNm]")
    l.add_argument("--self-weight", default="custom",
                   choices=["calculated", "custom", "none"])
    l.add_argument("--custom-sw", type=float, default=1100.0, help="[tonnes]")
    l.add_argument("--slam-cs", type=float, default=0.0,
                   help="wave-slamming coefficient Cs (0 = off; pi per API "
                        "RP 2A commentary, 5.15 per DNV-RP-C205). "
                        "Quasi-static splash-zone slam; pointwise "
                        "kinematics paths only")
    l.add_argument("--wind-speed", type=float, default=0.0,
                   help="1-hour mean wind speed at 10 m [m/s] (0 = off): "
                        "API power-law member drag above still water + "
                        "optional topside block (--wind-area)")
    l.add_argument("--wind-dir", type=float, default=None,
                   help="wind heading [deg from North, clockwise]; "
                        "default = wave direction")
    l.add_argument("--wind-Cs", type=float, default=0.5,
                   help="member shape coefficient (API: 0.5 cylinders)")
    l.add_argument("--wind-area", type=float, default=0.0,
                   help="topside projected wind area [m^2]")
    l.add_argument("--wind-topside-Cs", type=float, default=1.0,
                   help="topside block shape coefficient")
    l.add_argument("--buoyancy", default="none",
                   choices=["none", "sealed", "flooded", "legs-flooded"],
                   help="still-water buoyant uplift on submerged members: "
                        "sealed = full displaced volume, flooded = steel "
                        "annulus only, legs-flooded = flooded legs + sealed "
                        "braces (beyond the reference; default off)")
    s = ap.add_argument_group("solver")
    s.add_argument("--solver", default="chol", choices=["chol", "lu", "pcg"])
    s.add_argument("--pcg-precond", default="auto",
                   choices=["auto", "block_jacobi", "two_level"],
                   help="PCG preconditioner (--solver pcg only; two_level = "
                        "smoothed rigid-body-aggregation coarse space)")
    s.add_argument("--pcg-tol", type=float, default=1e-10,
                   help="PCG relative-residual tolerance")
    s.add_argument("--pcg-chunk", type=int, default=0,
                   help="CG iterations between the host's reads of the "
                        "converged flag (0 = the solver's default); the "
                        "iterates do not depend on it")
    s.add_argument("--f32", action="store_true",
                   help="float32 fast mode (default float64)")
    s.add_argument("--accel", default="fd", choices=["fd", "analytic"],
                   help="wave acceleration: reference finite-difference or analytic")
    _add_device_arg(s)
    o = ap.add_argument_group("outputs")
    o.add_argument("--csv", help="export member force table CSV")
    o.add_argument("--json-out", help="dump full results JSON")
    o.add_argument("--plot", help="save 3D utilization plot PNG")
    o.add_argument("--save-model", help="write the (possibly default) model JSON")
    o.add_argument("--save-results",
                   help="persist the full result NamedTuple as .npz "
                        "(reload with load_results)")


def _add_spring_arg(ap: argparse.ArgumentParser):
    ap.add_argument("--support-spring", nargs=6, type=float,
                    metavar=("KX", "KY", "KZ", "KRX", "KRY", "KRZ"),
                    help="foundation springs at the support nodes "
                         "(N/mm translations, N*mm/rad rotations) "
                         "instead of rigid clamps")


def _spring_banner(spring):
    if spring:
        print("[foundation] supports on 6-DOF springs "
              f"k = {spring} (N/mm, N*mm/rad)")


def _scf_banner(scf):
    """Make the fatigue grade unmissable: the screens take user SCF values
    but NO parametric (Efthymiou) joint SCF equations are implemented.
    Without joint-classified SCFs the damages rank members; they are not
    code-grade hot-spot lives."""
    import numpy as np
    u = np.unique(np.atleast_1d(np.asarray(scf, dtype=np.float64)))
    kind = (f"uniform SCF {u[0]:g}" if u.size == 1
            else f"user per-member SCFs in [{u.min():g}, {u.max():g}]")
    print(f"[fatigue] SCREENING-GRADE results: {kind}; parametric "
          f"(Efthymiou) joint SCFs are NOT implemented — damages rank "
          f"members but are not code-grade hot-spot lives. For design "
          f"verification supply joint-classified SCFs via --scf / the "
          f"scf= API argument.")


def _resolve_device(name):
    """The run's torch device: ``--device``, else the current CUDA card;
    without a card and without ``--device`` the CLI exits."""
    import torch

    from .device import resolve_device
    if name is None and not torch.cuda.is_available():
        raise SystemExit("small_fem_solver_tpu_torch runs on the CUDA card "
                         "by default and found none; pass --device cpu to "
                         "run on the CPU")
    return resolve_device(name)


def _dtype(args):
    import torch
    return torch.float32 if args.f32 else torch.float64


def _setup(args):
    from . import LoadCase, default_3leg_jacket

    dtype, dev = _dtype(args), args.device
    if args.model:
        import dataclasses

        from .ops.sections import tube_sections
        from .utils.io import load_model
        model, _ = load_model(args.model, dtype=dtype, device=dev)
        # explicit section/material flags override the stored sections
        defaults = {"D_leg": 2000.0, "t_leg": 75.0, "D_brace": 800.0,
                    "t_brace": 30.0, "rho_steel": 7850.0}
        if any(getattr(args, k) != v for k, v in defaults.items()):
            model = dataclasses.replace(model, sections=tube_sections(
                [args.D_leg, args.D_brace], [args.t_leg, args.t_brace],
                args.rho_steel, dtype=dtype, device=dev))
            print("[model] CLI section flags override the JSON sections",
                  file=sys.stderr)
    else:
        model = default_3leg_jacket(
            z_water_ref=args.z_water_ref, dtype=dtype, device=dev,
            leg_section=(args.D_leg, args.t_leg),
            brace_section=(args.D_brace, args.t_brace),
            rho_steel=args.rho_steel)

    from .ops.sections import validate_sections
    from .ops.wave_models import make_wave, validate_wave
    T_wave = args.T
    if getattr(args, "doppler", False) and args.Uc:
        import numpy as np

        from .ops.dispersion import apparent_period
        beta = np.deg2rad(args.wave_dir - args.current_dir)
        U_along = args.Uc * float(np.cos(beta))
        T_wave = float(apparent_period(args.T, args.d, U_along))
        print(f"[doppler] apparent period {T_wave:.3f} s (absolute "
              f"{args.T:g} s, along-wave current {U_along:+.2f} m/s)",
              file=sys.stderr)
    for msg in validate_wave(args.H, T_wave, args.d):
        print(f"WARNING: {msg}", file=sys.stderr)
    for msg in validate_sections(model.sections):
        print(f"WARNING: {msg}", file=sys.stderr)
    wave = make_wave(args.H, T_wave, args.d, args.Uc, model=args.wave_model,
                     N=args.N, dtype=dtype, device=dev)

    case = LoadCase(
        E=args.E, nu=args.nu, fy=args.fy, rho_water=args.rho_water,
        wave_dir_deg=args.wave_dir, current_dir_deg=args.current_dir,
        Cd=args.Cd, Cm=args.Cm,
        F_axial_kN=args.F_axial, F_shear_kN=args.F_shear,
        M_moment_kNm=args.M_moment, M_torsion_kNm=args.M_torsion,
        custom_sw_tonnes=args.custom_sw, sw_mode=args.self_weight,
        buoyancy=getattr(args, "buoyancy", "none"),
        slam_cs=getattr(args, "slam_cs", 0.0),
        wind_speed_ms=getattr(args, "wind_speed", 0.0),
        wind_dir_deg=(args.wind_dir if getattr(args, "wind_dir", None)
                      is not None else args.wave_dir),
        wind_Cs=getattr(args, "wind_Cs", 0.5),
        wind_topside_area_m2=getattr(args, "wind_area", 0.0),
        wind_topside_Cs=getattr(args, "wind_topside_Cs", 1.0),
        marine_growth_mm=args.marine_growth,
    )
    return model, wave, case


def cmd_run(args):
    import dataclasses

    from . import analyze, analyze_condensed, analyze_ssi, refine_model
    from .ops.morison import hydro_members
    from .ops.morison import phase_scan as mor_phase_scan
    from .utils.report import render_report

    model, wave, case = _setup(args)
    case = dataclasses.replace(case, t_analysis=args.t)

    scan = None
    if args.phase_scan:
        conn_h, D_m, Cd_h, Cm_h = hydro_members(model, case.marine_growth_mm,
                                                case.Cd, case.Cm)
        scan = mor_phase_scan(wave, model.coords, conn_h, D_m,
                              case.wave_dir_deg, case.current_dir_deg,
                              Cd_h, Cm_h, case.rho_water,
                              n_steps=args.phase_steps, accel=args.accel,
                              slam_cs=case.slam_cs)

    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    rmodel = model
    if getattr(args, "refine", 1) > 1:
        if args.f32 and args.refine > 32:
            raise SystemExit(
                "--f32 with --refine > 32 is numerically invalid: the "
                "float32 chain factorization error grows ~n_seg^4 (O(1) by "
                "n_seg ~ 300; see docs/ARCHITECTURE.md section 4). Drop "
                "--f32 for deep refinements (the card runs float64 "
                "natively).")
        rmodel = refine_model(model, args.refine)
        print(f"[refined] {rmodel.n_dof} DOF via exact chain condensation")
        res = analyze_condensed(model, rmodel, args.refine, wave, case,
                                accel=args.accel, solve_dtype=_dtype(args),
                                support_stiffness=spring)
    elif spring:
        if args.solver != "chol":
            print(f"[foundation] note: --solver {args.solver} ignored — "
                  "the spring path uses the dense Cholesky solver",
                  file=sys.stderr)
        res = analyze_ssi(model, wave, case, spring, accel=args.accel)
    else:
        res = analyze(model, wave, case, solver=args.solver,
                      accel=args.accel, pcg_precond=args.pcg_precond,
                      pcg_tol=args.pcg_tol, pcg_chunk=args.pcg_chunk)
    print(render_report(rmodel, wave, case, res, phase_scan=scan))
    _outputs(args, rmodel, res)


def _outputs(args, model, res):
    if getattr(args, "save_results", None):
        from .utils.persist import save_results
        save_results(args.save_results, res)
        print(f"wrote {args.save_results}", file=sys.stderr)
    if args.csv:
        from .utils.io import export_csv
        export_csv(args.csv, model, res)
        print(f"wrote {args.csv}", file=sys.stderr)
    if args.json_out:
        from .utils.io import member_force_table
        out = {
            "member_forces": member_force_table(model, res),
            "reactions": {n: list(map(float, r)) for n, r in
                          zip(model.fixed_node_names(),
                              _np(res.reactions))},
            "max_displacement_mm": float(res.max_displacement_mm),
        }
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json_out}", file=sys.stderr)
    if args.plot:
        from .utils.plotting import plot_utilization
        plot_utilization(model, res, args.plot)
        print(f"wrote {args.plot}", file=sys.stderr)
    if args.save_model:
        from .utils.io import save_model
        save_model(args.save_model, model)
        print(f"wrote {args.save_model}", file=sys.stderr)


def cmd_sweep(args):
    import numpy as np

    from .parallel.sweep import (critical_case, design_sweep, make_case_batch,
                                 make_wave_batch)

    model, _, case = _setup(args)
    lo, hi, n = args.H_range
    Hs = np.linspace(lo, hi, int(n))
    dirs = np.asarray(args.dirs if args.dirs else [args.wave_dir])
    HH, DD = np.meshgrid(Hs, dirs, indexing="ij")
    B = HH.size
    wave_model = args.wave_model
    if wave_model == "auto":
        wave_model = "stokes"
        print("[sweep] note: case batches use one wave model for all cases; "
              "'auto' resolves to Stokes-5 here — pass --wave-model fenton "
              "for steep-wave sweeps", file=sys.stderr)
    waves = make_wave_batch(HH.ravel(), args.T, args.d, args.Uc,
                            model=wave_model,
                            N=(min(args.N, 5) if wave_model == "stokes"
                               else max(args.N, 10)),
                            n_modes=max(args.N, 8), dtype=_dtype(args),
                            device=args.device)
    cases = make_case_batch(case, wave_dir_deg=DD.ravel(),
                            current_dir_deg=DD.ravel(),
                            t_analysis=np.zeros(B))
    res = design_sweep(model, waves, cases, solver="chol", accel=args.accel)
    crit = critical_case(res)
    util = _np(res.utilization).max(axis=1).reshape(HH.shape)
    print(f"[sweep] {B} cases: H in [{lo}, {hi}] x {len(dirs)} heading(s)")
    for i, H in enumerate(Hs):
        row = " ".join(f"{u:7.4f}" for u in util[i])
        print(f"  H={H:6.2f} m  util: {row}")
    ci = int(crit["index"])
    print(f"governing case: H={HH.ravel()[ci]:.2f} m, dir={DD.ravel()[ci]:.0f} deg, "
          f"max utilization {float(crit['max_utilization']):.4f}")


def cmd_refined(args):
    import numpy as np

    from . import api, refine_model

    model, wave, case = _setup(args)
    refined = refine_model(model, args.n_seg)
    print(f"[refined] {refined.n_nodes} nodes / {refined.n_members} elements "
          f"/ {refined.n_dof} DOF; {args.phase_steps} phases", file=sys.stderr)
    scan = api.phase_scan_condensed(
        model, refined, args.n_seg, wave, case, n_steps=args.phase_steps,
        accel=args.accel, solve_dtype=_dtype(args))
    ci = int(scan.critical_index)
    print(f"critical phase: t={float(scan.ts[ci]):.3f}s  "
          f"max utilization={float(scan.utilization[ci].max()):.4f}")
    worst = _np(scan.utilization[ci])
    order = np.argsort(worst)[::-1][:10]
    print(f"  {'Element':<30} {'Util':>8}")
    for e in order:
        print(f"  {refined.member_names[e]:<30} {worst[e]:>8.2%}")


def cmd_envelope(args):
    """Refined-mesh storm envelope: cases x phases, condensed solver."""
    import numpy as np

    from . import api, refine_model
    from .parallel.sweep import make_case_batch, make_wave_batch

    model, _, case = _setup(args)
    lo, hi, n = args.H_range
    Hs = np.linspace(lo, hi, int(n))
    Ts = np.asarray(args.Ts if args.Ts else [args.T])
    dirs = np.asarray(args.dirs if args.dirs else [args.wave_dir])
    HH, TT, DD = (a.ravel() for a in np.meshgrid(Hs, Ts, dirs, indexing="ij"))
    B = HH.size
    dtype = _dtype(args)
    wave_model = "stokes" if args.wave_model == "auto" else args.wave_model
    if args.wave_model == "auto":
        print("[envelope] note: 'auto' resolves to Stokes-5 for case "
              "batches — pass --wave-model fenton for steep-wave envelopes",
              file=sys.stderr)
    waves = make_wave_batch(HH, TT, args.d, args.Uc, model=wave_model,
                            N=(min(args.N, 5) if wave_model == "stokes"
                               else max(args.N, 10)),
                            n_modes=max(args.N, 8), dtype=dtype,
                            device=args.device)
    cases = make_case_batch(case, wave_dir_deg=DD, current_dir_deg=DD,
                            t_analysis=np.zeros(B))
    refined = refine_model(model, args.n_seg)
    print(f"[envelope] {B} cases x {args.phase_steps} phases @ "
          f"{refined.n_dof} DOF", file=sys.stderr)
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    env = api.design_envelope_condensed(
        model, refined, args.n_seg, waves, cases, n_steps=args.phase_steps,
        solve_dtype=dtype, support_stiffness=spring)
    g = int(env.governing_case)
    print(f"governing case: H={HH[g]:.2f} m, T={TT[g]:.2f} s, "
          f"dir={DD[g]:.0f} deg -> max utilization "
          f"{float(env.max_util_per_case[g]):.4f} at phase index "
          f"{int(env.critical_phase[g])}")
    worst = _np(env.member_envelope)
    order = np.argsort(worst)[::-1][:10]
    print(f"  {'Element (envelope)':<30} {'Util':>8}")
    for e in order:
        print(f"  {refined.member_names[e]:<30} {worst[e]:>8.2%}")


def cmd_optimize(args):
    """Gradient-based section sizing (differentiable design)."""
    from . import optimize_sections, section_sensitivities

    model, wave, case = _setup(args)
    s = section_sensitivities(model, wave, case)
    print("sensitivities at the current design "
          "(d/d(D_leg, t_leg, D_brace, t_brace), per mm):")
    print(f"  max utilization: {_np(s.dutil)}")
    print(f"  mass [t]:        {_np(s.dmass_t)}")
    print(f"  starting: util {float(s.util_max):.3f}, "
          f"mass {float(s.mass_t):.0f} t")
    opt = optimize_sections(model, wave, case, target_util=args.target_util,
                            n_iter=args.n_iter)
    print(f"optimized wall thicknesses (target util "
          f"{args.target_util:.0%}, {args.n_iter} differentiated analyses):")
    print(f"  t_leg   {float(model.sections.t[0]):.1f} -> "
          f"{float(opt.t_leg):.1f} mm")
    print(f"  t_brace {float(model.sections.t[1]):.1f} -> "
          f"{float(opt.t_brace):.1f} mm")
    print(f"  utilization {float(opt.util_max):.3f}, "
          f"mass {float(opt.mass_t):.0f} t "
          f"({1 - float(opt.mass_t)/float(s.mass_t):.0%} saved)")


def cmd_fatigue(args):
    """Fatigue screen: deterministic (one regular-wave cycle per period) or
    spectral (--spectrum: JONSWAP/PM random-sea realization, narrow-band
    Rayleigh + rainflow damage)."""
    import numpy as np

    from . import api, refine_model
    from .ops.fatigue import fatigue_screen

    _scf_banner(args.scf)
    model, wave, case = _setup(args)
    refined = refine_model(model, args.refine) if args.refine > 1 else model

    if args.scatter:
        import pathlib
        states = json.loads(pathlib.Path(args.scatter).read_text()) \
            if pathlib.Path(args.scatter).exists() \
            else json.loads(args.scatter)
        n_seg = max(args.refine, 2)
        refined_s = refine_model(model, n_seg)
        prep = api.prepare_condensed(model, refined_s, n_seg, E=case.E,
                                     nu=case.nu)
        if args.freq_domain:
            res = api.scatter_fatigue_spectral(
                prep, case, states, d=args.d,
                exposure_years=args.years, curve=args.curve,
                scf=args.scf, n_components=args.components,
                seed=args.seed, U_c=args.Uc,
                spectrum=args.spectrum or "jonswap",
                dynamic=args.dynamic, damping_ratio=args.damping,
                n_chain_modes=args.chain_modes,
                hydro_damping=args.hydro_damping)
            d_a = _np(res.damage_wl)
            d_b = _np(res.damage_nb)
            life = _np(res.life_years_wl)
            col_a, col_b = "D W-L", "D n-band"
            kind = ("frequency-domain "
                    + ("DYNAMIC (CB)" if args.dynamic else "quasi-static"))
        else:
            res = api.scatter_fatigue(
                prep, case, states, d=args.d,
                exposure_years=args.years, curve=args.curve,
                scf=args.scf, n_components=args.components,
                n_steps=args.sea_steps, seed=args.seed, U_c=args.Uc,
                spectrum=args.spectrum or "jonswap",
                stretching=args.stretching)
            d_a = _np(res.damage_rainflow)
            d_b = _np(res.damage_rayleigh)
            life = _np(res.life_years_rainflow)
            col_a, col_b = "D rainflow", "D rayleigh"
            kind = "time-domain"
        order = np.argsort(d_a)[::-1][:10]
        occ = sum(r[2] for r in res.states)
        print(f"scatter-diagram fatigue ({kind}): {len(res.states)} sea "
              f"states ({occ:.0%} of the {args.years:.0f} y exposure), "
              f"curve {args.curve}, SCF {args.scf}")
        for r in res.states:
            line = f"  state Hs={r[0]} m Tp={r[1]} s occurrence={r[2]:.0%}"
            if len(r) == 4:
                line += f" heading={r[3]:.0f} deg"
            print(line)
        print(f"  {'Member':<24} {col_a:>11} {col_b:>11} {'Life [y]':>9}")
        names = refined_s.member_names
        for e in order:
            lf = f"{life[e]:.0f}" if np.isfinite(life[e]) else "inf"
            print(f"  {names[e]:<24} {d_a[e]:>11.3e} {d_b[e]:>11.3e} "
                  f"{lf:>9}")
        if max(d_a.max(), d_b.max()) > 1.0:
            print("  WARNING: Miner damage > 1 — fatigue life shorter than "
                  "the exposure!")
        if getattr(args, "save_results", None):
            from .utils.persist import save_results
            save_results(args.save_results, res)
            print(f"wrote {args.save_results}", file=sys.stderr)
        if args.freq_domain and args.return_years:
            ry = tuple(float(v) for v in args.return_years.split(","))
            lt = api.long_term_extremes(res, return_years=ry,
                                        fy=float(case.fy))
            u_lt, s_lt = _np(lt.utilization), _np(lt.stress_mpa)
            g_lt = _np(lt.governing_state)
            print("long-term extreme response (all-states upcrossing "
                  "integral):")
            for r_i, y in enumerate(ry):
                u = u_lt[r_i]
                e = int(np.argmax(u))
                st = res.states[int(g_lt[r_i][e])]
                print(f"  {y:.0f}-year: max utilization {u[e]:.3f} at "
                      f"{names[e]} (stress {s_lt[r_i][e]:.1f} "
                      f"MPa; governing state Hs={st[0]} m Tp={st[1]} s)")
                if u[e] > 1.0:
                    print(f"  WARNING: {y:.0f}-year extreme exceeds yield!")
        return

    if args.spectrum:
        from .ops.spectrum import make_random_sea, spectral_fatigue_screen
        hs = args.hs if args.hs is not None else args.H
        tp = args.tp if args.tp is not None else args.T
        sea = make_random_sea(hs, tp, args.d, n_components=args.components,
                              seed=args.seed, spectrum=args.spectrum,
                              U_c=args.Uc, spreading_s=args.spreading_s,
                              dtype=_dtype(args), device=args.device)
        dt = tp / 10.0
        ts = np.arange(args.sea_steps) * dt
        if args.refine > 1:
            prep = api.prepare_condensed(model, refined, args.refine,
                                         E=case.E, nu=case.nu)
            scan = api.sea_scan_prepared(prep, sea, case, ts,
                                         stretching=args.stretching)
        else:
            scan = api.sea_response_batch(model, sea, case, ts,
                                          stretching=args.stretching)
        scr = spectral_fatigue_screen(_np(scan.von_mises), dt,
                                      exposure_years=args.years,
                                      curve=args.curve, scf=args.scf,
                                      occurrence=args.occurrence)
        d_rf = _np(scr.damage_rainflow)
        d_nb = _np(scr.damage_rayleigh)
        life = _np(scr.life_years_rainflow)
        order = np.argsort(d_nb)[::-1][:10]
        print(f"spectral fatigue screen: {args.spectrum.upper()} Hs={hs} m "
              f"Tp={tp} s, {args.components} components, "
              f"{args.sea_steps} samples @ dt={dt:.2f} s, curve "
              f"{args.curve}, SCF {args.scf}, {args.years:.0f} y x "
              f"{args.occurrence:.0%}")
        print(f"  {'Member':<24} {'sigma':>7} {'nu0 Hz':>7} "
              f"{'D rayleigh':>11} {'D rainflow':>11} {'Life [y]':>9}")
        names = refined.member_names
        sig = _np(scr.sigma_mpa)
        nu0 = _np(scr.nu0_hz)
        for e in order:
            lf = f"{life[e]:.0f}" if np.isfinite(life[e]) else "inf"
            print(f"  {names[e]:<24} {sig[e]:>7.1f} {nu0[e]:>7.3f} "
                  f"{d_nb[e]:>11.3e} {d_rf[e]:>11.3e} {lf:>9}")
        if max(d_nb.max(), d_rf.max()) > 1.0:
            print("  WARNING: Miner damage > 1 — fatigue life shorter than "
                  "the exposure!")
        return

    if args.refine > 1:
        scan = api.phase_scan_condensed(model, refined, args.refine, wave,
                                        case, n_steps=args.phase_steps)
        vm = scan.von_mises
    else:
        _, batch = api.analyze_phase_batch(model, wave, case,
                                           n_steps=args.phase_steps)
        vm = batch.von_mises
    scr = fatigue_screen(vm, T_wave=args.T, exposure_years=args.years,
                         curve=args.curve, scf=args.scf,
                         occurrence=args.occurrence)
    dmg = _np(scr.damage)
    life = _np(scr.life_years)
    order = np.argsort(dmg)[::-1][:10]
    print(f"fatigue screen: curve {args.curve}, SCF {args.scf}, "
          f"{args.years:.0f} y exposure x {args.occurrence:.0%} occurrence "
          f"({scr.n_cycles:.2e} cycles)")
    print(f"  {'Member':<24} {'dS [MPa]':>9} {'Damage':>10} {'Life [y]':>10}")
    names = refined.member_names
    S = _np(scr.stress_range_mpa)
    for e in order:
        lf = f"{life[e]:.1f}" if np.isfinite(life[e]) else "inf"
        print(f"  {names[e]:<24} {S[e]:>9.1f} {dmg[e]:>10.3e} {lf:>10}")
    if dmg.max() > 1.0:
        print("  WARNING: Miner damage > 1 — fatigue life shorter than "
              "the exposure!")


def cmd_spectral(args):
    """Frequency-domain stochastic response: Borgman-linearized transfer
    solves -> stress std devs, closed-form fatigue, MPM storm extremes."""
    import numpy as np

    from . import api, refine_model
    from .ops.spectrum import make_random_sea

    _scf_banner(args.scf)
    hs = args.hs if args.hs is not None else args.H
    tp = args.tp if args.tp is not None else args.T
    model, _wave, case = _setup(args)
    sea = make_random_sea(hs, tp, args.d, n_components=args.components,
                          seed=args.seed, spectrum=args.spectrum,
                          U_c=args.Uc, spreading_s=args.spreading_s,
                          dtype=_dtype(args), device=args.device)
    n_seg = max(args.refine, 2)
    refined = refine_model(model, n_seg)
    if args.dynamic:
        res = api.spectral_response_dynamic(
            model, refined, n_seg, sea, case,
            damping_ratio=args.damping,
            hydro_damping=args.hydro_damping,
            T_storm_s=args.storm_hours * 3600.0,
            exposure_years=args.years, curve=args.curve, scf=args.scf,
            occurrence=args.occurrence,
            n_chain_modes=args.chain_modes)
    else:
        prep = api.prepare_condensed(model, refined, n_seg, E=case.E,
                                     nu=case.nu)
        res = api.spectral_response_prepared(
            prep, sea, case, T_storm_s=args.storm_hours * 3600.0,
            exposure_years=args.years, curve=args.curve, scf=args.scf,
            occurrence=args.occurrence)
    sig = _np(res.sigma_stress)
    order = np.argsort(sig)[::-1][:10]
    names = refined.member_names
    kind = (f"dynamic CB transfer, zeta={args.damping}" if args.dynamic
            else "quasi-static")
    print(f"frequency-domain response: {args.spectrum.upper()} Hs={hs} m "
          f"Tp={tp} s, {args.components} components, {kind} "
          f"(Borgman-linearized drag; sigma_v max "
          f"{float(res.sigma_v_max):.2f} m/s)")
    print(f"  base shear: mean {float(res.mean_base_shear_N)/1e3:.0f} kN, "
          f"sigma {float(res.sigma_base_shear_N)/1e3:.0f} kN")
    print(f"  overturning moment: mean "
          f"{float(res.mean_otm_Nm)/1e6:.1f} MN m, sigma "
          f"{float(res.sigma_otm_Nm)/1e6:.1f} MN m, "
          f"{args.storm_hours:.0f}-h MPM {float(res.mpm_otm_Nm)/1e6:.1f} "
          f"MN m")
    print(f"  displacement: sigma {float(res.sigma_disp_mm):.1f} mm, "
          f"{args.storm_hours:.0f}-h MPM {float(res.mpm_disp_mm):.1f} mm")
    print(f"  {'Member':<24} {'sigma':>7} {'nu0 Hz':>7} {'alpha2':>6} "
          f"{'MPM util':>8} {'D n-band':>10} {'D W-L':>10} {'Life [y]':>9}")
    nu0 = _np(res.nu0_hz)
    a2 = _np(res.bandwidth_alpha2)
    mu = _np(res.mpm_utilization)
    dnb = _np(res.damage_nb)
    dwl = _np(res.damage_wl)
    life = _np(res.life_years_wl)
    for e in order:
        lf = f"{life[e]:.0f}" if np.isfinite(life[e]) else "inf"
        print(f"  {names[e]:<24} {sig[e]:>7.1f} {nu0[e]:>7.3f} "
              f"{a2[e]:>6.2f} {mu[e]:>8.3f} {dnb[e]:>10.3e} "
              f"{dwl[e]:>10.3e} {lf:>9}")
    if dnb.max() > 1.0:
        print("  WARNING: Miner damage > 1 — fatigue life shorter than "
              "the exposure!")
    if mu.max() > 1.0:
        print("  WARNING: MPM utilization > 1 — extreme-response yield "
              "check fails!")
    if getattr(args, "save_results", None):
        from .utils.persist import save_results
        save_results(args.save_results, res)
        print(f"wrote {args.save_results}", file=sys.stderr)


def cmd_buckling(args):
    """Member Euler screen + linearized global buckling factors."""
    import numpy as np

    from . import (analyze, analyze_condensed, analyze_ssi,
                   buckling_analysis, buckling_analysis_condensed,
                   euler_member_screen, refine_model)

    spring = getattr(args, "support_spring", None)
    model, wave, case = _setup(args)
    _spring_banner(spring)
    if args.refine > 1:
        refined = refine_model(model, args.refine)
        print(f"Craig-Bampton reduced buckling: {refined.n_dof} DOF, "
              f"{args.chain_modes} retained modes/chain")
        res = analyze_condensed(model, refined, args.refine, wave, case,
                                support_stiffness=spring)
        b = buckling_analysis_condensed(
            model, refined, args.refine, res, E=args.E, nu=args.nu,
            n_modes=args.n_modes, n_chain_modes=args.chain_modes,
            support_stiffness=spring)
        scr = euler_member_screen(refined, res, E=args.E,
                                  k_factor=args.k_factor, n_seg=args.refine)
        # screen rows are per PHYSICAL member; keep coarse names
    else:
        if spring:
            res = analyze_ssi(model, wave, case, spring)
        else:
            res = analyze(model, wave, case, solver="chol")
        b = buckling_analysis(model, res, E=args.E, nu=args.nu,
                              n_modes=args.n_modes, support_stiffness=spring)
        scr = euler_member_screen(model, res, E=args.E,
                                  k_factor=args.k_factor)
    lam = _np(b.load_factor)
    print("linearized global buckling load factors (on this load case):")
    for i, l in enumerate(lam):
        print(f"  mode {i+1}: lambda_cr = {l:.2f}")
    if lam[0] < 1.0:
        print("  WARNING: lambda_cr < 1 — elastic buckling below the "
              "applied load!")
    util = _np(scr.utilization)
    N = _np(scr.axial_N) / 1e3
    P = _np(scr.P_euler_N) / 1e3
    order = np.argsort(util)[::-1][:10]
    print(f"member Euler screen (K = {args.k_factor}):")
    print(f"  {'Member':<22} {'N [kN]':>10} {'P_cr [kN]':>12} {'Util':>8}")
    for e in order:
        print(f"  {model.member_names[e]:<22} {N[e]:>10.0f} "
              f"{P[e]:>12.0f} {util[e]:>8.2%}")


def cmd_pdelta(args):
    """Second-order (P-delta) analysis vs first-order, side by side."""
    import numpy as np

    from . import (analyze, analyze_condensed, analyze_pdelta,
                   analyze_pdelta_condensed, analyze_ssi, refine_model)

    spring = getattr(args, "support_spring", None)
    model, wave, case = _setup(args)
    _spring_banner(spring)
    if args.refine > 1:
        refined = refine_model(model, args.refine)
        print(f"condensed P-delta: {refined.n_dof} DOF (chain solver)")
        lin = analyze_condensed(model, refined, args.refine, wave, case,
                                support_stiffness=spring)
        pd = analyze_pdelta_condensed(
            model, refined, args.refine, wave, case,
            n_iter=args.n_iter, support_stiffness=spring)
        model = refined   # the member table below is per refined element
    elif spring:
        lin = analyze_ssi(model, wave, case, spring, accel=args.accel)
        pd = analyze_pdelta(model, wave, case, n_iter=args.n_iter,
                            accel=args.accel, support_stiffness=spring)
    else:
        lin = analyze(model, wave, case, solver="chol", accel=args.accel)
        pd = analyze_pdelta(model, wave, case, n_iter=args.n_iter,
                            accel=args.accel, support_stiffness=spring)
    amp = float(pd.pdelta_amplification)
    u_lin, u_pd = _np(lin.utilization), _np(pd.utilization)
    print(f"P-delta amplification (max nodal |U2|/|U1|): {amp:.4f}")
    print(f"  max displacement: {float(lin.max_displacement_mm):.2f} mm "
          f"(1st order) -> {float(pd.max_displacement_mm):.2f} mm "
          f"(2nd order)")
    print(f"  max utilization:  {float(u_lin.max()):.4f} "
          f"-> {float(u_pd.max()):.4f}")
    if not np.isfinite(amp):
        print("  WARNING: no second-order equilibrium — the load case "
              "exceeds the elastic buckling load (run the 'buckling' "
              "command)")
    du = np.abs(u_pd - u_lin)
    order = np.argsort(du)[::-1][:8]
    print("  largest utilization changes:")
    for e in order:
        print(f"    {model.member_names[e]:<22} "
              f"{float(u_lin[e]):.4f} -> "
              f"{float(u_pd[e]):.4f}")
    _outputs(args, model, pd)


def cmd_modes(args):
    """Natural frequencies (modal analysis) — beyond the reference's scope."""
    from . import refine_model
    from .ops.dynamics import modal_analysis, modal_analysis_condensed

    model, _, case = _setup(args)
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    if getattr(args, "refine", 1) > 1:
        refined = refine_model(model, args.refine)
        print(f"Craig-Bampton reduced modal analysis: "
              f"{refined.n_dof} DOF -> "
              f"{model.n_dof + model.n_members * args.chain_modes} "
              f"reduced DOF")
        res = modal_analysis_condensed(
            model, refined, args.refine, n_modes=args.n_modes,
            E=args.E, nu=args.nu, topside_mass_t=args.topside_mass,
            n_chain_modes=args.chain_modes, support_stiffness=spring,
            added_mass_Ca=args.added_mass, rho_water=args.rho_water)
    else:
        res = modal_analysis(model, n_modes=args.n_modes, E=args.E,
                             nu=args.nu, topside_mass_t=args.topside_mass,
                             support_stiffness=spring,
                             added_mass_Ca=args.added_mass,
                             rho_water=args.rho_water)
    periods = _np(res.periods_s)
    print(f"structural mass: {float(res.total_mass_t):.1f} t "
          f"(incl. {args.topside_mass:.0f} t topside)")
    print(f"  {'Mode':>4} {'f [Hz]':>10} {'T [s]':>10}")
    for i, (f, T) in enumerate(zip(_np(res.frequencies_hz), periods)):
        print(f"  {i+1:>4} {f:>10.4f} {T:>10.3f}")
    print(f"wave period {args.T:.2f} s vs first natural period "
          f"{float(periods[0]):.3f} s "
          f"(ratio {args.T/float(periods[0]):.2f})")


def cmd_contour(args):
    """N-year IFORM environmental contour (+ optional response envelope)."""
    import json as _json

    import numpy as np

    from .ops.metocean import fit_joint_hs_tp, n_year_sea_states

    raw = args.scatter
    text = raw if raw.strip().startswith("[") else open(raw).read()
    rows = np.asarray(_json.loads(text), dtype=np.float64)
    if rows.ndim != 2 or rows.shape[1] not in (2, 3):
        raise SystemExit("--scatter needs [[Hs, Tp, (occurrence)], ...]")
    occ = rows[:, 2] if rows.shape[1] == 3 else None
    model_jt = fit_joint_hs_tp(rows[:, 0], rows[:, 1], occurrence=occ,
                               n_bins=args.bins,
                               state_hours=args.state_hours)
    print(f"joint fit: Hs ~ Weibull(k={model_jt.weibull_k:.3f}, "
          f"lam={model_jt.weibull_lam:.3f} m); ln Tp | Hs lognormal over "
          f"{args.bins} bins ({args.state_hours:g} h states)")
    hs, tp = n_year_sea_states(model_jt, args.return_years,
                               n_points=args.points)
    print(f"{args.return_years:g}-year IFORM contour ({args.points} points):")
    for h, t in zip(hs, tp):
        print(f"  Hs {h:6.2f} m  Tp {t:6.2f} s")
    if args.envelope:
        from . import design_envelope
        from .parallel.sweep import make_case_batch, make_wave_batch
        model, _, case = _setup(args)
        hs_c = np.clip(hs, 0.05, 0.78 * args.d)
        waves = make_wave_batch(hs_c, tp, args.d, U_c=args.Uc, model="airy",
                                dtype=_dtype(args), device=args.device)
        cases = make_case_batch(case, t_analysis=np.zeros(len(hs_c)))
        env = design_envelope(model, waves, cases, n_steps=args.phase_steps)
        g = int(env.governing_case)
        print(f"contour response envelope: governing state Hs "
              f"{hs_c[g]:.2f} m / Tp {tp[g]:.2f} s, max utilization "
              f"{float(env.max_util_per_case.max()):.4f}")
    if args.spectral:
        # response-based check: every contour state through the FD
        # transfer in one batched call; the MPM utilization over the
        # state-duration storm is the N-year short-term extreme estimate
        from . import api, refine_model
        model, _, case = _setup(args)
        n_seg = max(args.refine, 2)
        refined = refine_model(model, n_seg)
        prep = api.prepare_condensed(model, refined, n_seg, E=case.E,
                                     nu=case.nu)
        hs_c = np.clip(hs, 0.05, 0.78 * args.d)
        states = [(float(h), float(t), 1.0 / len(hs_c))
                  for h, t in zip(hs_c, tp)]
        res = api.scatter_fatigue_spectral(
            prep, case, states, d=args.d, exposure_years=1.0,
            n_components=args.components, seed=args.seed, U_c=args.Uc,
            storm_hours=args.state_hours,
            dynamic=args.dynamic, damping_ratio=args.damping)
        mu = _np(res.mpm_utilization)
        e = int(np.argmax(mu))
        per_state_peak = _np(res.per_state_sigma).max(axis=1)
        gs = int(np.argmax(per_state_peak))
        kind = "dynamic CB" if args.dynamic else "quasi-static"
        print(f"contour spectral screen ({kind}, {len(states)} states x "
              f"{args.components} components, {args.state_hours:g}-h MPM): "
              f"max utilization {mu[e]:.4f} at "
              f"{refined.member_names[e]} (peak-sigma state Hs "
              f"{states[gs][0]:.2f} m / Tp {states[gs][1]:.2f} s)")
        if mu[e] > 1.0:
            print("  WARNING: N-year MPM extreme exceeds yield!")


def cmd_reliability(args):
    """Direct FORM on the governing utilization under the wave climate."""
    import json as _json

    import numpy as np

    from .ops.metocean import fit_joint_hs_tp
    from .ops.reliability import (environmental_reliability,
                                  utilization_response)

    raw = args.scatter
    text = raw if raw.strip().startswith("[") else open(raw).read()
    rows = np.asarray(_json.loads(text), dtype=np.float64)
    if rows.ndim != 2 or rows.shape[1] not in (2, 3):
        raise SystemExit("--scatter needs [[Hs, Tp, (occurrence)], ...]")
    occ = rows[:, 2] if rows.shape[1] == 3 else None
    # Resolve 'auto' to ONE concrete wave model before building the response
    # closures (as cmd_envelope does): 'auto' switches theory/order with
    # steepness, which (a) the batched Monte-Carlo path rejects outright and
    # (b) makes the limit state discontinuous under the FORM finite-
    # difference steps.
    wave_model = "stokes" if args.wave_model == "auto" else args.wave_model
    if args.wave_model == "auto":
        print("[reliability] note: 'auto' resolves to Stokes-5 so the FORM "
              "limit state stays smooth across sea states — pass "
              "--wave-model fenton for very steep climates", file=sys.stderr)
    joint = fit_joint_hs_tp(rows[:, 0], rows[:, 1], occurrence=occ,
                            n_bins=args.bins, state_hours=args.state_hours)
    print(f"joint fit: Hs ~ Weibull(k={joint.weibull_k:.3f}, "
          f"lam={joint.weibull_lam:.3f} m); ln Tp | Hs lognormal over "
          f"{args.bins} bins ({args.state_hours:g} h states)")
    model, _, case = _setup(args)
    response = utilization_response(
        model, case, d=args.d, U_c=args.Uc, wave_model=wave_model, N=args.N,
        n_steps=args.phase_steps)
    rel = environmental_reliability(response, joint, args.threshold,
                                    max_iter=args.max_iter)
    f = rel.form
    if np.isinf(f.beta):
        print(f"utilization cannot reach {args.threshold:g} anywhere inside "
              f"the searched climate (checked to 8 sigma, breaking-"
              f"saturated): pf < 1e-15 per state; deepest probe Hs "
              f"{rel.hs_star:.2f} m / Tp {rel.tp_star:.2f} s reached "
              f"utilization {args.threshold - f.g_star:.4f}")
        return
    print(f"FORM on utilization > {args.threshold:g} "
          f"({f.n_iter} iterations, {f.n_evals} phase scans"
          f"{'' if f.converged else '; NOT CONVERGED'}):")
    print(f"  reliability index beta = {f.beta:.3f}  "
          f"(alpha: Hs {f.alpha[0]:+.3f}, Tp {f.alpha[1]:+.3f})")
    print(f"  design storm: Hs {rel.hs_star:.2f} m, Tp {rel.tp_star:.2f} s")
    print(f"  failure probability: {rel.pf_state:.3e} per "
          f"{args.state_hours:g}-h state, {rel.pf_annual:.3e} per year "
          f"(return period {rel.return_years:,.0f} years)")
    if not f.converged:
        raise SystemExit("FORM did not converge — loosen --threshold or "
                         "check that the climate reaches it")
    if args.monte_carlo:
        from .ops.reliability import (hs_tp_limit_state_batch,
                                      importance_sample_batch,
                                      utilization_response_batch)
        resp_b = utilization_response_batch(
            model, case, d=args.d, U_c=args.Uc, wave_model=wave_model,
            N=args.N, n_steps=args.phase_steps)
        g_b = hs_tp_limit_state_batch(resp_b, joint, args.threshold)
        pf_is, cov = importance_sample_batch(g_b, f,
                                             n_samples=args.monte_carlo)
        ok = abs(rel.pf_state - pf_is) <= 3.0 * cov * max(pf_is, 1e-300)
        print(f"  importance-sampling check ({args.monte_carlo} samples, "
              f"one envelope program): pf = {pf_is:.3e} (cov {cov:.1%}) "
              f"-> FORM {'inside' if ok else 'OUTSIDE'} the 3-sigma band")


def cmd_robustness(args):
    """Member-removal (ALS damage) screen — beyond the reference."""
    import numpy as np

    from .ops.robustness import member_removal_screen

    model, wave, case = _setup(args)
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    scr = member_removal_screen(model, wave, case, support_stiffness=spring)
    util = _np(scr.max_util)
    stable = _np(scr.stable)
    crit = _np(scr.critical)
    gov = _np(scr.governing_member)
    print(f"single-member-removal screen over {model.n_members} members "
          f"(one vmapped batch); intact max utilization "
          f"{float(scr.intact_util):.4f}")
    order = np.argsort(np.where(stable, util, np.inf))[::-1][:args.top]
    print(f"  {'Removed member':<26} {'max util (others)':>18} "
          f"{'governing':>22}")
    for m in order:
        state = ("UNSTABLE" if not stable[m]
                 else f"{util[m]:>18.4f}")
        print(f"  {model.member_names[m]:<26} {state:>18} "
              f"{model.member_names[int(gov[m])]:>22}"
              + ("   << CRITICAL" if crit[m] else ""))
    n_crit = int(crit.sum())
    print(f"critical members (loss yields or destabilizes): {n_crit}"
          + ("" if n_crit == 0 else " -- NOT damage-tolerant at this state"))


def cmd_pushover(args):
    """Pushover / Reserve Strength Ratio — beyond the reference (it is
    strictly linear-elastic)."""
    import numpy as np

    from .ops.pushover import pushover, pushover_rose

    model, wave, case = _setup(args)
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    kw = dict(lambda_max=args.lambda_max, n_lambda=args.n_lambda,
              n_iter=args.iterations, k_factor=args.k_factor,
              residual=args.residual, support_stiffness=spring)
    if args.rose:
        headings = [360.0 * i / args.rose for i in range(args.rose)]
        hd, rsr, fy, _ = pushover_rose(model, wave, case, headings, **kw)
        hd, rsr, fy = _np(hd), _np(rsr), _np(fy)
        print(f"directional pushover rose ({args.rose} headings):")
        print(f"  {'heading':>8} {'1st yield':>10} {'RSR':>8}")
        for h, f, r in zip(hd, fy, rsr):
            print(f"  {h:>7.0f}deg {f:>10.3f} {r:>8.3f}")
        i = int(rsr.argmin())
        print(f"governing heading {hd[i]:.0f} deg: RSR = {rsr[i]:.3f}")
        return
    res = pushover(model, wave, case, **kw)
    lam = _np(res.lambdas)
    conv = _np(res.converged)
    disp = _np(res.max_displacement_mm)
    ny = _np(res.n_yielded)
    util = _np(res.max_util)
    print("pushover (gravity constant, environment x lambda; EPP axial "
          "yield, elastic bending):")
    print(f"  {'lambda':>7} {'max disp [mm]':>14} {'yielded':>8} "
          f"{'max util':>9}")
    for i in range(len(lam)):
        tag = "" if conv[i] else "  <- NOT CONVERGED (collapse)"
        print(f"  {lam[i]:>7.3f} {disp[i]:>14.1f} {ny[i]:>8d} "
              f"{util[i]:>9.3f}{tag}")
        if not conv[i]:
            break
    print(f"first member yield at lambda = "
          f"{float(res.first_yield_lambda):.3f}")
    print(f"reserve strength ratio (RSR) = {float(res.rsr):.3f}"
          + ("  (no collapse below lambda_max — raise --lambda-max for "
             "the true RSR)" if conv.all() else ""))


def cmd_transient(args):
    """Newmark time integration on the Craig-Bampton basis — beyond the
    reference (its Info tab excludes dynamics)."""
    import numpy as np

    from . import refine_model
    from .ops.dynamics import transient_response_condensed

    model, wave, case = _setup(args)
    if args.spectrum:
        from .ops.spectrum import make_random_sea
        hs = args.hs if args.hs is not None else args.H
        tp = args.tp if args.tp is not None else args.T
        wave = make_random_sea(hs, tp, args.d, args.components,
                               seed=args.seed, spectrum=args.spectrum,
                               dtype=_dtype(args), device=args.device)
        T_char = tp
        print(f"irregular sea: {args.spectrum.upper()} Hs={hs} m "
              f"Tp={tp} s, {args.components} components")
    else:
        T_char = args.T
    refined = refine_model(model, args.refine)
    dt = args.dt if args.dt else T_char / 64.0
    n_steps = int(round(args.periods * T_char / dt))
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    print(f"transient: {refined.n_dof} DOF (reduced march), dt={dt:.3f} s"
          f", {n_steps} steps ({args.periods:g} periods), damping "
          f"{100 * args.damping:.1f}%"
          + (", relative-velocity drag" if args.relative_drag else ""))
    ground = None
    gdir = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0),
            "z": (0.0, 0.0, 1.0)}[args.ground_dir]
    if args.accelerogram:
        ground = np.loadtxt(args.accelerogram)
        if ground.ndim == 2:
            ground = ground[:, -1]
        if ground.shape[0] < n_steps:
            ground = np.pad(ground, (0, n_steps - ground.shape[0]))
        ground = ground[:n_steps]
        print(f"ground motion: {args.accelerogram} along "
              f"{args.ground_dir}, peak {abs(ground).max():.2f} m/s^2")
    res = transient_response_condensed(
        model, refined, args.refine, wave, case, dt, n_steps,
        damping_ratio=args.damping, topside_mass_t=args.topside_mass,
        n_chain_modes=args.chain_modes, support_stiffness=spring,
        ramp_periods=args.ramp, added_mass_Ca=args.added_mass,
        relative_drag=args.relative_drag,
        ground_accel=ground, ground_dir=gdir)
    tip = _np(res.tip_displacement_mm)
    util = _np(res.utilization)
    ts = _np(res.ts)
    i_peak = int(util.max(axis=1).argmax())
    print(f"first natural period: {2 * np.pi / float(res.omega1):.3f} s")
    print(f"peak displacement: {tip.max():.1f} mm at "
          f"t = {float(ts[int(tip.argmax())]):.2f} s")
    print(f"peak utilization: {util.max():.4f} at t = "
          f"{float(ts[i_peak]):.2f} s")
    tail = util[n_steps // 2:]
    print(f"steady-state utilization (last half): max {tail.max():.4f}, "
          f"mean-of-peaks {tail.max(axis=1).mean():.4f}")


def cmd_seismic(args):
    """Response-spectrum earthquake check (modal CQC) — beyond the
    reference's scope (its Info tab excludes seismic actions)."""
    import numpy as np

    from .ops.seismic import response_spectrum, response_spectrum_condensed

    dirs = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0)]
    if args.vertical:
        dirs.append((0.0, 0.0, 1.0))
    spectrum = None
    if args.spectrum_file:
        tab = np.loadtxt(args.spectrum_file, delimiter=",")
        spectrum = (tab[:, 0], tab[:, 1])
        print(f"site-specific spectrum: {tab.shape[0]} (T, Sa) points "
              f"from {args.spectrum_file}")
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    model, _, case = _setup(args)
    kw = dict(ground=args.ground, zeta=args.zeta, n_modes=args.n_modes,
              E=args.E, nu=args.nu, fy=args.fy,
              topside_mass_t=args.topside_mass, support_stiffness=spring,
              added_mass_Ca=args.added_mass, rho_water=args.rho_water,
              directions=dirs, spectrum=spectrum,
              combination=args.combination, dir_rule=args.dir_rule)
    if args.refine > 1:
        from . import refine_model
        refined = refine_model(model, args.refine)
        print(f"Craig-Bampton reduced spectrum analysis: "
              f"{refined.n_dof} DOF, demands recovered on the full "
              f"refined mesh")
        res = response_spectrum_condensed(
            model, refined, args.refine, args.pga_g,
            n_chain_modes=args.chain_modes, **kw)
        model = refined  # member table below reports refined elements
    else:
        res = response_spectrum(model, args.pga_g, **kw)
    print(f"design PGA {args.pga_g:g} g, ground class {args.ground}, "
          f"damping {100 * args.zeta:.1f}%, {args.combination.upper()} x "
          f"{args.dir_rule} over {len(dirs)} directions")
    print(f"structural + topside mass: {float(res.total_mass_t):.1f} t")
    print(f"  {'Mode':>4} {'T [s]':>8} {'Sa_x [m/s2]':>12} "
          f"{'M_eff,x [t]':>12} {'M_eff,y [t]':>12}")
    meff = _np(res.effective_mass_t)
    Sa = _np(res.Sa_ms2)
    for i, T in enumerate(_np(res.periods_s)):
        print(f"  {i + 1:>4} {T:>8.3f} {float(Sa[0, i]):>12.3f} "
              f"{meff[0, i]:>12.1f} {meff[1, i]:>12.1f}")
    cum = meff.sum(axis=1) / float(res.total_mass_t)
    names = ("x", "y", "z")[:meff.shape[0]]
    print("captured modal mass: "
          + ", ".join(f"{n} {c:.1%}" for n, c in zip(names, cum))
          + " of total (aim >= 90%; raise --n-modes if low)")
    for d, v in zip(("x", "y", "z"), _np(res.base_shear_kN)):
        print(f"base shear {d}: {v:,.0f} kN")
    print(f"peak displacement: {float(res.max_displacement_mm):.1f} mm")
    util = _np(res.utilization)
    order = np.argsort(util)[::-1][:10]
    print(f"  {'Member (seismic only)':<30} {'Util':>8}")
    for e in order:
        print(f"  {model.member_names[e]:<30} {util[e]:>8.2%}")


def cmd_air_gap(args):
    """Deck air-gap (crest clearance) screen — beyond the reference."""
    from .ops.airgap import air_gap_check

    model, wave, case = _setup(args)
    res = air_gap_check(model, wave, wave_dir_deg=case.wave_dir_deg,
                        deck_elevation_m=args.deck_elevation,
                        surge_m=args.surge, tide_m=args.tide,
                        margin_m=args.margin,
                        n_phases=args.phase_steps)
    print(f"deck underside: {res.deck_elevation_m:.2f} m above MWL")
    print(f"max crest: {float(res.crest_m):.2f} m at phase "
          f"{float(res.crest_phase_deg):.0f} deg, x' = "
          f"{float(res.crest_x_m):.1f} m along the heading"
          + (f"; still-water level +{res.swl_offset_m:.2f} m (surge+tide)"
             if res.swl_offset_m else ""))
    print(f"air gap: {float(res.air_gap_m):.2f} m vs required "
          f"{res.margin_m:.2f} m -> "
          + ("OK" if bool(res.ok) else "INSUFFICIENT (wave-in-deck risk)"))


def cmd_dynamic(args):
    """Steady-state wave-frequency dynamic response + DAF."""
    from .ops.dynamics import dynamic_response, dynamic_response_condensed

    model, wave, case = _setup(args)
    spring = getattr(args, "support_spring", None)
    _spring_banner(spring)
    if getattr(args, "refine", 1) > 1:
        from . import refine_model
        refined = refine_model(model, args.refine)
        print(f"Craig-Bampton reduced dynamic response: "
              f"{refined.n_dof} DOF refined mesh")
        resp = dynamic_response_condensed(
            model, refined, args.refine, wave, case,
            n_harmonics=args.n_harmonics, damping_ratio=args.damping,
            n_steps=args.phase_steps, n_chain_modes=args.chain_modes,
            support_stiffness=spring, added_mass_Ca=args.added_mass)
    else:
        resp = dynamic_response(model, wave, case,
                                n_harmonics=args.n_harmonics,
                                damping_ratio=args.damping,
                                n_steps=args.phase_steps,
                                support_stiffness=spring,
                                added_mass_Ca=args.added_mass)
    print(f"Rayleigh damping: alpha={float(resp.rayleigh_alpha):.4f} "
          f"beta={float(resp.rayleigh_beta):.2e} "
          f"(zeta={args.damping:.1%})")
    print(f"dynamic amplification factor (max disp): {float(resp.daf):.3f}")
    u_dyn = float(_np(resp.utilization).max())
    u_sta = float(_np(resp.utilization_static).max())
    print(f"max utilization: dynamic {u_dyn:.4f} vs quasi-static {u_sta:.4f} "
          f"({u_dyn/u_sta:.3f}x)")


def cmd_code_check(args):
    """API RP 2A-WSD or ISO 19902 member strength checks on the analyzed
    state."""
    import numpy as np

    from . import analyze
    from .ops.codecheck import member_code_check
    from .ops.codecheck_iso import iso_member_check

    model, wave, case = _setup(args)
    res = analyze(model, wave, case, solver="chol", accel="analytic")
    fn = member_code_check if args.standard == "api" else iso_member_check
    chk = fn(model, res, Fy=args.fy, E=args.E,
             K_leg=args.K_leg, K_brace=args.K_brace, Cm=args.cm_factor)
    uc = _np(chk.uc)
    order = np.argsort(uc)[::-1][:12]
    std = ("API RP 2A-WSD" if args.standard == "api"
           else "ISO 19902 (gamma_R partial factors)")
    fa, fb, klr = _np(chk.fa_mpa), _np(chk.fb_mpa), _np(chk.KL_over_r)
    print(f"{std} member checks (Fy={args.fy} MPa, K_leg="
          f"{args.K_leg}, K_brace={args.K_brace}, Cm={args.cm_factor}):")
    if args.standard == "api":
        Fa, Fb = _np(chk.Fa_mpa), _np(chk.Fb_mpa)
        print(f"  {'Member':<24} {'UC':>6} {'gov':>10} {'fa':>7} {'fb':>7} "
              f"{'Fa':>7} {'Fb':>7} {'KL/r':>6}")
        for e in order:
            print(f"  {model.member_names[e]:<24} {uc[e]:>6.3f} "
                  f"{chk.governing[e]:>10} {float(fa[e]):>7.1f} "
                  f"{float(fb[e]):>7.1f} {float(Fa[e]):>7.1f} "
                  f"{float(Fb[e]):>7.1f} "
                  f"{float(klr[e]):>6.1f}")
    else:
        fc, fbr = _np(chk.fc_mpa), _np(chk.fb_rep_mpa)
        print(f"  {'Member':<24} {'UC':>6} {'gov':>11} {'fa':>7} {'fb':>7} "
              f"{'fc':>7} {'f_b':>7} {'KL/r':>6}")
        for e in order:
            print(f"  {model.member_names[e]:<24} {uc[e]:>6.3f} "
                  f"{chk.governing[e]:>11} {float(fa[e]):>7.1f} "
                  f"{float(fb[e]):>7.1f} {float(fc[e]):>7.1f} "
                  f"{float(fbr[e]):>7.1f} "
                  f"{float(klr[e]):>6.1f}")
    if uc.max() > 1.0:
        print(f"  WARNING: unity check > 1.0 — member strength exceeded per "
              f"{std}!")
    else:
        print(f"  all members pass (max UC {uc.max():.3f}); von Mises "
              f"utilization max {float(res.utilization.max()):.3f}")


def cmd_joint_check(args):
    """API RP 2A-WSD simple tubular-joint checks on the analyzed state."""
    import numpy as np

    from . import analyze
    from .ops.jointcheck import joint_code_check

    model, wave, case = _setup(args)
    res = analyze(model, wave, case, solver="chol", accel="analytic")
    chk = joint_code_check(model, res, Fy=args.fy,
                           joint_class=args.joint_class, gap_mm=args.gap)
    uc = _np(chk.uc)
    brace, beta, gamma = _np(chk.brace), _np(chk.beta), _np(chk.gamma)
    uca, ucb, qf = _np(chk.uc_axial), _np(chk.uc_bending), _np(chk.Qf_axial)
    fK, fX, fY = _np(chk.frac_K), _np(chk.frac_X), _np(chk.frac_Y)
    order = np.argsort(uc)[::-1][:12]
    print(f"API RP 2A-WSD simple-joint checks (class={args.joint_class}, "
          f"Fyc={args.fy} MPa, {uc.shape[0]} brace-to-leg joints):")
    show_frac = args.joint_class == "auto"
    frac_hdr = f" {'K/X/Y':>11}" if show_frac else ""
    print(f"  {'Brace':<24} {'UC':>6} {'beta':>5} {'gamma':>6} "
          f"{'P/Pa':>6} {'UCb':>6} {'Qf':>5}{frac_hdr}")
    for j in order:
        frac = (f" {float(fK[j]):>3.1f}/"
                f"{float(fX[j]):>3.1f}/"
                f"{float(fY[j]):>3.1f}") if show_frac else ""
        print(f"  {model.member_names[int(brace[j])]:<24} "
              f"{uc[j]:>6.3f} {float(beta[j]):>5.2f} "
              f"{float(gamma[j]):>6.1f} {float(uca[j]):>6.3f} "
              f"{float(ucb[j]):>6.3f} "
              f"{float(qf[j]):>5.2f}{frac}")
    if chk.degenerate.any():
        n = int(chk.degenerate.sum())
        print(f"  NOTE: {n} near-parallel brace/chord pair(s) clamped at "
              f"sin(theta)=0.17")
    if uc.max() > 1.0:
        print("  WARNING: joint unity check > 1.0 — chord punching capacity "
              "exceeded per API RP 2A-WSD!")
    else:
        print(f"  all joints pass (max UC {uc.max():.3f})")


def cmd_viv(args):
    """Current-induced VIV susceptibility screen (DNV screening values)."""
    import numpy as np

    from . import default_3leg_jacket
    from .ops.viv import viv_screen
    from .utils.io import load_model

    if args.model:
        model, _ = load_model(args.model, dtype=_dtype(args),
                              device=args.device)
    else:
        model = default_3leg_jacket(z_water_ref=args.z_water_ref,
                                    dtype=_dtype(args), device=args.device)
    scr = viv_screen(model, U_c=args.Uc, d=args.d,
                     rho_water=args.rho_water, zeta=args.zeta,
                     Ca=args.Cm - 1.0, current_alpha=args.current_alpha,
                     marine_growth_mm=args.marine_growth,
                     flooded=args.flooded, E=args.E,
                     end_fixity=args.end_fixity)
    il, cf = _np(scr.uc_inline), _np(scr.uc_crossflow)
    fn, U, Vr, Ks = (_np(scr.f_n_hz), _np(scr.U_ms), _np(scr.V_r),
                     _np(scr.K_s))
    uc = np.maximum(il, cf)
    order = np.argsort(uc)[::-1][:12]
    prof = ("uniform" if args.current_alpha is None
            else f"power-law a={args.current_alpha}")
    print(f"VIV screen (U_c={args.Uc} m/s {prof}, zeta={args.zeta}, "
          f"Ca={args.Cm - 1.0:.1f}, spans {args.end_fixity}):")
    print(f"  {'Member':<24} {'f_n[Hz]':>8} {'U[m/s]':>7} {'V_r':>6} "
          f"{'K_s':>6} {'UC_il':>6} {'UC_cf':>6} {'flag':>10}")
    for e in order:
        print(f"  {model.member_names[e]:<24} {float(fn[e]):>8.2f} "
              f"{float(U[e]):>7.2f} {float(Vr[e]):>6.2f} "
              f"{float(Ks[e]):>6.2f} {float(il[e]):>6.2f} "
              f"{float(cf[e]):>6.2f} {scr.flags[e]:>10}")
    n_bad = int((scr.flags != "ok").sum())
    if n_bad:
        print(f"  WARNING: {n_bad} member(s) susceptible to VIV — detailed "
              "assessment (DNV-RP-C205 sec. 9) required")
    else:
        print("  all members below VIV onset "
              f"(max onset ratio {uc.max():.2f})")


_DEFAULT_SOIL = [
    {"kind": "clay", "z_top": 0.0, "z_bot": 8.0, "su_kPa": 40.0,
     "gamma_kN_m3": 8.0, "eps50": 0.02},
    {"kind": "sand", "z_top": 8.0, "z_bot": 100.0, "phi_deg": 35.0,
     "gamma_kN_m3": 10.0},
]


def cmd_pile(args):
    """Pile-head springs from API p-y/t-z/Q-z curves; optional SSI run."""
    import numpy as np

    from . import (analyze, analyze_ssi, pile_head_stiffness,
                   soil_support_stiffness)
    from .ops.soil import Pile, SoilLayer

    if args.soil:
        raw = args.soil
        if not raw.lstrip().startswith("["):
            with open(raw) as f:
                raw = f.read()
        specs = json.loads(raw)
    else:
        specs = _DEFAULT_SOIL
        print("[soil] using the built-in 2-layer demo profile "
              "(soft clay over dense sand); pass --soil FILE.json for "
              "real data", file=sys.stderr)
    soil = [SoilLayer(**s) for s in specs]
    pile = Pile(D_mm=args.pile_D, t_mm=args.pile_t, L_m=args.pile_L,
                E_MPa=args.E, n_elem=args.pile_n,
                plugged=not args.unplugged)

    model, wave, case = _setup(args)
    if args.from_analysis:
        print("[pile] clamped analysis for per-support working loads ...")
        res = analyze(model, wave, case, solver="chol")
        springs = soil_support_stiffness(model, soil, pile,
                                         reactions=res.reactions,
                                         scour_m=args.scour)
    else:
        head = pile_head_stiffness(pile, soil, H_kN=args.pile_H,
                                   V_kN=args.pile_V, M_kNm=args.pile_M,
                                   scour_m=args.scour, device=args.device)
        fixed = np.where(_np(model.fixed_mask))[0]
        springs = np.tile(_np(head.support_stiffness), (fixed.size, 1))
        print(f"pile head at working loads H={args.pile_H} kN, "
              f"V={args.pile_V} kN: deflection {head.y_head_mm:.1f} mm, "
              f"settlement {head.u_head_mm:.1f} mm "
              f"(Newton residuals {_np(head.residuals).max():.1e})")
    print(f"pile: O{args.pile_D:.0f}x{args.pile_t:.0f} mm, "
          f"L = {args.pile_L:.0f} m, "
          f"{'plugged' if not args.unplugged else 'unplugged'}; "
          f"{len(soil)} soil layer(s)")
    print("secant pile-head springs per support "
          "[kN/mm transl, MN*m/rad rot]:")
    for i, k in enumerate(_np(springs)):
        print(f"  support {i}: kx=ky={k[0]/1e3:.1f} kz={k[2]/1e3:.1f} "
              f"| krx=kry={k[3]/1e9:.1f} krz={k[5]/1e9:.1f}")
    if args.analyze:
        print("\nrunning the load case on the soil springs (analyze_ssi):")
        res = analyze_ssi(model, wave, case, springs)
        from .utils.report import render_report
        print(render_report(model, wave, case, res))


def cmd_save_default(args):
    from . import default_3leg_jacket
    from .utils.io import save_model
    model = default_3leg_jacket(z_water_ref=args.z_water_ref,
                                device=args.device)
    save_model(args.out, model)
    print(f"wrote {args.out}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="small_fem_solver_tpu_torch",
        description="offshore jacket structural analysis on NVIDIA GPUs "
                    "(PyTorch and hand-written CUDA kernels)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="single analysis (the GUI's RUN button)")
    _add_common(run)
    run.add_argument("--t", type=float, default=0.0, help="analysis time [s]")
    run.add_argument("--phase-scan", action="store_true",
                     help="scan one period for the critical phase")
    run.add_argument("--phase-steps", type=int, default=36)
    run.add_argument("--refine", type=int, default=1,
                     help="subdivide members (>1 solves the refined mesh "
                          "via exact chain condensation; 327 -> ~100k DOF)")
    _add_spring_arg(run)
    run.set_defaults(fn=cmd_run)

    sw = sub.add_parser("sweep", help="batched (H, heading) design envelope")
    _add_common(sw)
    sw.add_argument("--H-range", nargs=3, type=float, metavar=("LO", "HI", "N"),
                    default=[4.0, 18.0, 8], help="wave height range")
    sw.add_argument("--dirs", nargs="*", type=float,
                    help="headings [deg from North]")
    sw.set_defaults(fn=cmd_sweep)

    rf = sub.add_parser("refined", help="condensed large-mesh phase scan")
    _add_common(rf)
    rf.add_argument("--n-seg", type=int, default=32,
                    help="elements per member")
    rf.add_argument("--phase-steps", type=int, default=360)
    rf.set_defaults(fn=cmd_refined)

    ev = sub.add_parser("envelope",
                        help="refined-mesh storm envelope (cases x phases)")
    _add_common(ev)
    ev.add_argument("--H-range", nargs=3, type=float, metavar=("LO", "HI", "N"),
                    default=[4.0, 18.0, 8])
    ev.add_argument("--Ts", nargs="*", type=float, help="periods [s]")
    ev.add_argument("--dirs", nargs="*", type=float, help="headings [deg]")
    ev.add_argument("--n-seg", type=int, default=8)
    ev.add_argument("--phase-steps", type=int, default=36)
    _add_spring_arg(ev)
    ev.set_defaults(fn=cmd_envelope)

    dy = sub.add_parser("dynamic",
                        help="wave-frequency dynamic response (DAF)")
    _add_common(dy)
    dy.add_argument("--n-harmonics", type=int, default=8)
    dy.add_argument("--damping", type=float, default=0.02,
                    help="modal damping ratio")
    dy.add_argument("--phase-steps", type=int, default=72)
    dy.add_argument("--added-mass", type=float, default=None,
                    help="hydrodynamic added-mass coefficient Ca (= Cm - 1; "
                         "e.g. 1.0) on the wetted members")
    dy.add_argument("--refine", type=int, default=1,
                    help="subdivide members (>1 uses the Craig-Bampton "
                         "reduced path)")
    dy.add_argument("--chain-modes", type=int, default=12,
                    help="retained fixed-interface modes per member chain")
    _add_spring_arg(dy)
    dy.set_defaults(fn=cmd_dynamic)

    op = sub.add_parser("optimize",
                        help="gradient-based section sizing "
                             "(differentiable design)")
    _add_common(op)
    op.add_argument("--target-util", type=float, default=0.8)
    op.add_argument("--n-iter", type=int, default=80)
    op.set_defaults(fn=cmd_optimize)

    fa = sub.add_parser("fatigue",
                        help="deterministic S-N fatigue screen on a "
                             "phase-resolved scan")
    _add_common(fa)
    fa.add_argument("--years", type=float, default=25.0)
    fa.add_argument("--curve", default="D-sea-cp",
                    help="S-N curve: D, D-sea-cp, F")
    fa.add_argument("--scf", type=float, default=1.5)
    fa.add_argument("--occurrence", type=float, default=1.0,
                    help="fraction of the exposure this sea state acts")
    fa.add_argument("--phase-steps", type=int, default=36)
    fa.add_argument("--refine", type=int, default=1)
    fa.add_argument("--spectrum", choices=["jonswap", "pm"], default=None,
                    help="spectral mode: screen an irregular-sea "
                         "realization instead of one regular wave")
    fa.add_argument("--hs", type=float, default=None,
                    help="significant wave height [m] (default: -H)")
    fa.add_argument("--tp", type=float, default=None,
                    help="peak period [s] (default: -T)")
    fa.add_argument("--components", type=int, default=48)
    fa.add_argument("--seed", type=int, default=0)
    fa.add_argument("--sea-steps", type=int, default=1024,
                    help="realization samples (dt = Tp/10)")
    fa.add_argument("--stretching", choices=["none", "wheeler"],
                    default="wheeler",
                    help="crest kinematics treatment for the linear sea")
    fa.add_argument("--spreading-s", type=float, default=None,
                    help="directional spreading exponent s of cos^(2s): "
                         "short-crested sea (larger = more long-crested)")
    fa.add_argument("--scatter", default=None,
                    help="scatter-diagram fatigue: JSON file (or literal) "
                         "of [[Hs, Tp, occurrence[, heading_deg]], ...] "
                         "rows (4th column = per-state wave heading); "
                         "damage accumulates over the states (uses "
                         "--refine, min 2)")
    fa.add_argument("--freq-domain", action="store_true",
                    help="with --scatter: closed-form frequency-domain "
                         "damage per state (Borgman-linearized transfer; "
                         "no time march, deterministic)")
    fa.add_argument("--dynamic", action="store_true",
                    help="with --freq-domain: dynamic transfer on the "
                         "Craig-Bampton basis (resonance-band energy)")
    fa.add_argument("--damping", type=float, default=0.02,
                    help="modal damping ratio for --dynamic")
    fa.add_argument("--chain-modes", type=int, default=12,
                    help="retained fixed-interface modes per chain "
                         "for --dynamic")
    fa.add_argument("--hydro-damping", action="store_true",
                    help="with --dynamic: add linearized drag damping")
    fa.add_argument("--return-years", default=None,
                    help="with --freq-domain: comma-separated return "
                         "periods for long-term extreme response levels "
                         "(e.g. '10,100')")
    fa.set_defaults(fn=cmd_fatigue)

    sp = sub.add_parser("spectral",
                        help="frequency-domain stochastic response: "
                             "linearized transfer, closed-form fatigue + "
                             "MPM extremes (no time march)")
    _add_common(sp)
    sp.add_argument("--years", type=float, default=25.0)
    sp.add_argument("--curve", default="D-sea-cp",
                    help="S-N curve: D, D-sea-cp, F")
    sp.add_argument("--scf", type=float, default=1.5)
    sp.add_argument("--occurrence", type=float, default=1.0)
    sp.add_argument("--refine", type=int, default=2,
                    help="chain refinement (condensed solve; min 2)")
    sp.add_argument("--spectrum", choices=["jonswap", "pm"],
                    default="jonswap")
    sp.add_argument("--hs", type=float, default=None,
                    help="significant wave height [m] (default: -H)")
    sp.add_argument("--tp", type=float, default=None,
                    help="peak period [s] (default: -T)")
    sp.add_argument("--components", type=int, default=48)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--spreading-s", type=float, default=None)
    sp.add_argument("--storm-hours", type=float, default=3.0,
                    help="storm duration for the MPM extremes")
    sp.add_argument("--dynamic", action="store_true",
                    help="dynamic transfer on the Craig-Bampton basis "
                         "(inertia + damping; resonance-band energy "
                         "amplified) instead of quasi-static solves")
    sp.add_argument("--damping", type=float, default=0.02,
                    help="modal damping ratio for --dynamic")
    sp.add_argument("--chain-modes", type=int, default=12,
                    help="retained fixed-interface modes per chain "
                         "for --dynamic")
    sp.add_argument("--hydro-damping", action="store_true",
                    help="with --dynamic: add the Borgman-linearized "
                         "relative-velocity drag damping (modal "
                         "projection)")
    sp.set_defaults(fn=cmd_spectral)

    co = sub.add_parser("contour",
                        help="N-year IFORM environmental contour from a "
                             "(Hs, Tp) scatter, optionally driving the "
                             "response envelope")
    _add_common(co)
    co.add_argument("--scatter", required=True,
                    help="JSON file (or literal) of [[Hs, Tp, (occ)], ...]")
    co.add_argument("--return-years", type=float, default=100.0)
    co.add_argument("--points", type=int, default=16)
    co.add_argument("--bins", type=int, default=8)
    co.add_argument("--state-hours", type=float, default=3.0)
    co.add_argument("--envelope", action="store_true",
                    help="run the contour states through design_envelope")
    co.add_argument("--phase-steps", type=int, default=12)
    co.add_argument("--spectral", action="store_true",
                    help="response-based check: every contour state "
                         "through the frequency-domain transfer (one "
                         "batched call, no time march); MPM "
                         "utilizations over the state duration")
    co.add_argument("--refine", type=int, default=2)
    co.add_argument("--components", type=int, default=32)
    co.add_argument("--seed", type=int, default=0)
    co.add_argument("--dynamic", action="store_true",
                    help="with --spectral: CB dynamic transfer")
    co.add_argument("--damping", type=float, default=0.02)
    co.set_defaults(fn=cmd_contour)

    rl = sub.add_parser("reliability",
                        help="direct FORM: probability that the governing "
                             "utilization exceeds a threshold under the "
                             "(Hs, Tp) climate")
    _add_common(rl)
    rl.add_argument("--scatter", required=True,
                    help="JSON file (or literal) of [[Hs, Tp, (occ)], ...]")
    rl.add_argument("--threshold", type=float, default=1.0,
                    help="utilization limit (1.0 = first yield)")
    rl.add_argument("--bins", type=int, default=8)
    rl.add_argument("--state-hours", type=float, default=3.0)
    rl.add_argument("--phase-steps", type=int, default=12)
    rl.add_argument("--max-iter", type=int, default=30)
    rl.add_argument("--monte-carlo", type=int, default=0, metavar="N",
                    help="validate the FORM pf with N importance samples "
                         "run as ONE design envelope")
    rl.set_defaults(fn=cmd_reliability)

    rb = sub.add_parser("robustness",
                        help="single-member-removal (ALS damage) screen: "
                             "re-analyzes every damaged configuration in "
                             "one batched factorization")
    _add_common(rb)
    rb.add_argument("--top", type=int, default=12,
                    help="rows shown (worst removals first)")
    _add_spring_arg(rb)
    rb.set_defaults(fn=cmd_robustness)

    po = sub.add_parser("pushover",
                        help="pushover / reserve strength ratio (gravity "
                             "constant, environment scaled; EPP axial "
                             "member yield)")
    _add_common(po)
    po.add_argument("--lambda-max", type=float, default=6.0,
                    help="largest environmental load factor scanned")
    po.add_argument("--n-lambda", type=int, default=25)
    po.add_argument("--iterations", type=int, default=120,
                    help="secant load-shedding iterations per lambda")
    po.add_argument("--k-factor", type=float, default=1.0,
                    help="effective-length factor for compression capacity")
    po.add_argument("--residual", type=float, default=1.0,
                    help="post-capacity retained fraction (EPP = 1; < 1 "
                         "approximates post-buckling degradation)")
    po.add_argument("--rose", type=int, default=0,
                    help="directional rose: pushover at N equally spaced "
                         "headings (wave+current rotate together), "
                         "reporting the governing (minimum) RSR")
    _add_spring_arg(po)
    po.set_defaults(fn=cmd_pushover)

    tr = sub.add_parser("transient",
                        help="Newmark time integration on the Craig-"
                             "Bampton reduced basis (regular wave or "
                             "irregular sea; optional relative-velocity "
                             "drag damping)")
    _add_common(tr)
    tr.add_argument("--refine", type=int, default=4,
                    help="member subdivision (reduced-basis size is "
                         "refinement-independent)")
    tr.add_argument("--chain-modes", type=int, default=12)
    tr.add_argument("--dt", type=float, default=None,
                    help="time step [s] (default T/64)")
    tr.add_argument("--periods", type=float, default=10.0,
                    help="simulation length in wave (peak) periods")
    tr.add_argument("--damping", type=float, default=0.02,
                    help="Rayleigh damping ratio")
    tr.add_argument("--ramp", type=float, default=2.0,
                    help="load ramp-up [periods]")
    tr.add_argument("--topside-mass", type=float, default=1100.0)
    tr.add_argument("--added-mass", type=float, default=None,
                    help="hydrodynamic added-mass Ca (= Cm - 1)")
    tr.add_argument("--relative-drag", action="store_true",
                    help="relative-velocity Morison drag (physical "
                         "hydrodynamic damping)")
    tr.add_argument("--spectrum", choices=["jonswap", "pm"], default=None,
                    help="drive with an irregular-sea realization")
    tr.add_argument("--hs", type=float, default=None,
                    help="significant wave height [m] (default: -H)")
    tr.add_argument("--tp", type=float, default=None,
                    help="peak period [s] (default: -T)")
    tr.add_argument("--components", type=int, default=48)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--accelerogram", default=None,
                    help="ground-acceleration time series file [m/s^2] "
                         "(one value per dt step; seismic time history, "
                         "relative-coordinate formulation)")
    tr.add_argument("--ground-dir", default="x", choices=["x", "y", "z"])
    _add_spring_arg(tr)
    tr.set_defaults(fn=cmd_transient)

    bk = sub.add_parser("buckling",
                        help="member Euler screen + linearized global "
                             "buckling (beyond the reference's scope)")
    _add_common(bk)
    bk.add_argument("--k-factor", type=float, default=0.8,
                    help="member effective-length factor for the screen")
    bk.add_argument("--n-modes", type=int, default=4)
    bk.add_argument("--refine", type=int, default=1,
                    help="subdivide members (>1 uses the Craig-Bampton "
                         "reduced buckling path)")
    bk.add_argument("--chain-modes", type=int, default=12,
                    help="retained fixed-interface modes per member chain")
    _add_spring_arg(bk)
    bk.set_defaults(fn=cmd_buckling)

    pdp = sub.add_parser("pdelta",
                         help="second-order (P-delta) analysis "
                              "(beyond the reference's scope)")
    _add_common(pdp)
    pdp.add_argument("--n-iter", type=int, default=3,
                     help="fixed-point rounds on the axial-force state")
    pdp.add_argument("--refine", type=int, default=1,
                     help="subdivide members (>1 runs the condensed "
                          "P-delta through the chain solver)")
    _add_spring_arg(pdp)
    pdp.set_defaults(fn=cmd_pdelta)

    cc = sub.add_parser("code-check",
                        help="API RP 2A-WSD or ISO 19902 member strength "
                             "unity checks (beyond the reference's yield "
                             "screen)")
    _add_common(cc)
    cc.add_argument("--standard", default="api", choices=["api", "iso"],
                    help="API RP 2A-WSD working stress or ISO 19902 "
                         "partial-factor checks")
    cc.add_argument("--K-leg", type=float, default=1.0,
                    help="effective length factor for legs")
    cc.add_argument("--K-brace", type=float, default=0.8,
                    help="effective length factor for braces")
    cc.add_argument("--cm-factor", type=float, default=0.85,
                    help="moment reduction factor Cm of the interaction "
                         "equation (not the Morison inertia coefficient)")
    cc.set_defaults(fn=cmd_code_check)

    jc = sub.add_parser("joint-check",
                        help="API RP 2A-WSD simple tubular-joint "
                             "(punching-shear) checks "
                             "(beyond the reference's yield screen)")
    _add_common(jc)
    jc.add_argument("--joint-class", default="Y",
                    choices=["Y", "T", "K", "X", "auto"],
                    help="joint classification applied to all joints, or "
                         "'auto' for API 4.2 load-path fractions")
    jc.add_argument("--gap", type=float, default=50.0,
                    help="K-joint gap [mm] for the Qg factor")
    jc.set_defaults(fn=cmd_joint_check)

    vv = sub.add_parser("viv",
                        help="current-induced VIV susceptibility screen "
                             "(beyond the reference's scope)")
    _add_common(vv)
    vv.add_argument("--zeta", type=float, default=0.01,
                    help="structural damping ratio of the member spans")
    vv.add_argument("--current-alpha", type=float, default=None,
                    help="power-law current profile exponent (e.g. 0.1429 "
                         "= 1/7); default uniform")
    vv.add_argument("--flooded", default="none",
                    choices=["none", "legs", "all"],
                    help="members carrying internal water mass")
    vv.add_argument("--end-fixity", default="fixed",
                    choices=["fixed", "pinned"],
                    help="span end condition for the natural frequency")
    vv.set_defaults(fn=cmd_viv)

    md = sub.add_parser("modes", help="natural frequencies (modal analysis)")
    _add_common(md)
    md.add_argument("--n-modes", type=int, default=8)
    md.add_argument("--topside-mass", type=float, default=1100.0,
                    help="lumped deck mass [tonnes]")
    md.add_argument("--added-mass", type=float, default=None,
                    help="hydrodynamic added-mass coefficient Ca (= Cm - 1; "
                         "e.g. 1.0) on the wetted members")
    md.add_argument("--refine", type=int, default=1,
                    help="subdivide members (>1 uses the Craig-Bampton "
                         "reduced path; works to 100k+ DOF)")
    md.add_argument("--chain-modes", type=int, default=12,
                    help="retained fixed-interface modes per member chain")
    _add_spring_arg(md)
    md.set_defaults(fn=cmd_modes)

    ag = sub.add_parser("air-gap",
                        help="deck air-gap (wave crest clearance) screen")
    _add_common(ag)
    ag.add_argument("--deck-elevation", type=float, default=None,
                    help="deck underside above MWL [m] (default: the "
                         "model's top-node elevation)")
    ag.add_argument("--surge", type=float, default=0.0,
                    help="storm surge still-water rise [m]")
    ag.add_argument("--tide", type=float, default=0.0,
                    help="tidal still-water rise [m]")
    ag.add_argument("--margin", type=float, default=1.5,
                    help="required clearance margin [m] (ISO 19902: 1.5)")
    ag.add_argument("--phase-steps", type=int, default=360)
    ag.set_defaults(fn=cmd_air_gap)

    se = sub.add_parser("seismic",
                        help="response-spectrum earthquake check "
                             "(modal CQC, EC8-shape or site spectrum)")
    _add_common(se)
    se.add_argument("--pga-g", type=float, default=0.2,
                    help="design peak ground acceleration [g]")
    se.add_argument("--ground", default="A", choices=list("ABCDE"),
                    help="EC8 Type-1 ground class")
    se.add_argument("--zeta", type=float, default=0.05,
                    help="modal damping ratio")
    se.add_argument("--n-modes", type=int, default=12)
    se.add_argument("--topside-mass", type=float, default=1100.0,
                    help="lumped deck mass [tonnes]")
    se.add_argument("--added-mass", type=float, default=None,
                    help="hydrodynamic added-mass coefficient Ca (= Cm - 1)")
    se.add_argument("--vertical", action="store_true",
                    help="add the vertical excitation direction "
                         "(EC8 vertical spectrum)")
    se.add_argument("--spectrum-file", default=None,
                    help="CSV of site-specific T[s],Sa[m/s^2] rows "
                         "(overrides the parametric shape)")
    se.add_argument("--combination", default="cqc",
                    choices=["cqc", "srss"], help="modal combination")
    se.add_argument("--dir-rule", default="srss",
                    choices=["srss", "100-40-40"],
                    help="direction combination")
    se.add_argument("--refine", type=int, default=1,
                    help="subdivide members (>1 uses the Craig-Bampton "
                         "reduced path; demands on the full refined mesh)")
    se.add_argument("--chain-modes", type=int, default=12,
                    help="retained fixed-interface modes per member chain")
    _add_spring_arg(se)
    se.set_defaults(fn=cmd_seismic)

    pl = sub.add_parser("pile",
                        help="pile-head springs from API p-y/t-z/Q-z "
                             "soil curves (feeds the SSI spring supports; "
                             "beyond the reference's scope)")
    _add_common(pl)
    pl.add_argument("--soil", help="soil profile JSON (file or literal "
                                   "list of layer dicts: kind sand/clay/"
                                   "linear, z_top, z_bot, su_kPa, phi_deg, "
                                   "gamma_kN_m3, ...)")
    pl.add_argument("--pile-D", type=float, default=2134.0,
                    help="pile OD [mm]")
    pl.add_argument("--pile-t", type=float, default=50.0,
                    help="pile wall [mm]")
    pl.add_argument("--pile-L", type=float, default=60.0,
                    help="pile penetration below mudline [m]")
    pl.add_argument("--pile-n", type=int, default=64,
                    help="pile discretization elements")
    pl.add_argument("--unplugged", action="store_true",
                    help="annulus tip area instead of plugged full circle")
    pl.add_argument("--pile-H", type=float, default=2000.0,
                    help="lateral working load per pile [kN]")
    pl.add_argument("--pile-V", type=float, default=15000.0,
                    help="axial working load per pile [kN]")
    pl.add_argument("--pile-M", type=float, default=0.0,
                    help="head working moment [kNm] (0 = auto probe)")
    pl.add_argument("--scour", type=float, default=0.0,
                    help="general scour depth [m]: the top metres carry "
                         "no soil; overburden measured from the scoured "
                         "surface")
    pl.add_argument("--from-analysis", action="store_true",
                    help="take per-support working loads from a clamped "
                         "analysis of this load case")
    pl.add_argument("--analyze", action="store_true",
                    help="run the load case on the computed springs "
                         "(analyze_ssi) and print the report")
    pl.set_defaults(fn=cmd_pile)

    sd = sub.add_parser("save-default", help="write default jacket JSON")
    sd.add_argument("out")
    sd.add_argument("--z-water-ref", type=float, default=47.0)
    _add_device_arg(sd)
    sd.set_defaults(fn=cmd_save_default)

    args = ap.parse_args(argv)
    args.device = _resolve_device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
