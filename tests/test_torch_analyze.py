"""The port's reference analysis (``analyze``, ``analyze_phase_batch``), its
condensed single-phase analyses (``analyze_condensed``,
``analyze_prepared``) and the pointwise condensed scan (f64, CPU):

- against the six JSON goldens of the reference at 1e-8 (the singular
  case's least-squares fallback at 1e-6), as ``tests/test_end_to_end.py``
  holds the JAX package;
- against the JAX package on the same inputs at 1e-10 (max |port - JAX| /
  max |JAX| per field);
- against the port's own dense solve and separable scan.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import analyze_prepared as j_analyze_prepared
from small_fem_solver_tpu.api import prepare_condensed as j_prepare
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.models import autogen
from test_torch_convert import (port_case, port_model, port_prepared,
                                port_wave, rel_err)

TOL = 1e-10
GOLDENS = ["default", "variant", "shallow", "singular", "custom_tower",
           "autogen_4leg"]
STORM = dict(wave_dir_deg=38.0, current_dir_deg=120.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom",
             t_analysis=0.34)


# ---------------------------------------------------------------------------
# The reference's goldens
# ---------------------------------------------------------------------------

def _golden_case(p):
    return pt.LoadCase(
        E=p["E"], nu=p["nu"], fy=p["fy"], rho_water=p["rho_water"],
        wave_dir_deg=p["wave_dir"], current_dir_deg=p["current_dir"],
        Cd=p["Cd"], Cm=p["Cm"], F_axial_kN=p["F_axial_kN"],
        F_shear_kN=p["F_shear_kN"], M_moment_kNm=p["M_moment_kNm"],
        M_torsion_kNm=p["M_torsion_kNm"],
        custom_sw_tonnes=p.get("custom_sw_tonnes", 0.0),
        t_analysis=p["t_analysis"], sw_mode=p["sw_mode"])


def _golden_setup(g):
    """(model, wave, case) of a golden, on the CPU."""
    p = g["params"]
    sections = dict(leg_section=(p["D_leg"], p["t_leg"]),
                    brace_section=(p["D_brace"], p["t_brace"]),
                    rho_steel=p["rho_steel"])
    if "geometry" in g:
        geom = g["geometry"]
        model = pt.build_model({k: tuple(v) for k, v in geom["nodes"].items()},
                               geom["members"], geom["fixed"], geom["top"],
                               **sections, device="cpu")
    else:
        model = pt.default_3leg_jacket(**sections, device="cpu")
    wave = pt.airy_wave(p["H"], p["T"], p["d"], p["U_c"], device="cpu")
    return model, wave, _golden_case(p)


def _close(ours, ref, tol):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_analysis_matches_reference(name, request):
    """Load vector, displacements (LU and Cholesky), reactions, member end
    forces, von Mises, utilization, lengths and the largest displacement
    against the reference's recorded numbers; equilibrium.  The singular
    case (an orphan node) runs the least-squares fallback: 1e-6, and the
    orphan's DOFs exactly 0."""
    g = request.getfixturevalue(f"golden_{name}")
    fem = g["fem"]
    model, wave, case = _golden_setup(g)
    singular = name == "singular"
    tol = 1e-6 if singular else 1e-8
    if name == "autogen_4leg":
        nodes = g["geometry"]["nodes"]
        ours = autogen.auto_generate_h_braces(
            nodes, autogen.auto_generate_legs(nodes, []))
        assert ours == [{k: m[k] for k in ("name", "node1", "node2", "type")}
                        for m in g["geometry"]["members"]]
    for solver in ("lu",) if singular else ("lu", "chol"):
        res = pt.analyze(model, wave, case, solver=solver,
                         lstsq_fallback=singular)
        assert res.U.dtype == torch.float64 and res.U.device.type == "cpu"
        _close(res.F_applied, fem["F_global"], 1e-8)
        _close(res.U, fem["U"], tol)
        _close(res.reactions, [fem["reactions"][n]
                               for n in model.fixed_node_names()], tol)
        ref_if = fem["internal_forces"]
        assert [m["member"] for m in ref_if] == list(model.member_names)
        for col, key, scale in [(0, "Fx_max_kN", 1e3), (1, "Fy_max_kN", 1e3),
                                (2, "Fz_max_kN", 1e3), (4, "My_max_kNm", 1e6),
                                (5, "Mz_max_kNm", 1e6)]:
            ours = torch.maximum(res.F1_local[:, col].abs(),
                                 res.F2_local[:, col].abs()) / scale
            _close(ours, [m[key] for m in ref_if], tol)
        for field, key in (("von_mises", "von_mises_max_MPa"),
                           ("utilization", "utilization")):
            np.testing.assert_allclose(
                getattr(res, field).numpy(), [m[key] for m in ref_if],
                rtol=tol, atol=tol * max(m[key] for m in ref_if))
        _close(res.length_m, [m["length_m"] for m in ref_if], 1e-10)
        disp = np.linalg.norm(np.array(fem["U"]).reshape(-1, 6)[:, :3],
                              axis=1)
        assert int(res.max_displacement_node) == int(np.argmax(disp))
        assert abs(float(res.max_displacement_mm) / disp.max() - 1) < tol
        if singular:
            orphan = model.node_index("ZZ_ORPHAN")
            assert torch.all(res.U.reshape(-1, 6)[orphan] == 0.0)
        else:
            F = res.F_applied.reshape(-1, 6)[:, :3].sum(dim=0)
            eq = (res.total_reaction[:3] + F).abs().max() / F.abs().max()
            assert float(eq) <= 1e-9


@pytest.mark.parametrize("name", GOLDENS)
def test_golden_phase_scan_matches_reference(name, request):
    """The reference's informational 36-step Morison phase scan: totals and
    the critical time."""
    g = request.getfixturevalue(f"golden_{name}")
    p, ref = g["params"], g["phase_scan"]
    model, wave, _ = _golden_setup(g)
    D = model.sections.D_outer[model.sect_id] / 1000.0
    scan = pt.phase_scan(wave, model.coords, model.conn, D, p["wave_dir"],
                         p["current_dir"], p["Cd"], p["Cm"], p["rho_water"],
                         n_steps=len(ref["t"]))
    for field in ("t", "total_kN", "drag_kN", "inertia_kN"):
        _close(getattr(scan, field), ref[field], 1e-8)
    crit_t = float(scan.t[int(scan.critical_index)])
    assert crit_t == pytest.approx(ref["critical_t"], abs=1e-12)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def storm():
    """The default jacket and its 4x refinement, a Fenton N = 12 and a
    Stokes storm wave, in the JAX package and the port."""
    jc = sf.default_3leg_jacket()
    jr = sf.refine_model(jc, 4)
    waves = {"fenton": sf.make_wave(17.038, 9.4, 50.0, U_c=1.7,
                                    model="fenton", N=12),
             "stokes": sf.make_wave(12.0, 9.4, 50.0, U_c=1.2,
                                    model="stokes", N=5)}
    return (jc, jr, waves, port_model(jc), port_model(jr),
            {k: port_wave(w) for k, w in waves.items()})


def _assert_results(out, ref, tol=TOL):
    for f in pt.AnalysisResults._fields:
        if f == "morison":
            for g in pt.MorisonLoads._fields:
                assert rel_err(getattr(out.morison, g),
                               getattr(ref.morison, g)) < tol, g
        elif getattr(ref, f) is None:
            assert getattr(out, f) is None, f
        elif f == "max_displacement_node":
            assert torch.equal(out.max_displacement_node, torch.tensor(
                np.array(ref.max_displacement_node)))
        else:
            assert getattr(out, f).shape == np.shape(getattr(ref, f)), f
            assert rel_err(getattr(out, f), getattr(ref, f)) < tol, f


@pytest.mark.parametrize("solver,wave,options,slam", [
    ("lu", "stokes", {}, 0.0),
    ("chol", "fenton", {}, 0.0),
    ("chol", "fenton", dict(accel="analytic", stretching="wheeler",
                            current_alpha=1.0 / 7.0), float(np.pi)),
])
def test_analyze_matches_jax(storm, solver, wave, options, slam):
    jc, _, jw, tc, _, tw = storm
    case = sf.LoadCase(**STORM, slam_cs=slam)
    ref = sf.analyze(jc, jw[wave], case, solver=solver, **options)
    out = pt.analyze(tc, tw[wave], port_case(case), solver=solver, **options)
    _assert_results(out, ref)


@pytest.mark.parametrize("accel", ["fd", "analytic"])
def test_analyze_phase_batch_matches_jax(storm, accel):
    jc, _, jw, tc, _, tw = storm
    case = sf.LoadCase(**STORM)
    ts_ref, ref = sf.analyze_phase_batch(jc, jw["fenton"], case, n_steps=8,
                                         accel=accel)
    ts, out = pt.analyze_phase_batch(tc, tw["fenton"], port_case(case),
                                     n_steps=8, accel=accel)
    assert rel_err(ts, ts_ref) < TOL
    _assert_results(out, ref)


@pytest.mark.parametrize("n_seg,solver", [(4, "thomas"), (4, "nested"),
                                          (8, "thomas"), (8, "nested")])
def test_analyze_condensed_matches_jax(storm, n_seg, solver):
    jc, jr, jw, tc, tr, tw = storm
    if n_seg != 4:
        jr = sf.refine_model(jc, n_seg)
        tr = port_model(jr)
    case = sf.LoadCase(**STORM)
    ref = sf.analyze_condensed(jc, jr, n_seg, jw["fenton"], case,
                               chain_solver=solver)
    out = pt.analyze_condensed(tc, tr, n_seg, tw["fenton"], port_case(case),
                               chain_solver=solver)
    _assert_results(out, ref)


def test_analyze_prepared_matches_jax_and_one_shot(storm):
    """The port's handle against JAX's analyze_prepared, the JAX handle
    carried over gives the same, and prepared == one-shot in the port."""
    jc, jr, jw, tc, tr, tw = storm
    case = sf.LoadCase(**{**STORM, "sw_mode": "calculated"})
    tcase = port_case(case)
    jprep = j_prepare(jc, jr, 4)
    ref = j_analyze_prepared(jprep, jw["fenton"], case, accel="fd")
    prep = pt.prepare_condensed(tc, tr, 4)
    _assert_results(pt.analyze_prepared(prep, tw["fenton"], tcase,
                                        accel="fd"), ref)
    _assert_results(pt.analyze_prepared(port_prepared(jprep, tc, tr),
                                        tw["fenton"], tcase, accel="fd"), ref)
    one = pt.analyze_condensed(tc, tr, 4, tw["fenton"], tcase, accel="fd")
    two = pt.analyze_prepared(prep, tw["fenton"], tcase, accel="fd")
    for f in ("U", "reactions", "von_mises", "F1_local", "F2_local"):
        assert torch.equal(getattr(one, f), getattr(two, f)), f
    with pytest.raises(ValueError, match="prepared factorization"):
        pt.analyze_prepared(prep, tw["fenton"], pt.LoadCase(nu=0.25))


def test_analyze_condensed_matches_dense(storm):
    """At small refinement the condensed analysis equals the port's dense
    Cholesky analysis of the refined model, every field."""
    _, _, _, tc, tr, tw = storm
    case = pt.LoadCase(**STORM)
    rc = pt.analyze_condensed(tc, tr, 4, tw["fenton"], case, accel="fd")
    rd = pt.analyze(tr, tw["fenton"], case, solver="chol", accel="fd")
    for f in ("U", "reactions", "von_mises", "utilization", "F1_local",
              "F2_local", "F_applied"):
        a, b = getattr(rc, f), getattr(rd, f)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()))


@pytest.mark.parametrize("accel", ["analytic", "fd"])
def test_pointwise_scan_matches_jax(storm, accel):
    jc, jr, jw, tc, tr, tw = storm
    case = sf.LoadCase(**STORM)
    ref = sf.phase_scan_condensed(jc, jr, 4, jw["fenton"], case, n_steps=8,
                                  kinematics="pointwise", accel=accel)
    out = pt.phase_scan_condensed(tc, tr, 4, tw["fenton"], port_case(case),
                                  n_steps=8, kinematics="pointwise",
                                  accel=accel)
    for f in ("ts", "U", "von_mises", "utilization", "reactions",
              "total_morison"):
        assert rel_err(getattr(out, f), getattr(ref, f)) < TOL, f
    assert int(out.critical_index) == int(ref.critical_index)


@pytest.mark.parametrize("model_name,N", [("airy", 1), ("stokes", 5),
                                          ("fenton", 12)])
def test_pointwise_scan_matches_separable(storm, model_name, N):
    """The pointwise and the separable load paths of the port's scan agree:
    exactly for Airy (1e-12), and for the clamped Stokes and Fenton waves up
    to the 1 cm evaluation band below the surface (2e-6), the JAX
    package's own limits (``tests/test_condense.py``).  The prepared handle
    runs the pointwise path too; slamming runs only there."""
    _, _, _, tc, tr, _ = storm
    wave = pt.make_wave(9.5, 9.4, 50.0, U_c=1.2, model=model_name, N=N,
                        device="cpu")
    case = pt.LoadCase(**{**STORM, "current_dir_deg": 120.0})
    sp = pt.phase_scan_condensed(tc, tr, 4, wave, case, n_steps=12,
                                 kinematics="separable")
    pw = pt.phase_scan_condensed(tc, tr, 4, wave, case, n_steps=12,
                                 kinematics="pointwise", accel="analytic")
    tol = 1e-12 if model_name == "airy" else 2e-6
    for f in ("U", "total_morison"):
        a, b = getattr(sp, f), getattr(pw, f)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=tol,
                                   atol=tol * float(b.abs().max()))
    prep = pt.prepare_condensed(tc, tr, 4)
    pp = pt.phase_scan_prepared(prep, wave, case, n_steps=12,
                                kinematics="pointwise")
    assert torch.equal(pp.U, pw.U)
    slam = dataclasses.replace(case, slam_cs=float(np.pi))
    with pytest.raises(ValueError, match="pointwise"):
        pt.phase_scan_prepared(prep, wave, slam, n_steps=2,
                               kinematics="separable")
    assert torch.isfinite(pt.phase_scan_prepared(
        prep, wave, slam, n_steps=2, kinematics="pointwise").U).all()


# ---------------------------------------------------------------------------
# Guards and defaults
# ---------------------------------------------------------------------------

def test_load_case_cast_resolves_the_default_device():
    """``LoadCase.cast`` without a device resolves it like every
    constructor: the card when there is one, else a RuntimeError that asks
    for device="cpu" (never a silent CPU default)."""
    case = pt.LoadCase(**STORM)
    if torch.cuda.is_available():
        assert case.cast(torch.float32).E.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            case.cast(torch.float32)
    cast = case.cast(torch.float32, "cpu")
    assert cast.E.dtype == torch.float32 and cast.E.device.type == "cpu"


def test_dense_solvers_ignore_pcg_options(storm):
    """As in the JAX package, 'lu' / 'chol' ignore pcg_tol, pcg_maxiter and
    pcg_chunk, and an unknown pcg_precond raises whatever the solver."""
    _, _, _, tc, _, tw = storm
    case = pt.LoadCase(**STORM)
    for solver in ("chol", "lu"):
        plain = pt.analyze(tc, tw["fenton"], case, solver=solver)
        opts = pt.analyze(tc, tw["fenton"], case, solver=solver,
                          pcg_precond="two_level", pcg_tol=1e-6,
                          pcg_maxiter=10, pcg_chunk=50)
        for f in ("U", "reactions", "utilization"):
            assert rel_err(getattr(opts, f), getattr(plain, f)) < 1e-14, f
    for solver in ("chol", "pcg"):
        with pytest.raises(ValueError, match="unknown pcg_precond 'bogus'"):
            pt.analyze(tc, tw["fenton"], case, solver=solver,
                       pcg_precond="bogus")


def test_analyze_guards(storm):
    _, _, _, tc, tr, tw = storm
    case = pt.LoadCase(**STORM)
    # solver="pcg" is ported (tests/test_torch_pcg.py): it runs and agrees
    # with the Cholesky solve
    pcg = pt.analyze(tc, tw["fenton"], case, solver="pcg")
    assert float(pcg.solver_residual) <= 1e-10
    assert rel_err(pcg.U, pt.analyze(tc, tw["fenton"], case).U) < 1e-8
    # mesh= takes a 1-D DeviceMesh (tests/test_torch_distributed.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.analyze(tc, tw["fenton"], case, solver="pcg", mesh=object())
    with pytest.raises(ValueError, match="unknown solver"):
        pt.analyze(tc, tw["fenton"], case, solver="qr")
    # buoyancy and foundation springs are ported: they hold against JAX
    jc, jr, jw = storm[:3]
    sealed = sf.LoadCase(**STORM, buoyancy="sealed")
    _assert_results(pt.analyze(tc, tw["fenton"], port_case(sealed)),
                    sf.analyze(jc, jw["fenton"], sealed))
    _assert_results(
        pt.analyze_condensed(tc, tr, 4, tw["fenton"], case,
                             support_stiffness=[1e9] * 6),
        sf.analyze_condensed(jc, jr, 4, jw["fenton"], sf.LoadCase(**STORM),
                             support_stiffness=[1e9] * 6))
    with pytest.raises(ValueError, match="accel"):
        pt.analyze(tc, tw["fenton"], case, accel="spline")
    waves = pt.make_wave_batch([8.0, 9.0], 9.4, 50.0, model="airy",
                               n_modes=1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="pointwise"):
        pt.design_envelope_condensed(tc, tr, 4, waves,
                                     pt.make_case_batch(case, wave_dir_deg=[0.0, 38.0]),
                                     n_steps=2, kinematics="pointwise")
