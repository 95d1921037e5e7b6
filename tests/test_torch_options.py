"""PyTorch port vs the JAX package: model and load options (member end
releases, appurtenances, still-water buoyancy, wind, foundation springs)
on the dense and the condensed paths.  f64 on the CPU, the default jacket
and refinements of 2-3 segments; max |port - JAX| / max |JAX| <= 1e-10
per field unless a test says otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu import api as japi
from small_fem_solver_tpu.ops import beams as jbeams
from small_fem_solver_tpu.ops import morison as jmorison
from small_fem_solver_tpu.ops import solve as jsolve
from small_fem_solver_tpu.ops import wind as jwind
from small_fem_solver_tpu.ops.sections import tube_sections as j_sections
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import api as tapi
from small_fem_solver_tpu_torch.ops import beams as tbeams
from small_fem_solver_tpu_torch.ops import morison as tmorison
from small_fem_solver_tpu_torch.ops import solve as tsolve
from small_fem_solver_tpu_torch.ops import wind as twind
from test_torch_convert import (port_case, port_model, port_prepared,
                                port_wave, rel_err)

TOL = 1e-10
STORM = dict(wave_dir_deg=38.0, current_dir_deg=120.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom",
             t_analysis=0.34)
SPRINGS = [1e6, 1e6, 1e6, 1e12, 1e12, 1e12]
# two conductors between leg nodes (tests/test_appurtenances.py's specs)
APPS = [{"name": "C1", "node1": "A2", "node2": "A3", "D_mm": 700.0,
         "cd_mult": 0.8, "cm_mult": 1.1},
        {"name": "RISER-B", "node1": "B1", "node2": "B2", "D_mm": 610.0,
         "cd_mult": 1.05, "cm_mult": 0.95}]
OPTIONS = {
    "none": {},
    "buoyancy": dict(buoyancy="legs-flooded", sw_mode="calculated"),
    "wind": dict(wind_speed_ms=40.0, wind_dir_deg=38.0,
                 wind_topside_area_m2=800.0),
    "all": dict(buoyancy="sealed", wind_speed_ms=40.0, wind_dir_deg=200.0,
                wind_topside_area_m2=800.0, marine_growth_mm=50.0),
}


def _members(jm, pin_hbraces):
    """The reference-style member list of a JAX model, h-braces pinned."""
    conn = np.asarray(jm.conn)
    return [{"name": jm.member_names[e],
             "node1": jm.node_names[conn[e, 0]],
             "node2": jm.node_names[conn[e, 1]],
             "type": jm.member_types[e],
             "release": ("pinned" if pin_hbraces
                         and jm.member_types[e] == "h_brace" else "none")}
            for e in range(jm.n_members)]


@pytest.fixture(scope="module")
def jackets():
    """{name: (JAX model, port model)}: the default jacket, with pinned
    h-braces ('pinned'), with two conductors ('apps'), and with both
    ('options')."""
    base = sf.default_3leg_jacket()
    nodes = {n: tuple(np.asarray(base.coords)[i])
             for i, n in enumerate(base.node_names)}
    pinned = sf.build_model(nodes, _members(base, True),
                            base.fixed_node_names(), base.top_node_names())
    out = {"plain": base, "pinned": pinned,
           "apps": sf.add_appurtenances(base, APPS),
           "options": sf.add_appurtenances(pinned, APPS)}
    return {k: (m, port_model(m)) for k, m in out.items()}


@pytest.fixture(scope="module")
def waves():
    jw = sf.make_wave(12.0, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    return jw, port_wave(jw)


def _assert_fields(out, ref, fields, tol=TOL):
    for f in fields:
        assert rel_err(getattr(out, f), getattr(ref, f)) < tol, f


RESULT_FIELDS = ("U", "reactions", "F_applied", "F1_local", "F2_local",
                 "von_mises", "utilization", "total_reaction")


# ---------------------------------------------------------------------------
# Model options
# ---------------------------------------------------------------------------

def test_release_transform_and_apply_releases_match_jax():
    """W and the released K_local against JAX for every code, lengths and
    sections mixed; released rows and columns exactly zero; W W = W."""
    L = np.array([12000.0, 4500.0, 23000.0, 8000.0, 30000.0, 600.0])
    sid = np.array([0, 1, 1, 0, 1, 0])
    codes = np.array([0, 1, 2, 3, 3, 1])
    E, G = 210000.0, 210000.0 / 2.6
    jsec = j_sections(jnp.asarray([2000.0, 800.0]), jnp.asarray([75.0, 30.0]))
    tsec = pt.tube_sections([2000.0, 800.0], [75.0, 30.0], device="cpu")
    jK = jbeams.local_stiffness(jnp.asarray(L), jsec, jnp.asarray(sid), E, G)
    tK = tbeams.local_stiffness(torch.tensor(L), tsec, torch.tensor(sid), E,
                                G)
    assert rel_err(tK, jK) < 1e-14
    W = tbeams.release_transform(tK, torch.tensor(codes))
    assert rel_err(W, jbeams.release_transform(jK, jnp.asarray(codes))) < TOL
    Kc = tbeams.apply_releases(tK, torch.tensor(codes))
    assert rel_err(Kc, jbeams.apply_releases(jK, jnp.asarray(codes))) < TOL
    for m, code in enumerate(codes):
        rel = np.nonzero(tbeams._REL_MASKS[code])[0]
        assert torch.all(Kc[m, rel] == 0.0) and torch.all(Kc[m, :, rel] == 0.0)
        assert rel_err(W[m] @ W[m], W[m]) < 1e-9
    assert torch.equal(Kc[0], tK[0])   # code 0 leaves the element as it is
    coords = np.array([[0.0, 0.0, -40.0], [3.0, 4.0, -10.0],
                       [20.0, 1.0, 5.0]])
    conn = np.array([[0, 1], [1, 2], [0, 2]])
    args = (np.array([0, 1, 1]), E, G, np.array([3, 1, 2]))
    assert rel_err(
        tbeams.release_W(torch.tensor(coords), torch.tensor(conn), tsec,
                         *(torch.tensor(a) if isinstance(a, np.ndarray)
                           else a for a in args)),
        jbeams.release_W(jnp.asarray(coords), jnp.asarray(conn), jsec,
                         *(jnp.asarray(a) if isinstance(a, np.ndarray)
                           else a for a in args))) < TOL


def test_build_model_releases_match_jax(jackets):
    """Release codes, their refinement onto the end segments, and the
    validation of build_model, as in the JAX package."""
    jm, tm = jackets["pinned"]
    base = jackets["plain"][0]
    nodes = {n: tuple(np.asarray(base.coords)[i])
             for i, n in enumerate(base.node_names)}
    built = pt.build_model(nodes, _members(base, True),
                           base.fixed_node_names(), base.top_node_names(),
                           device="cpu")
    np.testing.assert_array_equal(built.release.numpy(),
                                  np.asarray(jm.release))
    assert pt.build_model(nodes, _members(base, False), ["A1", "B1", "C1"],
                          ["A4"], device="cpu").release is None
    members = _members(base, False)
    members[0]["release"] = "pinned1"
    members[-1]["release"] = "pinned2"
    tr = pt.refine_model(pt.build_model(nodes, members, ["A1", "B1", "C1"],
                                        ["A4"], device="cpu"), 3)
    jr = sf.refine_model(sf.build_model(nodes, members, ["A1", "B1", "C1"],
                                        ["A4"]), 3)
    np.testing.assert_array_equal(tr.release.numpy(), np.asarray(jr.release))
    one = [{"name": "m", "node1": "A", "node2": "B", "release": "pinned"}]
    with pytest.raises(ValueError, match="ONLY pinned"):
        pt.build_model({"A": (0, 0, 0), "B": (10, 0, 0)}, one, ["A"], ["B"],
                       device="cpu")
    with pytest.raises(ValueError, match="unknown member release"):
        pt.build_model({"A": (0, 0, 0), "B": (10, 0, 0)},
                       [{**one[0], "release": "hinged"}], ["A"], ["B"],
                       device="cpu")


def test_appurtenances_and_hydro_members_match_jax(jackets):
    jm, tm = jackets["options"]
    made = pt.add_appurtenances(jackets["pinned"][1], APPS)
    assert made.n_appurtenances == 2 and made.app_names == ("C1", "RISER-B")
    for name in ("app_conn", "app_D_mm", "app_cd_mult", "app_cm_mult"):
        np.testing.assert_array_equal(getattr(made, name).numpy(),
                                      np.asarray(getattr(jm, name)))
    assert pt.add_appurtenances(tm, []) is tm
    for bad, err in (({"D_mm": -5.0}, ValueError),
                     ({"cd_mult": -1.0}, ValueError),
                     ({"node1": "NOSUCH"}, KeyError)):
        with pytest.raises(err):
            pt.add_appurtenances(tm, [{**APPS[0], **bad}])
    for growth in (0.0, 50.0):
        ref = jmorison.hydro_members(jm, growth, 0.7, 2.0)
        out = tmorison.hydro_members(made, growth, 0.7, 2.0)
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        for a, b in zip(out[1:], ref[1:]):
            assert a.shape == (tm.n_members + 2,)
            assert rel_err(a, b) < 1e-15
    plain = tmorison.hydro_members(jackets["plain"][1], 0.0, 0.7, 2.0)
    assert plain[2] == 0.7 and plain[3] == 2.0


def test_wind_matches_jax(jackets):
    jm, tm = jackets["plain"]
    D = tm.sections.D_outer[tm.sect_id] / 1000.0
    jD = jm.sections.D_outer[jm.sect_id] / 1000.0
    for ref, out in zip(
            jwind.wind_member_ends(jm.coords, jm.conn, jD, 40.0, 38.0),
            twind.wind_member_ends(tm.coords, tm.conn, D, 40.0, 38.0)):
        assert rel_err(out, ref) < TOL
    ref = jwind.wind_member_forces(jm.coords, jm.conn, jD, 35.0, 200.0,
                                   Cs=0.7)
    out = twind.wind_member_forces(tm.coords, tm.conn, D, 35.0, 200.0, Cs=0.7)
    assert rel_err(out[0], ref[0]) < TOL and rel_err(out[1], ref[1]) < TOL
    z = np.array([-3.0, 0.05, 10.0, 80.0])
    assert rel_err(pt.wind_profile(40.0, torch.tensor(z)),
                   jwind.wind_profile(40.0, jnp.asarray(z))) < 1e-15
    assert abs(float(pt.wind_topside_force(40.0, 500.0, 80.0, Cs=1.1))
               / float(jwind.wind_topside_force(40.0, 500.0, 80.0, Cs=1.1))
               - 1.0) < 1e-15


@pytest.mark.parametrize("mode", ["sealed", "flooded", "legs-flooded"])
def test_member_buoyancy_matches_jax(jackets, mode):
    """Uplift and wetted-span centroid per member, on the coarse jacket and
    a 3x refinement (members that cross the surface, lie below it and
    above it)."""
    for n_seg in (1, 3):
        jm = sf.refine_model(jackets["plain"][0], n_seg)
        tm = port_model(jm)
        L = torch.linalg.norm(tm.coords[tm.conn[:, 1]]
                              - tm.coords[tm.conn[:, 0]], dim=-1)
        ref = japi._member_buoyancy(jm.coords, jm.conn, jm.sections,
                                    jm.sect_id, jm.member_types, 1025.0, mode,
                                    jnp.asarray(L.numpy()))
        out = tapi._member_buoyancy(tm.coords, tm.conn, tm.sections,
                                    tm.sect_id, tm.member_types, 1025.0, mode,
                                    L)
        assert rel_err(out[0], ref[0]) < TOL and rel_err(out[1], ref[1]) < TOL
    with pytest.raises(ValueError, match="unknown buoyancy"):
        tapi._member_buoyancy(tm.coords, tm.conn, tm.sections, tm.sect_id,
                              tm.member_types, 1025.0, "porous", L)


# ---------------------------------------------------------------------------
# Dense paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model,options", [
    ("pinned", "none"), ("apps", "none"), ("plain", "buoyancy"),
    ("plain", "wind"), ("options", "all")])
def test_analyze_with_options_matches_jax(jackets, waves, model, options):
    jm, tm = jackets[model]
    jw, tw = waves
    case = sf.LoadCase(**{**STORM, **OPTIONS[options]})
    ref = sf.analyze(jm, jw, case, solver="chol")
    out = pt.analyze(tm, tw, port_case(case), solver="chol")
    _assert_fields(out, ref, RESULT_FIELDS)
    for f in ("member_drag", "member_inertia", "total_morison"):
        assert rel_err(getattr(out.morison, f),
                       getattr(ref.morison, f)) < TOL, f


def test_analyze_ssi_and_spring_validation_match_jax(jackets, waves):
    jm, tm = jackets["options"]
    jw, tw = waves
    case = sf.LoadCase(**{**STORM, **OPTIONS["all"]})
    ref = sf.analyze_ssi(jm, jw, case, SPRINGS)
    out = pt.analyze_ssi(tm, tw, port_case(case), SPRINGS)
    _assert_fields(out, ref, RESULT_FIELDS)
    u_sup = out.U.reshape(-1, 6)[tm.fixed_mask]
    assert rel_err(out.reactions, -torch.tensor(SPRINGS) * u_sup) < 1e-8
    col = pt.build_model({"BASE": (0.0, 0.0, 0.0), "TIP": (0.0, 0.0, 20.0)},
                         [{"name": "COL", "node1": "BASE", "node2": "TIP",
                           "type": "leg"}], ["BASE"], ["TIP"], device="cpu")
    for fixed, k, match in (
            (tm.fixed_mask, [-1e6, 1e6, 1e6, 1e12, 1e12, 1e12], ">= 0"),
            (tm.fixed_mask, [np.nan, 1e7, 1e7, 1e12, 1e12, 1e12], "finite"),
            (tm.fixed_mask, [0.0] * 6, "float"),
            (col.fixed_mask, [1e7, 1e7, 1e7, 0.0, 0.0, 0.0],
             "SINGLE support"),
            (torch.zeros(3, dtype=torch.bool), SPRINGS, "at least one")):
        with pytest.raises(ValueError, match=match):
            tsolve.support_spring_nodes(fixed, k)
        with pytest.raises(ValueError, match=match):
            jsolve.support_spring_nodes(np.asarray(fixed), k)
    per_node = np.array([SPRINGS, [2e6] * 3 + [1e11] * 3, [0.0] * 6])
    per_node[2, :3] = 5e5
    np.testing.assert_array_equal(
        tsolve.support_spring_nodes(tm.fixed_mask, per_node),
        jsolve.support_spring_nodes(np.asarray(jm.fixed_mask), per_node))


# ---------------------------------------------------------------------------
# Condensed paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def options_refined(jackets):
    """The options jacket refined 2x in both packages."""
    jc, tc = jackets["options"]
    jr = sf.refine_model(jc, 2)
    return jc, jr, tc, port_model(jr)


@pytest.mark.parametrize("springs", [None, SPRINGS])
def test_analyze_condensed_with_options_matches_jax(options_refined, waves,
                                                    springs):
    """Releases on the chain ends, appurtenance loads on their guide nodes,
    buoyancy and wind over the refined mesh, springs on the interface
    factorization: analyze_condensed against JAX, the prepared handle
    (and the JAX handle carried over) equal to it, and the port's dense
    analysis of the refined mesh within 1e-9."""
    jc, jr, tc, tr = options_refined
    jw, tw = waves
    case = sf.LoadCase(**{**STORM, **OPTIONS["all"]})
    tcase = port_case(case)
    ref = sf.analyze_condensed(jc, jr, 2, jw, case, support_stiffness=springs)
    out = pt.analyze_condensed(tc, tr, 2, tw, tcase,
                               support_stiffness=springs)
    _assert_fields(out, ref, RESULT_FIELDS)
    prep = pt.prepare_condensed(tc, tr, 2, support_stiffness=springs)
    two = pt.analyze_prepared(prep, tw, tcase)
    for f in ("U", "reactions", "von_mises"):
        assert torch.equal(getattr(two, f), getattr(out, f)), f
    jprep = japi.prepare_condensed(jc, jr, 2, support_stiffness=springs)
    _assert_fields(pt.analyze_prepared(port_prepared(jprep, tc, tr), tw,
                                       tcase), ref, RESULT_FIELDS)
    dense = (pt.analyze(tr, tw, tcase, accel="analytic") if springs is None
             else pt.analyze_ssi(tr, tw, tcase, springs, accel="analytic"))
    _assert_fields(out, dense, ("U", "reactions", "utilization",
                                "F_applied"), tol=1e-9)


@pytest.mark.parametrize("kinematics", ["separable", "pointwise"])
def test_phase_scan_with_options_matches_jax(options_refined, waves,
                                             kinematics):
    """The condensed scan with every option and springs, both load paths;
    the prepared scan equals the one-shot scan."""
    jc, jr, tc, tr = options_refined
    jw, tw = waves
    case = sf.LoadCase(**{**STORM, **OPTIONS["all"]})
    ref = sf.phase_scan_condensed(jc, jr, 2, jw, case, n_steps=6,
                                  kinematics=kinematics,
                                  support_stiffness=SPRINGS)
    out = pt.phase_scan_condensed(tc, tr, 2, tw, port_case(case), n_steps=6,
                                  kinematics=kinematics,
                                  support_stiffness=SPRINGS)
    _assert_fields(out, ref, ("ts", "U", "von_mises", "utilization",
                              "reactions", "total_morison"))
    assert int(out.critical_index) == int(ref.critical_index)
    prep = pt.prepare_condensed(tc, tr, 2, support_stiffness=SPRINGS)
    again = pt.phase_scan_prepared(prep, tw, port_case(case), n_steps=6,
                                   kinematics=kinematics)
    assert torch.equal(again.U, out.U)


def test_design_envelope_condensed_with_options_matches_jax(options_refined):
    """The condensed envelope with every option and springs: 1e-9 (the
    port runs one refinement round the JAX envelope lacks)."""
    jc, jr, tc, tr = options_refined
    from small_fem_solver_tpu.parallel import sweep as jsweep
    jw = jsweep.make_wave_batch([6.0, 12.0], 9.4, 50.0, U_c=1.2,
                                model="airy", n_modes=2, dtype=jnp.float64)
    cases = jsweep.make_case_batch(
        sf.LoadCase(**{**STORM, **OPTIONS["all"]}),
        wave_dir_deg=jnp.asarray([0.0, 38.0]))
    ref = sf.design_envelope_condensed(jc, jr, 2, jw, cases, n_steps=4,
                                       solve_dtype=jnp.float64,
                                       support_stiffness=SPRINGS)
    out = pt.design_envelope_condensed(tc, tr, 2, port_wave(jw),
                                       port_case(cases), n_steps=4,
                                       solve_dtype=torch.float64,
                                       kinematics="separable",
                                       support_stiffness=SPRINGS)
    _assert_fields(out, ref, ("ts", "max_util_per_phase", "max_util_per_case",
                              "member_envelope", "total_morison"), tol=1e-9)
    assert int(out.governing_case) == int(ref.governing_case)


def test_prepared_cache_keys_on_support_stiffness(jackets, waves):
    """A sprung scan that follows a clamped one on the same model objects
    gets the sprung answer (the JAX one), not the cached clamped
    factorization."""
    jc, tc = jackets["plain"]
    jr = sf.refine_model(jc, 2)
    tr = port_model(jr)
    jw, tw = waves
    case = sf.LoadCase(**STORM)
    clamped = pt.phase_scan_condensed(tc, tr, 2, tw, port_case(case),
                                      n_steps=2, kinematics="separable")
    sprung = pt.phase_scan_condensed(tc, tr, 2, tw, port_case(case),
                                     n_steps=2, kinematics="separable",
                                     support_stiffness=SPRINGS)
    ref = sf.phase_scan_condensed(jc, jr, 2, jw, case, n_steps=2,
                                  kinematics="separable",
                                  support_stiffness=SPRINGS)
    assert rel_err(sprung.U, ref.U) < TOL
    assert rel_err(sprung.reactions, ref.reactions) < TOL
    assert rel_err(sprung.U, clamped.U) > 1e-3
