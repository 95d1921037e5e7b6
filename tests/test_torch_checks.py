"""PyTorch port vs the JAX package: the code-check tier, ``ops/codecheck.py``
(API RP 2A-WSD members), ``ops/codecheck_iso.py`` (ISO 19902 members),
``ops/jointcheck.py`` (API joints), ``ops/viv.py``, ``ops/airgap.py`` and
``utils/combos.py``.

The checks read an analysis result: both packages check the same one,
JAX's storm analysis of the default jacket carried over with
``convert.results_from_numpy``; the port's own analysis of the storm
feeds the combinations.  Every array against JAX in f64 on the CPU at
1e-12 (max |port - JAX| / max |JAX|; these are closed forms of the end
forces), governing labels, flags and indices exactly."""
import jax
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import airgap as jag
from small_fem_solver_tpu.ops import codecheck as jcc
from small_fem_solver_tpu.ops import codecheck_iso as jiso
from small_fem_solver_tpu.ops import jointcheck as jjc
from small_fem_solver_tpu.ops import viv as jviv
from small_fem_solver_tpu.utils import combos as jcombos
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import convert
from small_fem_solver_tpu_torch.ops import codecheck as tcc
from small_fem_solver_tpu_torch.ops import codecheck_iso as tiso
from test_torch_convert import leaves, port_case, port_model, port_wave, \
    rel_err

TOL = 1e-12
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom",
             t_analysis=0.34)


def assert_same(out, ref):
    """Every field of a result tuple: labels and integer / boolean arrays
    exactly, the rest at TOL."""
    for f in ref._fields:
        a, b = getattr(out, f), getattr(ref, f)
        if isinstance(b, (float, int)):
            assert a == pytest.approx(b, rel=TOL, abs=0.0), f
            continue
        b = np.asarray(b)
        if b.dtype.kind in "biuUO":
            a = a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
            assert np.array_equal(a, b), f
        else:
            assert rel_err(a, b) < TOL, f


@pytest.fixture(scope="module")
def storm():
    """JAX's storm analysis of the default jacket and its port copy."""
    jm = sf.default_3leg_jacket()
    jw = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    jres = jax.jit(lambda: sf.analyze(jm, jw, sf.LoadCase(**STORM),
                                      solver="chol"))()
    return jm, jw, jres, port_model(jm), port_wave(jw), \
        convert.results_from_numpy(leaves(jres), device="cpu")


def test_allowables_match_jax():
    """The API and ISO representative strengths over D/t from 20 to 300
    (every range of 3.2.2-3.2.3 and 13.2.3-13.2.4) and KL/r from 10 to
    200 (inelastic and elastic columns)."""
    dt = np.linspace(20.0, 300.0, 57)
    klr = np.linspace(10.0, 200.0, 57)
    D, t = 1200.0 * np.ones(57), 1200.0 / dt
    for fy in (235.0, 355.0, 460.0):
        pairs = [
            (tcc.local_buckling_fxc(fy, 210000.0, dt),
             jcc.local_buckling_fxc(fy, 210000.0, dt)),
            (tcc.allowable_compression(fy, 210000.0, klr, dt),
             jcc.allowable_compression(fy, 210000.0, klr, dt)),
            (tcc.allowable_bending(fy, 210000.0, dt),
             jcc.allowable_bending(fy, 210000.0, dt)),
            (tcc.allowable_tension(fy), jcc.allowable_tension(fy)),
            (tiso.iso_bending_fb(fy, 210000.0, D, t),
             jiso.iso_bending_fb(fy, 210000.0, D, t))]
        pairs += list(zip(tiso.iso_column_fc(fy, 210000.0, klr, dt),
                          jiso.iso_column_fc(fy, 210000.0, klr, dt)))
        for out, ref in pairs:
            assert rel_err(out, ref) < TOL


def test_member_checks_match_jax(storm):
    """``member_code_check`` (API) and ``iso_member_check`` (ISO) on the
    storm analysis, default and with other yield, factors and lengths."""
    jm, _, jres, tm, _, tres = storm
    L = np.asarray(jres.length_m) * 0.9
    for kw in ({}, dict(Fy=460.0, K_leg=1.2, K_brace=0.7, Cm=0.6,
                        L_override=L)):
        assert_same(pt.member_code_check(tm, tres, **kw),
                    jcc.member_code_check(jm, jres, **kw))
        assert_same(pt.iso_member_check(tm, tres, **kw),
                    jiso.iso_member_check(jm, jres, **kw))


@pytest.mark.parametrize("joint_class", ["Y", "K", "X", "auto", "array"])
def test_joint_check_matches_jax(storm, joint_class):
    """``joint_code_check`` on the storm analysis for each fixed class,
    the API 4.2 load-path classification ('auto') and a per-joint class
    array; unknown classes raise as in JAX."""
    jm, _, jres, tm, _, tres = storm
    if joint_class == "array":
        n = len(jjc._find_joints(jm)[0])
        joint_class = np.array(["Y", "K", "X", "T"] * n)[:n]
    ref = jjc.joint_code_check(jm, jres, Fy=345.0, joint_class=joint_class,
                               gap_mm=80.0)
    out = pt.joint_code_check(tm, tres, Fy=345.0, joint_class=joint_class,
                              gap_mm=80.0)
    assert_same(out, ref)
    with pytest.raises(ValueError, match="unknown joint"):
        pt.joint_code_check(tm, tres, joint_class="Q")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(current_alpha=1.0 / 7.0, marine_growth_mm=50.0, flooded="legs",
         end_fixity="pinned", zeta=0.005, Ca=0.8),
    dict(flooded="all", U_c=3.5)])
def test_viv_screen_matches_jax(storm, kw):
    """``viv_screen`` of the coarse jacket: uniform and power-law current,
    marine growth, flooding and end fixity; the flags exactly."""
    jm, _, _, tm, _, _ = storm
    U_c = kw.pop("U_c", 1.7)
    assert_same(pt.viv_screen(tm, U_c, 50.0, **kw),
                jviv.viv_screen(jm, U_c, 50.0, **kw))


@pytest.mark.parametrize("theory", ["airy", "stokes"])
def test_air_gap_matches_jax(storm, theory):
    """``air_gap_check`` under the Airy storm and its Stokes-5 wave, with
    surge and tide and an explicit deck (the governing phase and point
    exactly, the crest and gap 1e-12)."""
    jm, jw, _, tm, tw, _ = storm
    if theory == "stokes":
        jw = sf.stokes_wave(17.038, 9.4, 50.0, 1.7, order=5)
        tw = port_wave(jw)
    for kw in (dict(wave_dir_deg=38.0), dict(
            wave_dir_deg=200.0, deck_elevation_m=12.0, surge_m=0.6,
            tide_m=1.1, margin_m=2.0, n_phases=90, n_x=33)):
        assert_same(pt.air_gap_check(tm, tw, **kw),
                    jag.air_gap_check(jm, jw, **kw))


def test_combinations_match_jax(storm):
    """``combo_envelope`` of three characteristic actions (the storm, the
    topside alone, a second heading of the environment) in the ISO and
    WSD factor sets: every combined field, the member envelope, the
    governing combinations (exactly) against JAX's on the same three
    results; and the port's own analyses feed ``combine_results``."""
    jm, jw, jres, tm, tw, tres = storm
    cases = [sf.LoadCase(F_axial_kN=25100.0, sw_mode="none"),
             sf.LoadCase(**{**STORM, "wave_dir_deg": 128.0,
                            "current_dir_deg": 128.0,
                            "custom_sw_tonnes": 0.0})]
    jacts = {"E": jres}
    for name, c in zip(("G", "E2"), cases):
        jacts[name] = jax.jit(lambda c=c: sf.analyze(jm, jw, c,
                                                     solver="chol"))()
    tacts = {k: convert.results_from_numpy(leaves(v), device="cpu")
             for k, v in jacts.items()}
    combos = {"iso_extreme": {"G": 1.1, "E": 1.35},
              "iso_operating": {"G": 1.3, "E": 0.9, "E2": 0.9},
              "wsd": {"G": 1.0, "E": 1.0, "E2": 1.0}}
    jout, jenv = jcombos.combo_envelope(jm, jacts, combos)
    out, env = pt.combo_envelope(tm, tacts, combos)
    for k in combos:
        for f in ("U", "reactions", "F_applied", "F1_local", "F2_local",
                  "von_mises", "utilization", "max_displacement_mm",
                  "total_reaction"):
            assert rel_err(getattr(out[k], f), getattr(jout[k], f)) < TOL
        assert int(out[k].max_displacement_node) == int(
            jout[k].max_displacement_node)
        assert out[k].solver_iters is None
    assert rel_err(env["member_envelope"], jenv["member_envelope"]) < TOL
    assert np.array_equal(env["governing_combo"].numpy(),
                          np.asarray(jenv["governing_combo"]))
    assert env["governing"] == jenv["governing"]
    assert env["combo_names"] == jenv["combo_names"]
    own = [pt.analyze(tm, tw, port_case(c), solver="chol")
           for c in [sf.LoadCase(**STORM)] + cases]
    comb = pt.combine_results(tm, own, [1.0, 1.0, 1.0])
    assert rel_err(comb.U, out["wsd"].U) < 1e-10
    with pytest.raises(ValueError, match="unknown"):
        pt.combo_envelope(tm, tacts, {"bad": {"W": 1.0}})
    with pytest.raises(ValueError, match="factors"):
        pt.combine_results(tm, own, [1.0])
