"""PyTorch port vs the JAX package: second-order analysis and buckling —
``analyze_pdelta``, ``analyze_pdelta_condensed``, ``ops.buckling``
(``element_geometric_stiffness``, ``buckling_analysis(_condensed)``,
``euler_member_screen``).  Mirrors ``tests/test_pdelta.py`` and
``tests/test_buckling.py``: the cantilever's Euler load and amplification,
the storm jacket (lambda_cr ~ 23), condensed against dense, and the port
against JAX in f64 on the CPU (max |port - JAX| / max |JAX| <= 1e-10).
JAX's eigen references run jitted (op by op they cost seconds a call)."""
import jax
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import beams as jbeams
from small_fem_solver_tpu.ops import buckling as jbuck
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import beams as tbeams
from small_fem_solver_tpu_torch.ops import buckling as tbuck
from test_torch_convert import port_case, port_model, port_wave, rel_err

TOL = 1e-10
N_SEG = 3
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom",
             t_analysis=0.34)
RESULT_FIELDS = ("U", "reactions", "F1_local", "utilization",
                 "pdelta_amplification")


def _column(build, L=20.0, D=1000.0, t=20.0, **kw):
    nodes = {"BASE": (0.0, 0.0, 0.0), "TIP": (0.0, 0.0, L)}
    members = [{"name": "COL", "node1": "BASE", "node2": "TIP",
                "type": "leg"}]
    return build(nodes, members, fixed_nodes=["BASE"], top_nodes=["TIP"],
                 leg_section=(D, t), **kw)


@pytest.fixture(scope="module")
def column():
    """The 20 m cantilever column refined 8x, tip-loaded (1,000 kN axial,
    50 kN shear), in both packages."""
    jm = sf.refine_model(_column(sf.build_model), 8)
    jw = sf.airy_wave(1e-9, 9.4, 50.0)
    case = dict(F_axial_kN=1000.0, F_shear_kN=50.0, sw_mode="none")
    return jm, jw, sf.LoadCase(**case), port_model(jm), port_wave(jw), \
        pt.LoadCase(**case)


@pytest.fixture(scope="module")
def jacket():
    """The default jacket and its 3x refinement under the storm (Fenton
    N = 12), in both packages."""
    jc = sf.default_3leg_jacket()
    jr = sf.refine_model(jc, N_SEG)
    jw = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12)
    return (jc, jr, jw, sf.LoadCase(**STORM), port_model(jc), port_model(jr),
            port_wave(jw), pt.LoadCase(**STORM))


def test_geometric_stiffness_matches_jax_with_releases():
    """The element K_G of a pinned-brace jacket for seeded axial forces,
    with and without the release projection W."""
    rng = np.random.default_rng(0)
    jm = sf.default_3leg_jacket()
    tm = port_model(jm)
    codes = rng.integers(0, 4, jm.n_members)
    N = rng.normal(size=jm.n_members) * 1e6
    G = 210000.0 / 2.6
    jW = jbeams.release_W(jm.coords, jm.conn, jm.sections, jm.sect_id,
                          210000.0, G, np.asarray(codes))
    tW = tbeams.release_W(tm.coords, tm.conn, tm.sections, tm.sect_id,
                          210000.0, G, torch.as_tensor(codes))
    for jw_, tw_ in ((None, None), (jW, tW)):
        ref = jbuck.element_geometric_stiffness(jm.coords, jm.conn, N, W=jw_)
        out = tbuck.element_geometric_stiffness(tm.coords, tm.conn,
                                                torch.as_tensor(N), W=tw_)
        assert rel_err(out, ref) < TOL


def test_cantilever_euler_load_and_amplification(column):
    """lambda_cr P reproduces the Timoshenko-reduced Euler load of the
    cantilever (2e-3), the P-delta amplification ~1 / (1 - 1 / lambda)
    (3%), and both match JAX; without axial load P-delta is linear."""
    jm, jw, jcase, tm, tw, tcase = column
    lin = pt.analyze(tm, tw, tcase, solver="chol")
    jlin = sf.analyze(jm, jw, jcase, solver="chol")
    np.testing.assert_allclose(tbuck.member_axial_forces(lin).numpy(),
                               1e6, rtol=1e-8)
    b = tbuck.buckling_analysis(tm, lin)
    jb = jax.jit(lambda: jbuck.buckling_analysis(jm, jlin))()
    assert rel_err(b.load_factor, jb.load_factor) < TOL
    lam = float(b.load_factor[0])
    col = _column(pt.build_model, device="cpu")
    E, G = 210000.0, 210000.0 / 2.6
    I, As = float(col.sections.Iy[0]), float(col.sections.Ay[0])
    P_E = np.pi ** 2 * E * I / (2 * 20.0 * 1000.0) ** 2
    assert abs(lam * 1e6 / (P_E / (1.0 + P_E / (G * As))) - 1.0) < 2e-3

    pd = pt.analyze_pdelta(tm, tw, tcase)
    jpd = sf.analyze_pdelta(jm, jw, jcase)
    for f in RESULT_FIELDS:
        assert rel_err(getattr(pd, f), getattr(jpd, f)) < TOL, f
    amp = float(pd.pdelta_amplification)
    assert amp > 1.001
    assert abs(amp / (1.0 / (1.0 - 1.0 / lam)) - 1.0) < 0.03

    shear = pt.LoadCase(F_shear_kN=100.0, sw_mode="none")
    pd0 = pt.analyze_pdelta(tm, tw, shear)
    U1 = pt.analyze(tm, tw, shear, solver="chol").U
    assert rel_err(pd0.U, U1) < 1e-6
    assert abs(float(pd0.pdelta_amplification) - 1.0) < 1e-6


def test_past_buckling_gives_nan(column):
    """Twice the buckling load: the corrected Cholesky gives NaN, dense
    and condensed, with no error (the JAX package's signal)."""
    _, _, _, tm, tw, tcase = column
    lam = float(tbuck.buckling_analysis(
        tm, pt.analyze(tm, tw, tcase, solver="chol")).load_factor[0])
    over = pt.LoadCase(F_axial_kN=2.0 * lam * 1000.0, F_shear_kN=50.0,
                       sw_mode="none")
    assert torch.isnan(pt.analyze_pdelta(tm, tw, over).U).any()
    coarse = _column(pt.build_model, device="cpu")
    refined = pt.refine_model(coarse, 8)
    cond = pt.analyze_pdelta_condensed(coarse, refined, 8, tw, over)
    assert torch.isnan(cond.U).any()


def test_storm_jacket_matches_jax(jacket):
    """The storm case: lambda_cr ~ 23, a few percent of amplification,
    equilibrium in the second-order state, the Euler screen, and every
    field against JAX, with and without foundation springs."""
    jc, _, jw, jcase, tc, _, tw, tcase = jacket
    lin = pt.analyze(tc, tw, tcase, solver="chol")
    b = tbuck.buckling_analysis(tc, lin)
    jlin = jax.jit(lambda: sf.analyze(jc, jw, jcase, solver="chol"))()
    jb = jax.jit(lambda: jbuck.buckling_analysis(jc, jlin))()
    assert rel_err(b.load_factor, jb.load_factor) < TOL
    assert 20.0 < float(b.load_factor[0]) < 26.0
    assert bool(torch.all(torch.diff(b.load_factor) >= -1e-9))
    scr = tbuck.euler_member_screen(tc, lin, k_factor=0.8)
    jscr = jbuck.euler_member_screen(jc, jlin, k_factor=0.8)
    for f in ("axial_N", "P_euler_N", "utilization"):
        assert rel_err(getattr(scr, f), getattr(jscr, f)) < TOL, f
    assert 0.0 < float(scr.utilization.max()) < 0.5
    springs = [1e6] * 3 + [1e12] * 3
    for ss in (None, springs):
        pd = pt.analyze_pdelta(tc, tw, tcase, support_stiffness=ss)
        jpd = sf.analyze_pdelta(jc, jw, jcase, support_stiffness=ss)
        for f in RESULT_FIELDS:
            assert rel_err(getattr(pd, f), getattr(jpd, f)) < TOL, (f, ss)
    amp = float(pd.pdelta_amplification)
    assert 1.0 < amp < 1.15
    pd = pt.analyze_pdelta(tc, tw, tcase)
    assert float(pd.max_displacement_mm) >= float(lin.max_displacement_mm)
    applied = pd.F_applied.reshape(-1, 6)[:, :3].sum(dim=0)
    assert rel_err(pd.total_reaction[:3], -applied) < 1e-9


def test_condensed_matches_dense_and_jax(jacket):
    """analyze_pdelta_condensed equals the dense analyze_pdelta on the
    same refined mesh (1e-8) and JAX's condensed run (1e-10);
    buckling_analysis_condensed with every chain mode kept equals the
    dense refined factors, truncated within 1%, and matches JAX."""
    jc, jr, jw, jcase, tc, tr, tw, tcase = jacket
    cond = pt.analyze_pdelta_condensed(tc, tr, N_SEG, tw, tcase)
    dense = pt.analyze_pdelta(tr, tw, tcase, accel="analytic")
    for f in ("U", "utilization", "pdelta_amplification"):
        assert rel_err(getattr(cond, f), getattr(dense, f)) < 1e-8, f
    assert float(cond.pdelta_amplification) > 1.0
    jcond = sf.analyze_pdelta_condensed(jc, jr, N_SEG, jw, jcase)
    for f in RESULT_FIELDS:
        assert rel_err(getattr(cond, f), getattr(jcond, f)) < TOL, f

    res = pt.analyze_condensed(tc, tr, N_SEG, tw, tcase, refine_steps=0)
    jres = sf.analyze_condensed(jc, jr, N_SEG, jw, jcase)
    full = 6 * (N_SEG - 1)
    exact = tbuck.buckling_analysis_condensed(tc, tr, N_SEG, res, n_modes=3,
                                              n_chain_modes=full)
    dense_b = tbuck.buckling_analysis(tr, res, n_modes=3)
    assert rel_err(exact.load_factor, dense_b.load_factor) < 1e-8
    assert exact.mode_shapes.shape == (3, tr.n_dof)
    trunc = tbuck.buckling_analysis_condensed(tc, tr, N_SEG, res, n_modes=3,
                                              n_chain_modes=6)
    assert abs(float(trunc.load_factor[0])
               / float(dense_b.load_factor[0]) - 1.0) < 0.01
    jexact = jax.jit(lambda: jbuck.buckling_analysis_condensed(
        jc, jr, N_SEG, jres, n_modes=3, n_chain_modes=full))()
    assert rel_err(exact.load_factor, jexact.load_factor) < TOL
    with pytest.raises(ValueError, match="refined"):
        tbuck.buckling_analysis_condensed(tc, tr, N_SEG,
                                          pt.analyze(tc, tw, tcase))
