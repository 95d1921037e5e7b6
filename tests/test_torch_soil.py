"""PyTorch port vs the JAX package: pile-soil interaction,
``ops/soil.py`` (API p-y / t-z / Q-z curves, the Newton Winkler solves,
pile-head springs) and the clamped -> springs -> ``analyze_ssi`` workflow.

Mirrors ``tests/test_soil.py``: the linear-soil pile against the
closed-form beam and rod on elastic foundation, the curves' derivatives
at their kinks against ``jax.grad`` (the Newton iteration starts on them:
its first iterate shows the convention), and the springs, head
displacements and the SSI analysis against JAX in f64 on the CPU
(max |port - JAX| / max |JAX| <= 1e-10; the converged Newton residuals
are roundoff, held below 1e-8 on both sides).  JAX's references are
jitted where the function allows it (op-by-op dispatch costs seconds)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import soil as js
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import convert
from small_fem_solver_tpu_torch.ops import soil as ts
from test_torch_convert import leaves, port_case, port_model, port_wave, \
    rel_err

TOL = 1e-10
RESID = 1e-8
CPU = "cpu"
PILE = dict(D_mm=2134.0, t_mm=50.0, L_m=60.0, n_elem=16)
# the CLI's built-in profile: soft clay over sand
PROFILE = [dict(kind="clay", z_top=0.0, z_bot=8.0, su_kPa=40.0,
                gamma_kN_m3=8.0, eps50=0.02),
           dict(kind="sand", z_top=8.0, z_bot=100.0, phi_deg=35.0,
                gamma_kN_m3=10.0)]
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom",
             t_analysis=0.34)


def both(layers, **pile):
    """(JAX soil, JAX pile, port soil, port pile), the port's through
    ``convert``."""
    jsoil = [js.SoilLayer(**lay) for lay in layers]
    jpile = js.Pile(**{**PILE, **pile})
    return (jsoil, jpile,
            convert.soil_from_fields([dataclasses.asdict(l) for l in jsoil]),
            convert.pile_from_fields(**dataclasses.asdict(jpile)))


def jax_slope(fn, par, x):
    """The JAX module's Newton tangent: per-node ``jax.grad`` at the
    rows of ``x`` [k, n_nodes] (one trace for all of them)."""
    n = x.shape[1]
    g = jax.vmap(jax.grad(lambda xi, i: fn(
        jax.tree.map(lambda a: a[i], par), xi)), in_axes=(0, 0))
    return np.asarray(g(jnp.asarray(x.reshape(-1)),
                        jnp.tile(jnp.arange(n), x.shape[0]))).reshape(x.shape)


def test_curves_and_tangents_at_the_kinks_match_jax():
    """p(y), t(u) and their slopes against the JAX curves and
    ``jax.grad`` at every kink the Newton iteration can sit on: u = 0 (the
    clay table's knot, the sand clip's slope), the sand t-z clip's ties at
    +-2.54 mm, the clay p-y cap's tie at y = 8 y_50, the clay t-z table's
    knots (the segment to the right) and points past the tables."""
    jsoil, jpile, tsoil, tpile = both(PROFILE)
    z = np.linspace(0.0, 60.0, 17)
    jlat = js._lateral_params(jpile, jsoil, z)
    tlat = ts._lateral_params(tpile, tsoil, z, device=CPU)
    y50 = np.asarray(jlat.c1)
    D = PILE["D_mm"] / 1000.0
    y = np.stack([np.zeros(17), 8.0 * y50, -8.0 * y50, 5e-4 * y50 + 1e-9,
                  np.linspace(-0.2, 0.2, 17)])
    assert rel_err(ts.py_resistance(tlat, torch.tensor(y)),
                   jax.vmap(lambda r: js.py_resistance(jlat, r))(
                       jnp.asarray(y))) < TOL
    assert rel_err(ts.py_slope(tlat, torch.tensor(y)),
                   jax_slope(js.py_resistance, jlat, y)) < TOL
    jax_ax, Q_j, _ = js._axial_params(jpile, jsoil, z)
    tax, Q_t, _ = ts._axial_params(tpile, tsoil, z, device=CPU)
    assert Q_t == Q_j
    knots = np.concatenate([[0.0, 0.00254, -0.00254],
                            js._TZ_CLAY_Z[1:] * D, [2.0 * D, -3.0 * D]])
    u = np.repeat(knots[:, None], 17, axis=1)
    assert rel_err(ts.tz_resistance(tax, torch.tensor(u)),
                   jax.vmap(lambda r: js.tz_resistance(jax_ax, r))(
                       jnp.asarray(u))) < TOL
    assert rel_err(ts.tz_slope(tax, torch.tensor(u)),
                   jax_slope(js.tz_resistance, jax_ax, u)) < TOL


@pytest.mark.parametrize("n_iter,scour_m", [(1, 0.0), (60, 3.0)])
def test_first_newton_step_and_solves_match_jax(n_iter, scour_m):
    """One Newton step from u = 0 (its tangent holds the kink
    conventions: the tip's maximum(u, 0) weighs 1/2, the Q-z and clay t-z
    knots take their right segment; its residual is not roundoff, so it is
    held at 1e-10 too) and the converged lateral and axial solves under
    scour."""
    jsoil, jpile, tsoil, tpile = both(PROFILE)
    for jfn, tfn, load in ((js.lateral_solve, ts.lateral_solve, (2e6, 3e6)),
                           (js.axial_solve, ts.axial_solve, (1.5e7,))):
        j = jfn(jpile, jsoil, *load, n_iter=n_iter, scour_m=scour_m)
        t = tfn(tpile, tsoil, *load, n_iter=n_iter, scour_m=scour_m,
                device=CPU)
        assert rel_err(t.u, j.u) < TOL, jfn.__name__
        assert np.array_equal(t.z, j.z)
        if n_iter == 1:
            assert abs(float(t.residual) / float(j.residual) - 1) < TOL
        else:
            assert float(t.residual) < RESID > float(j.residual)


def test_linear_soil_matches_closed_form():
    """Linear layers against the closed forms (the JAX test's): the
    semi-infinite beam on an elastic foundation y0 = 2 H lambda / Es,
    theta0 = -2 H lambda^2 / Es, theta0 = 4 M lambda^3 / Es under a head
    moment (2%), and the rod with skin springs K = sqrt(EA ks) tanh(mu L)
    (1e-3), at the JAX test's 48 elements; the port's solves converge to
    1e-10."""
    soil = [pt.SoilLayer("linear", 0.0, 100.0, Es_MPa=50.0, ks_MPa=20.0)]
    pile = pt.Pile(**{**PILE, "n_elem": 48})
    D = pile.D_mm / 1000.0
    EI = 210e9 * np.pi / 64 * (D**4 - (D - 0.1) ** 4)
    EA = 210e9 * np.pi / 4 * (D**2 - (D - 0.1) ** 2)
    Es, ks, H, M, V = 50e6, 20e6, 1e6, 5e6, 5e6
    lam = (Es / (4 * EI)) ** 0.25
    sol = pt.lateral_solve(pile, soil, H, device=CPU)
    np.testing.assert_allclose(float(sol.u[0]), 2 * H * lam / Es, rtol=0.02)
    np.testing.assert_allclose(float(sol.u[1]), -2 * H * lam**2 / Es,
                               rtol=0.02)
    solM = pt.lateral_solve(pile, soil, 0.0, M, device=CPU)
    np.testing.assert_allclose(float(solM.u[1]), 4 * M * lam**3 / Es,
                               rtol=0.02)
    ax = pt.axial_solve(pile, soil, V, device=CPU)
    mu = np.sqrt(ks / EA)
    np.testing.assert_allclose(V / float(ax.u[0]),
                               np.sqrt(EA * ks) * np.tanh(mu * pile.L_m),
                               rtol=1e-3)
    for s in (sol, solM, ax):
        assert float(s.residual) < TOL
        assert s.u.device.type == CPU and s.u.dtype == torch.float64


def test_pile_head_stiffness_matches_jax():
    """The secant head springs, the 2x2 lateral secants and the head
    displacements of the two-layer profile (1e-10); axial stiffer than
    lateral, as in the JAX test."""
    jsoil, jpile, tsoil, tpile = both(PROFILE)
    j = js.pile_head_stiffness(jpile, jsoil, H_kN=2000.0, V_kN=15000.0)
    t = ts.pile_head_stiffness(tpile, tsoil, H_kN=2000.0, V_kN=15000.0,
                               device=CPU)
    for f in ("support_stiffness", "K_lateral_2x2", "y_head_mm",
              "theta_head_rad", "u_head_mm"):
        assert rel_err(getattr(t, f), getattr(j, f)) < TOL, f
    assert np.all(t.residuals < RESID) and np.all(j.residuals < RESID)
    assert t.support_stiffness[2] > 5.0 * t.support_stiffness[0]
    with pytest.raises(ValueError, match="working"):
        ts.pile_head_stiffness(tpile, tsoil, H_kN=0.0, device=CPU)


def test_clamped_to_springs_to_ssi_matches_jax():
    """The workflow: the clamped storm analysis, per-support springs from
    its reactions (the soil solves on the model's device), then
    ``analyze_ssi`` on them: springs, and the SSI displacements,
    reactions and utilization against JAX's from the same reactions
    (1e-10); the structure softens and the reactions still balance the
    loads."""
    jsoil, jpile, tsoil, tpile = both(PROFILE)
    jm = sf.default_3leg_jacket()
    jw = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    jc = sf.LoadCase(**STORM)
    tm, tw, tc = port_model(jm), port_wave(jw), port_case(jc)
    clamped = pt.analyze(tm, tw, tc, solver="chol")
    jk = js.soil_support_stiffness(jm, jsoil, jpile,
                                   reactions=clamped.reactions.numpy())
    k = ts.soil_support_stiffness(tm, tsoil, tpile,
                                  reactions=clamped.reactions)
    assert k.shape == (3, 6) and rel_err(k, jk) < TOL
    jssi = jax.jit(lambda: sf.analyze_ssi(jm, jw, jc, jk))()
    ssi = pt.analyze_ssi(tm, tw, tc, k)
    for f in ("U", "reactions", "F1_local", "utilization"):
        assert rel_err(getattr(ssi, f), getattr(jssi, f)) < TOL, f
    assert float(ssi.max_displacement_mm) > float(
        clamped.max_displacement_mm)
    F = ssi.F_applied.reshape(-1, 6)[:, :3].sum(0)
    assert rel_err(ssi.total_reaction[:3], -F) < TOL
    # the results' fields carry over through convert as well
    assert rel_err(convert.results_from_numpy(leaves(jssi), device=CPU).U,
                   jssi.U) == 0.0
