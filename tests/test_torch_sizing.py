"""PyTorch port vs the JAX package: differentiable design — the dense
analysis under autograd (the Cholesky factor filled out of place when
recorded, the grad-safe square roots of the von Mises recovery),
``section_sensitivities`` at two and three section groups and
``optimize_sections``.  f64 on the CPU, the default jacket."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import sections as jsections
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import sections as tsections
from small_fem_solver_tpu_torch.ops.solve import cholesky_or_nan
from test_torch_convert import port_case, port_model, port_wave, rel_err

GRAD_TOL = 1e-10     # gradients, relative to the largest component
SIZING_TOL = 1e-8    # optimize_sections: thicknesses, history, results
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")


@pytest.fixture(scope="module")
def design():
    """The Stokes-5 storm at t = 0.34 s of the JAX package's design tests,
    on the default jacket and on its three-group variant (legs, horizontal
    braces, X-braces), in both packages."""
    jm = sf.default_3leg_jacket()
    jw = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="stokes", N=5)
    jc = sf.LoadCase(**STORM, t_analysis=0.34)
    sid = np.array([{"leg": 0, "h_brace": 1}.get(t, 2)
                    for t in jm.member_types], dtype=np.int32)
    j3 = dataclasses.replace(
        jm, sect_id=jnp.asarray(sid),
        sections=sf.tube_sections(jnp.asarray([2000.0, 800.0, 900.0]),
                                  jnp.asarray([75.0, 30.0, 35.0]), 7850.0))
    return {"jax": (jm, jw, jc), "jax3": (j3, jw, jc),
            "port": (port_model(jm), port_wave(jw), port_case(jc)),
            "port3": (port_model(j3), port_wave(jw), port_case(jc))}


def test_cholesky_or_nan_is_differentiable():
    """Recorded by autograd, the factor is filled out of place, so its
    backward equals ``torch.linalg.cholesky``'s; unrecorded, a matrix that
    is not positive definite still gets an all-NaN factor."""
    rng = np.random.default_rng(0)
    B = rng.standard_normal((3, 6, 6))
    A0 = torch.tensor(B @ np.swapaxes(B, -1, -2) + 6.0 * np.eye(6))
    w = torch.tensor(rng.standard_normal((3, 6, 6)))
    A = A0.clone().requires_grad_(True)
    g, = torch.autograd.grad((cholesky_or_nan(A) * w).sum(), A)
    A = A0.clone().requires_grad_(True)
    want, = torch.autograd.grad((torch.linalg.cholesky(A) * w).sum(), A)
    assert torch.equal(g, want)
    bad = A0.clone()
    bad[1] = -bad[1]
    with torch.no_grad():
        L = cholesky_or_nan(bad)
    assert torch.isnan(L[1]).all() and torch.isfinite(L[[0, 2]]).all()


def test_analyze_gradient_matches_jax():
    """torch.autograd.grad of the port's ``analyze(solver="chol")`` max
    utilization with respect to the section parameters (D_leg, t_leg,
    D_brace, t_brace) against jax.grad of JAX's ``analyze`` (the Airy
    storm of the verify recipe, analytic accelerations)."""
    jm = sf.default_3leg_jacket()
    jw = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    jc = sf.LoadCase(**STORM)

    def j_util(p):
        m = dataclasses.replace(jm, sections=sf.tube_sections(
            p[0::2], p[1::2], 7850.0))
        return sf.analyze(m, jw, jc, solver="chol",
                          accel="analytic").utilization.max()
    p0 = jnp.asarray([2000.0, 75.0, 800.0, 30.0])
    want = np.asarray(jax.jit(jax.grad(j_util))(p0))
    tm, tw, tc = port_model(jm), port_wave(jw), port_case(jc)
    p = torch.tensor(np.asarray(p0), requires_grad=True)
    m = dataclasses.replace(tm, sections=pt.tube_sections(
        p[0::2], p[1::2], 7850.0, device="cpu"))
    u = pt.analyze(m, tw, tc, solver="chol", accel="analytic")
    g, = torch.autograd.grad(u.utilization.max(), p)
    assert np.isfinite(g.numpy()).all()
    assert rel_err(g, want) < GRAD_TOL


def test_von_mises_gradient_at_zero_shear_matches_jax():
    """A member with zero shear and torsion (the square root's argument
    exactly 0) gets a finite gradient, JAX's; the forward is unchanged:
    bit-equal to the plain square roots."""
    sec_j = sf.tube_sections(jnp.asarray([2000.0, 800.0]),
                             jnp.asarray([75.0, 30.0]), 7850.0)
    sec_t = pt.tube_sections([2000.0, 800.0], [75.0, 30.0], 7850.0,
                             device="cpu")
    sid = np.array([0, 1, 1, 0])
    rng = np.random.default_rng(1)
    F = rng.standard_normal((6, 4)) * np.array([[1e6], [1e5], [1e5],
                                                [1e8], [1e8], [1e8]])
    F[1:4, 1] = 0.0                  # member 1: no shear, no torsion
    F[:, 2] = 0.0                    # member 2: no load at all

    def j_sum(f):
        return jnp.sum(jsections.von_mises_8pt(sec_j, jnp.asarray(sid),
                                               *f) * jnp.arange(1.0, 5.0))
    want = np.asarray(jax.jit(jax.grad(j_sum))(jnp.asarray(F)))
    f = torch.tensor(F, requires_grad=True)
    vm = tsections.von_mises_8pt(sec_t, torch.tensor(sid), *f)
    g, = torch.autograd.grad((vm * torch.arange(1.0, 5.0,
                                                dtype=torch.float64)).sum(),
                             f)
    assert np.isfinite(g.numpy()).all()
    assert rel_err(g, want) < GRAD_TOL
    # the forward: bit-equal to torch.sqrt of the same sums
    with torch.no_grad():
        Fd = torch.tensor(F)
        sid_t = torch.tensor(sid)
        sigma = tsections.normal_stress_8pt(sec_t, sid_t, Fd[0], Fd[4],
                                            Fd[5])
        tau = torch.sqrt((Fd[3] * sec_t.R_outer[sid_t] / sec_t.Ix[sid_t]) ** 2
                         + (Fd[1] / sec_t.Ay[sid_t]) ** 2
                         + (Fd[2] / sec_t.Az[sid_t]) ** 2)
        plain = torch.amax(torch.sqrt(sigma**2 + 3.0 * tau[..., None] ** 2),
                           dim=-1)
        assert torch.equal(tsections.von_mises_8pt(sec_t, sid_t, *Fd), plain)


@pytest.mark.parametrize("layout,tau", [("", None), ("3", None),
                                        ("", 0.02)])
def test_section_sensitivities_match_jax(design, layout, tau):
    """The interleaved (D_i, t_i) gradients of max utilization (hard max,
    and the logsumexp at tau 0.02) and of the structural mass, at two and
    three section groups."""
    ref = sf.section_sensitivities(*design["jax" + layout], tau=tau)
    out = pt.section_sensitivities(*design["port" + layout], tau=tau)
    n = 2 * (3 if layout else 2)
    assert out.dutil.shape == (n,) and out.dmass_t.shape == (n,)
    assert not out.dutil.requires_grad
    for f in ("dutil", "dmass_t", "util_max", "mass_t"):
        assert rel_err(getattr(out, f), getattr(ref, f)) < GRAD_TOL, f


def test_optimize_sections_matches_jax(design):
    """Five projected-gradient steps to target 0.5: thicknesses, the
    history (pre-step utilization and mass) and the re-evaluated final
    design."""
    ref = sf.optimize_sections(*design["jax"], target_util=0.5, n_iter=5)
    out = pt.optimize_sections(*design["port"], target_util=0.5, n_iter=5)
    assert out.history.shape == (5, 4)
    assert rel_err(out.history, ref.history) < SIZING_TOL
    for f in ("t", "t_leg", "t_brace", "util_max", "mass_t"):
        assert rel_err(getattr(out, f), getattr(ref, f)) < SIZING_TOL, f
    t = out.t.numpy()
    assert (t >= 10.0).all() and (np.array([2000.0, 800.0]) / t > 10.0).all()
