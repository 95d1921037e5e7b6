"""PyTorch port vs the JAX package: structural dynamics.

Same inputs (the 126-DOF default jacket and its 2x / 4x refinements, f64,
numpy-seeded loads and matrices) through the JAX function and the port's:

- element mass, added mass and hydrodynamic damping matrices at 1e-12;
- ``modal_analysis`` (clamped, springs, added mass, topside) and
  ``modal_analysis_condensed`` (all chain modes at n_seg = 2 and 4, and
  the subspace-iteration branch) at 1e-10: frequencies, total mass, and
  mode shapes by the MAC of each mode against the span of its
  (near-)degenerate JAX cluster (sway pairs rotate freely inside it);
- ``dynamic_response`` / ``dynamic_response_condensed`` and
  ``transient_response_condensed`` (ramp, free decay from u0, relative
  drag with 1 and 2 iterations, ground acceleration) at 1e-10;
- the harmonic solves, the real DFT pair, ``mac``, ``ground_with_springs``,
  the four eigen functions (``subspace_*`` at 1e-9: the JAX iterations
  stop at their convergence error) and ``fatigue_screen``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops import dynamics as jd
from small_fem_solver_tpu.ops import eigen as je
from small_fem_solver_tpu.ops.fatigue import fatigue_screen as j_fatigue
from small_fem_solver_tpu.ops.morison import hydro_diameter_m
from small_fem_solver_tpu.ops.solve import \
    ground_with_springs as j_ground_with_springs
from small_fem_solver_tpu.ops.spectrum import make_random_sea
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import convert
from small_fem_solver_tpu_torch.ops import dynamics as td
from small_fem_solver_tpu_torch.ops import eigen as te
from small_fem_solver_tpu_torch.ops.solve import ground_with_springs
from test_torch_convert import port_case, port_model, port_wave, rel_err

TOL = 1e-10
SPRINGS = [1e6] * 3 + [1e12] * 3
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")


@pytest.fixture(scope="module")
def jacket():
    """The default jacket, its 2x and 4x refinements and a Stokes-5 wave,
    in the JAX package and the port."""
    jc = sf.default_3leg_jacket()
    jr = {n: sf.refine_model(jc, n) for n in (2, 4)}
    jw = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5)
    return (jc, jr, jw, port_model(jc),
            {n: port_model(m) for n, m in jr.items()}, port_wave(jw))


def shape_err(out, ref, freqs) -> float:
    """1 - the largest-miss MAC of each port mode against the span of its
    JAX cluster (modes whose frequencies agree to 1e-6): the MAC itself
    where a mode is simple."""
    a = out.numpy()
    b = np.asarray(ref)
    f = np.asarray(freqs)
    worst = 0.0
    for i in range(a.shape[0]):
        cluster = np.abs(f - f[i]) <= 1e-6 * abs(f[i])
        Q, _ = np.linalg.qr(b[cluster].T)
        proj = Q.T @ a[i]
        worst = max(worst, 1.0 - float(proj @ proj / (a[i] @ a[i])))
    return worst


def assert_modal(out, ref, tol=TOL):
    assert rel_err(out.frequencies_hz, ref.frequencies_hz) < tol
    assert rel_err(out.total_mass_t, ref.total_mass_t) < 1e-12
    assert shape_err(out.mode_shapes, ref.mode_shapes,
                     ref.frequencies_hz) < tol


def test_element_matrices_match_jax(jacket):
    _, jr, _, _, tr, _ = jacket
    j, t = jr[4], tr[4]
    D = hydro_diameter_m(j.sections, j.sect_id)
    c = np.random.default_rng(0).uniform(50.0, 400.0, j.n_members)
    pairs = (
        (td.element_mass(t.coords, t.conn, t.sections, t.sect_id),
         jd.element_mass(j.coords, j.conn, j.sections, j.sect_id)),
        (td.element_added_mass(t.coords, t.conn, torch.tensor(np.asarray(D)),
                               rho_water=1025.0, Ca=1.0),
         jd.element_added_mass(j.coords, j.conn, D, rho_water=1025.0,
                               Ca=1.0)),
        (td.element_hydro_damping(t.coords, t.conn, c),
         jd.element_hydro_damping(j.coords, j.conn, c)))
    for out, ref in pairs:
        assert float(np.abs(np.asarray(ref)).max()) > 0
        assert rel_err(out, ref) < 1e-12


@pytest.mark.parametrize("options", [
    dict(), dict(topside_mass_t=1100.0),
    dict(support_stiffness=SPRINGS, topside_mass_t=1100.0),
    dict(added_mass_Ca=1.0, topside_mass_t=1100.0)])
def test_modal_analysis_matches_jax(jacket, options):
    jc, _, _, tc, _, _ = jacket
    ref = jd.modal_analysis(jc, n_modes=8, **options)
    out = pt.modal_analysis(tc, n_modes=8, **options)
    assert_modal(out, ref)


@pytest.mark.parametrize("n_seg,n_chain_modes,options,tol", [
    (2, 6, dict(topside_mass_t=1100.0), TOL),
    (4, 18, dict(topside_mass_t=1100.0, support_stiffness=SPRINGS,
                 added_mass_Ca=1.0), TOL),
    # the subspace-iteration branch, with a chain-mode count at a gap of
    # the chain spectrum (bending modes come in equal pairs: a count that
    # splits a pair keeps a rotation of it that the eigensolver picks)
    (4, 4, dict(topside_mass_t=1100.0), TOL),
])
def test_modal_analysis_condensed_matches_jax(jacket, n_seg, n_chain_modes,
                                              options, tol):
    jc, jr, _, tc, tr, _ = jacket
    # jitted: op by op JAX's reduction costs ~10 s a configuration
    ref = jax.jit(lambda: jd.modal_analysis_condensed(
        jc, jr[n_seg], n_seg, n_modes=8, n_chain_modes=n_chain_modes,
        **options))()
    out = pt.modal_analysis_condensed(tc, tr[n_seg], n_seg, n_modes=8,
                                      n_chain_modes=n_chain_modes, **options)
    assert_modal(out, ref, tol)


HARMONIC_FIELDS = ("U_time", "U_static", "utilization", "utilization_static",
                   "daf", "rayleigh_alpha", "rayleigh_beta")


def test_dynamic_response_matches_jax(jacket):
    jc, jr, jw, tc, tr, tw = jacket
    case = sf.LoadCase(**STORM)
    runs = (
        (pt.dynamic_response(tc, tw, port_case(case), n_harmonics=4,
                             n_steps=24, support_stiffness=SPRINGS),
         jd.dynamic_response(jc, jw, case, n_harmonics=4, n_steps=24,
                             support_stiffness=SPRINGS)),
        (pt.dynamic_response_condensed(tc, tr[2], 2, tw, port_case(case),
                                       n_harmonics=4, n_steps=24,
                                       n_chain_modes=6),
         jd.dynamic_response_condensed(jc, jr[2], 2, jw, case,
                                       n_harmonics=4, n_steps=24,
                                       n_chain_modes=6)))
    for out, ref in runs:
        for name in HARMONIC_FIELDS:
            assert rel_err(getattr(out, name), getattr(ref, name)) < TOL, name
        assert rel_err(out.ts, ref.ts) < 1e-14


@pytest.mark.parametrize("wave,n_gauss", [("airy40", 15), ("stokes", 20)])
def test_dynamic_response_past_kernel_limits_matches_jax(jacket, wave,
                                                         n_gauss):
    """An Airy wave padded to 40 modes, and n_gauss = 20: past the Morison
    kernel's 32 modes / 16 Gauss points, where the JAX package's separable
    engine still runs; the port runs the plain version (no launch) and
    matches at 1e-10."""
    jc, jr, jw, tc, tr, tw = jacket
    if wave == "airy40":
        jw = sf.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="airy", n_modes=40)
        tw = port_wave(jw)
    case = sf.LoadCase(**STORM)
    before = pt.ops.hopper_kernels.morison_phase_batch_cuda.launches
    out = pt.dynamic_response(tc, tw, port_case(case), n_harmonics=4,
                              n_steps=24, n_gauss=n_gauss)
    ref = jd.dynamic_response(jc, jw, case, n_harmonics=4, n_steps=24,
                              n_gauss=n_gauss)
    assert pt.ops.hopper_kernels.morison_phase_batch_cuda.launches == before
    for name in HARMONIC_FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < TOL, name


TRANSIENT_FIELDS = ("U_time", "utilization", "tip_displacement_mm", "omega1",
                    "rayleigh_alpha", "rayleigh_beta")


@pytest.mark.parametrize("variant", ["ramp", "free_decay", "relative_drag_1",
                                     "relative_drag_2", "ground_accel"])
def test_transient_response_matches_jax(jacket, variant):
    jc, jr, jw, tc, tr, tw = jacket
    n_seg, n_steps, dt = 2, 64, 9.4 / 32
    case = sf.LoadCase(**STORM)
    kw = dict(dt=dt, n_steps=n_steps, n_chain_modes=6)
    wave_j, wave_t = jw, tw
    if variant == "ramp":
        kw.update(ramp_periods=1.0)
    elif variant == "free_decay":
        modes = pt.modal_analysis_condensed(tc, tr[2], 2, n_modes=1,
                                            topside_mass_t=1100.0,
                                            n_chain_modes=6)
        shape = modes.mode_shapes[0].numpy()
        kw.update(zero_loads=True, u0=50.0 * shape / np.abs(shape).max())
        wave_j = wave_t = None
    elif variant.startswith("relative_drag"):
        kw.update(relative_drag=True, ramp_periods=1.0,
                  drag_iterations=int(variant[-1]))
    else:
        ag = np.random.default_rng(3).normal(0.0, 1.0, n_steps)
        kw.update(zero_loads=True, ground_accel=ag, ground_dir=(1.0, 0.5, 0.0))
        wave_j = wave_t = None
    ref = jd.transient_response_condensed(
        jc, jr[n_seg], n_seg, wave_j, case,
        **{k: jnp.asarray(v) if k == "u0" else v for k, v in kw.items()})
    out = pt.transient_response_condensed(tc, tr[n_seg], n_seg, wave_t,
                                          port_case(case), **kw)
    for name in TRANSIENT_FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < TOL, name
    assert float(np.abs(np.asarray(ref.U_time)).max()) > 0


def test_transient_refuses_spectral_seas(jacket):
    """The seas the dynamics paths refuse, as the JAX package does: a
    spread sea with relative drag (its headings live in the phase batch,
    not pointwise), and any sea on the harmonic paths, which need a
    periodic wave; slamming everywhere.  (Long-crested seas run through
    the transient: ``tests/test_torch_spectrum.py``.)"""
    _, _, _, tc, tr, _ = jacket
    sea = make_random_sea(6.0, 9.4, 50.0, n_components=4, seed=2,
                          spreading_s=4.0)
    port = convert.sea_from_numpy(
        *(np.asarray(getattr(sea, f)) for f in ("omega", "k", "a", "phi",
                                                "E", "U", "d", "U_c", "Hs",
                                                "Tp")),
        dir_deg=np.asarray(sea.dir_deg), device="cpu")
    # (the transient tests' chain modes and time grid: JAX reaches its
    # check after the reduction and the condensed loads, whose compiles
    # they have made)
    kw = dict(dt=9.4 / 32, n_steps=64, relative_drag=True, n_chain_modes=6)
    with pytest.raises(ValueError, match="long-crested"):
        jd.transient_response_condensed(jacket[0], jacket[1][2], 2, sea,
                                        sf.LoadCase(**STORM), **kw)
    with pytest.raises(ValueError, match="long-crested"):
        pt.transient_response_condensed(tc, tr[2], 2, port,
                                        pt.LoadCase(**STORM), **kw)
    with pytest.raises(TypeError, match="FourierWave"):
        pt.dynamic_response_condensed(tc, tr[2], 2, port,
                                      pt.LoadCase(**STORM), n_steps=4)
    with pytest.raises(ValueError, match="slamming"):
        pt.dynamic_response(tc, None, pt.LoadCase(**STORM, slam_cs=3.14))


def _spd(rng, n, scale):
    A = rng.normal(size=(n, n))
    return scale * (A @ A.T + n * np.eye(n))


def _with_spectrum(rng, lam, M=None):
    """A symmetric matrix whose (generalized, with M) eigenvalues are
    ``lam``: L U diag(lam) U^T L^T with U orthogonal and M = L L^T."""
    U, _ = np.linalg.qr(rng.normal(size=(len(lam), len(lam))))
    L = np.eye(len(lam)) if M is None else np.linalg.cholesky(M)
    return L @ U @ np.diag(lam) @ U.T @ L.T


def test_harmonic_solves_and_dft_match_jax():
    rng = np.random.default_rng(4)
    n, n_h, S = 20, 5, 24
    K, M = _spd(rng, n, 1e3), _spd(rng, n, 1.0)
    F_t = rng.normal(size=(S, n))
    omega, alpha, beta = 2.0, 0.05, 0.002
    c_re, c_im = jd.real_dft_coeffs(jnp.asarray(F_t), n_h)
    o_re, o_im = td.real_dft_coeffs(torch.tensor(F_t), n_h)
    assert rel_err(o_re, c_re) < 1e-14 and rel_err(o_im, c_im) < 1e-14
    ref = jd.harmonic_solve_real(jnp.asarray(K), jnp.asarray(M), c_re, c_im,
                                 omega, alpha, beta)
    out = td.harmonic_solve_real(torch.tensor(K), torch.tensor(M), o_re,
                                 o_im, omega, alpha, beta)
    for a, b in zip(out, ref):
        assert rel_err(a, b) < TOL
    F_hat = np.asarray(c_re) + 1j * np.asarray(c_im)
    refc = jd.harmonic_solve(jnp.asarray(K), jnp.asarray(M),
                             jnp.asarray(F_hat), omega, alpha, beta)
    outc = td.harmonic_solve(torch.tensor(K), torch.tensor(M),
                             torch.tensor(F_hat), omega, alpha, beta)
    assert outc.dtype == torch.complex128
    assert rel_err(outc.real, np.real(refc)) < TOL
    assert rel_err(outc.imag, np.imag(refc)) < TOL
    ts = np.arange(S) * 0.3
    back_j = jd.real_harmonic_reconstruct(ref[0], ref[1], omega,
                                          jnp.asarray(ts))
    back_t = td.real_harmonic_reconstruct(out[0], out[1], omega,
                                          torch.tensor(ts))
    assert rel_err(back_t, back_j) < TOL


def test_mac_springs_and_fatigue_match_jax(jacket):
    jc, _, _, tc, _, _ = jacket
    rng = np.random.default_rng(5)
    A, B = rng.normal(size=(4, 30)), rng.normal(size=(5, 30))
    assert rel_err(td.mac(torch.tensor(A), torch.tensor(B)),
                   jd.mac(A, B)) < 1e-13
    K = _spd(rng, jc.n_dof, 1.0)
    Kj, free_j = j_ground_with_springs(jnp.asarray(K), jc.fixed_mask,
                                       SPRINGS, jnp.float64)
    Kt, free_t = ground_with_springs(torch.tensor(K), tc.fixed_mask, SPRINGS,
                                     torch.float64)
    assert torch.equal(Kt, torch.tensor(np.asarray(Kj)))
    assert np.array_equal(free_t.numpy(), np.asarray(free_j))
    vm = rng.uniform(10.0, 200.0, (24, 51))
    scf = rng.uniform(1.0, 2.5, 51)
    for kw in (dict(), dict(curve="F", scf=scf, occurrence=0.3)):
        ref = j_fatigue(vm, 9.4, 25.0, **kw)
        out = pt.fatigue_screen(torch.tensor(vm), 9.4, 25.0, **kw)
        for name in ("stress_range_mpa", "cycles_to_failure", "damage",
                     "life_years"):
            assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-13
        assert out.n_cycles == ref.n_cycles
    with pytest.raises(ValueError, match="S-N curve"):
        pt.fatigue_screen(torch.tensor(vm), 9.4, 25.0, curve="X")


def test_eigen_functions_match_jax():
    rng = np.random.default_rng(6)
    A = np.stack([_spd(rng, 12, 1.0) for _ in range(3)])
    B = np.stack([_spd(rng, 12, 0.1) for _ in range(3)])
    w_j, V_j = je.jacobi_eigh(jnp.asarray(A))
    w_t, V_t = pt.jacobi_eigh(torch.tensor(A))
    assert rel_err(w_t, w_j) < TOL
    # eigenvectors up to sign: |V_t^T V_j| is the identity
    overlap = np.abs(np.einsum("bij,bik->bjk", V_t.numpy(), np.asarray(V_j)))
    assert np.abs(overlap - np.eye(12)).max() < 1e-9
    lam_j, Vg_j = je.eigh_general_small(jnp.asarray(A), jnp.asarray(B))
    lam_t, Vg_t = pt.eigh_general_small(torch.tensor(A), torch.tensor(B))
    assert rel_err(lam_t, lam_j) < TOL
    # B-orthonormal, and the same vectors up to sign
    G = np.einsum("bij,bjk,bkl->bil", Vg_t.numpy().transpose(0, 2, 1), B,
                  Vg_t.numpy())
    assert np.abs(G - np.eye(12)).max() < 1e-10
    cross = np.abs(np.einsum("bji,bjk,bkl->bil", Vg_t.numpy(), B,
                             np.asarray(Vg_j)))
    assert np.abs(cross - np.eye(12)).max() < 1e-8
    # spectra with a gap after the wanted pairs, where the JAX iterations
    # converge to roundoff
    M = _spd(rng, 40, 0.1)
    K = _with_spectrum(rng, np.r_[1.0:6.0, np.linspace(100.0, 500.0, 35)], M)
    lam_j, _ = je.subspace_eigh(jnp.asarray(K), jnp.asarray(M), 5)
    lam_t, V = pt.subspace_eigh(torch.tensor(K), torch.tensor(M), 5)
    assert rel_err(lam_t, lam_j) < 1e-9
    assert np.abs(K @ V.numpy() - M @ V.numpy() * lam_t.numpy()).max() \
        < 1e-9 * np.abs(K).max()
    S = _with_spectrum(rng, np.r_[np.linspace(-5.0, 5.0, 36),
                                  70.0, 80.0, 90.0, 100.0])
    lam_j, _ = je.subspace_largest(jnp.asarray(S), 4)
    lam_t, V = pt.subspace_largest(torch.tensor(S), 4)
    assert lam_t[0] >= lam_t[-1]
    assert rel_err(lam_t, lam_j) < 1e-9
    assert np.abs(S @ V.numpy() - V.numpy() * lam_t.numpy()).max() \
        < 1e-10 * np.abs(S).max()
