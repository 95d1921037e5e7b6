"""PyTorch port vs the JAX package: irregular seas and the frequency domain.

Same inputs (the 126-DOF default jacket, its 4x refinement, f64 seas drawn
from the same numpy seeds) through the JAX function and the port's; each
test states its tolerance (max |port - JAX| / max |JAX|):

- ``make_random_sea``: phases and headings bit-equal, the rest 1e-14;
- ``sea_surface`` / ``sea_kinematics``: 1e-12;
- ``morison_sea_batch`` (long-crested and spread, none and Wheeler, per-
  member Cd / Cm, a power-law current): 1e-12;
- ``spectral_fatigue_screen`` with the native and the Python rainflow
  counters, each against the JAX package's: 1e-12;
- ``linearized_sea_loads`` and ``spectral_stats``: 1e-10;
- ``sea_scan_prepared``, the quasi-static spectral transfer and response
  and ``sea_response_batch``: 1e-9;
- ``scatter_fatigue`` (two short states), ``scatter_fatigue_spectral``
  (three states) and ``long_term_extremes``: 1e-9 (the levels of the same
  per-state statistics 1e-12);
- the Craig-Bampton paths are in ``test_torch_spectrum_dynamics.py``;
- a mean or MPM stress follows its member's governing circumferential
  point, the argmax of 8 variances; opposite points of a member without
  axial stress variance tie to roundoff, so these are held to the value
  at one of the tied points (``tie_candidates``);
- a PyTorch emulation of the general-mode kernel's arithmetic on its
  packed operands (f64 phase table, folded per-(point, mode) records, the
  f64 matrix-product and the f32 angle-difference forms over zero-padded
  mode chunks) against the plain version: 1e-12.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu import native as j_native
from small_fem_solver_tpu.ops import freqdomain as jfd
from small_fem_solver_tpu.ops import spectrum as jsp
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch import convert
from small_fem_solver_tpu_torch import native as t_native
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.ops import spectrum as tsp
from test_torch_convert import port_case, port_model, rel_err

N_SEG = 4
# the Craig-Bampton paths (test_torch_spectrum_dynamics.py) run on the 2x
# mesh with every chain mode (its 6 interior DOFs), as
# test_torch_dynamics.py does: a cut inside a degenerate bending pair would
# leave the kept basis to roundoff
CB_SEG, CHAIN_MODES = 2, 6
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
SEA = dict(Hs=6.5, Tp=9.4, d=50.0, U_c=0.8)
STATES = ((2.5, 7.5, 0.3), (4.5, 9.0, 0.25, 68.0), (6.5, 10.5, 0.05))


TIED = 1e-9   # m0 of two of a member's 8 points equal to this: a tie


def tie_candidates(stress_mean, stress_cos, stress_sin, scf=1.0):
    """[M, 8] mean stresses of each member's points, NaN where the point is
    not governing: the governing point is the argmax of the 8 variances,
    and where points tie (opposite points of a member whose axial stress
    has no variance have equal m0 up to roundoff) either may govern, in
    the JAX package as in the port, so a mean or MPM stress is held to
    the value at one of the tied points."""
    scf = np.asarray(scf, np.float64)
    scf = scf[:, None] if scf.ndim == 1 else scf
    sc, ss = np.asarray(stress_cos) * scf, np.asarray(stress_sin) * scf
    m0 = 0.5 * np.sum(sc**2 + ss**2, axis=0)
    gov = m0 >= m0.max(axis=-1, keepdims=True) * (1.0 - TIED)
    return np.where(gov, np.asarray(stress_mean) * scf, np.nan)


def tie_err(mean, candidates) -> float:
    """max over members of the distance of ``mean`` to its nearest tied
    candidate, over the largest |candidate|."""
    d = np.nanmin(np.abs(np.asarray(mean)[..., None] - candidates), axis=-1)
    return float(d.max() / np.nanmax(np.abs(candidates)))


def assert_stats(out, ref, rows, tol, scf=1.0, fy=355.0):
    """``out`` against ``ref`` (FreqDomainResponse) at ``tol``, the mean
    and MPM stresses to one of the tied governing points of the JAX
    transfer ``rows`` (``tie_candidates``)."""
    for name in out._fields:
        if name not in ("mean_stress", "mpm_stress", "mpm_utilization"):
            assert rel_err(getattr(out, name), getattr(ref, name)) < tol, name
    cand = tie_candidates(rows.stress_mean, rows.stress_cos, rows.stress_sin,
                          scf)
    assert tie_err(out.mean_stress, cand) < tol
    peak = np.asarray(ref.mpm_stress) - np.abs(np.asarray(ref.mean_stress))
    assert rel_err(out.mpm_stress - out.mean_stress.abs(), peak) < tol
    assert rel_err(out.mpm_utilization * fy, out.mpm_stress) < 1e-14


def port_sea(s):
    """The port's copy of a JAX sea."""
    return convert.sea_from_numpy(
        *(np.asarray(getattr(s, f)) for f in ("omega", "k", "a", "phi", "E",
                                              "U", "d", "U_c", "Hs", "Tp")),
        dir_deg=None if s.dir_deg is None else np.asarray(s.dir_deg),
        spectrum=s.spectrum, device="cpu")


def make_jacket(n_seg: int) -> dict:
    """The default jacket and its ``n_seg``-fold refinement with their
    prepared handles, a long-crested and a spread sea, in both
    packages."""
    jc = sf.default_3leg_jacket()
    jr = sf.refine_model(jc, n_seg)
    tc, tr = port_model(jc), port_model(jr)
    seas = {}
    for label, kw in (("long", {}), ("spread", dict(spreading_s=4.0))):
        js = sf.make_random_sea(SEA["Hs"], SEA["Tp"], SEA["d"],
                                n_components=16, seed=3, U_c=SEA["U_c"],
                                **kw)
        seas[label] = (js, port_sea(js))
    return dict(jc=jc, jr=jr, tc=tc, tr=tr,
                jprep=sf.prepare_condensed(jc, jr, n_seg),
                tprep=pt.prepare_condensed(tc, tr, n_seg), seas=seas)


@pytest.fixture(scope="module")
def jacket():
    return make_jacket(N_SEG)


@pytest.mark.parametrize("spreading_s,spectrum,n", [
    (None, "jonswap", 64), (4.0, "jonswap", 37), (None, "pm", 12)])
def test_make_random_sea_matches_jax(spreading_s, spectrum, n):
    """Phases and headings bit-equal (the same numpy draws), frequencies,
    wavenumbers, amplitudes and velocity coefficients within 1e-14."""
    js = sf.make_random_sea(7.0, 10.0, 50.0, n_components=n, seed=11,
                            spectrum=spectrum, U_c=0.5,
                            spreading_s=spreading_s)
    ts = pt.make_random_sea(7.0, 10.0, 50.0, n_components=n, seed=11,
                            spectrum=spectrum, U_c=0.5,
                            spreading_s=spreading_s, device="cpu")
    np.testing.assert_array_equal(ts.phi.numpy(), np.asarray(js.phi))
    if spreading_s is None:
        assert ts.dir_deg is None and js.dir_deg is None
    else:
        np.testing.assert_array_equal(ts.dir_deg.numpy(),
                                      np.asarray(js.dir_deg))
    for name in ("omega", "k", "a", "E", "U", "d", "U_c", "Hs", "Tp"):
        assert rel_err(getattr(ts, name), getattr(js, name)) < 1e-14, name
    assert rel_err(ts.m0, js.m0) < 1e-14
    assert rel_err(ts.mean_zero_crossing_period,
                   js.mean_zero_crossing_period) < 1e-14
    assert ts.n_modes == n and ts.spectrum == spectrum
    with pytest.raises(ValueError, match="spectrum"):
        pt.make_random_sea(7.0, 10.0, 50.0, spectrum="bretschneider",
                           device="cpu")
    with pytest.raises(ValueError, match="spreading_s"):
        pt.make_random_sea(7.0, 10.0, 50.0, spreading_s=0.0, device="cpu")


def test_sea_surface_and_kinematics_match_jax(jacket):
    """eta of both seas and the long-crested kinematics at 1e-12."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-30.0, 30.0, 200)
    y = rng.uniform(-30.0, 30.0, 200)
    z = rng.uniform(-50.0, 6.0, 200)
    t = rng.uniform(0.0, 600.0, 200)
    for label in ("long", "spread"):
        js, ts = jacket["seas"][label]
        assert rel_err(pt.sea_surface(ts, x, t, y, 38.0),
                       jsp.sea_surface(js, x, t, y, 38.0)) < 1e-12, label
    js, ts = jacket["seas"]["long"]
    out, ref = pt.sea_kinematics(ts, x, z, t), jsp.sea_kinematics(js, x, z, t)
    for name in ("u", "w", "du_dt", "dw_dt", "eta"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-12, name
    np.testing.assert_array_equal(out.submerged.numpy(),
                                  np.asarray(ref.submerged))
    assert 0 < int(out.submerged.sum()) < 200
    with pytest.raises(ValueError, match="long-crested"):
        pt.sea_kinematics(jacket["seas"]["spread"][1], x, z, t)


def _member_coefs(M):
    rng = np.random.default_rng(9)
    return rng.uniform(0.6, 1.1, M), rng.uniform(1.6, 2.1, M)


@pytest.mark.parametrize("label,stretching,alpha", [
    ("long", "none", None), ("long", "wheeler", 1.0 / 7.0),
    ("spread", "none", None), ("spread", "wheeler", None)])
def test_morison_sea_batch_matches_jax(jacket, label, stretching, alpha):
    """The sea's phase batch on the 4x mesh with per-member Cd / Cm, 96
    samples over 180 s (wet and dry points at the surface): every field at
    1e-12."""
    js, ts_ = jacket["seas"][label]
    jr, tr = jacket["jr"], jacket["tr"]
    Cd, Cm = _member_coefs(tr.n_members)
    D = np.asarray(jr.sections.D_outer)[np.asarray(jr.sect_id)] / 1000.0
    times = np.linspace(0.0, 180.0, 96)
    kw = dict(n_gauss=15, current_alpha=alpha, stretching=stretching)
    ref = jsp.morison_sea_batch(js, jr.coords, jr.conn, D, 38.0, 50.0, Cd, Cm,
                                1025.0, times, **kw)
    out = pt.morison_sea_batch(ts_, tr.coords, tr.conn, torch.tensor(D), 38.0,
                               50.0, torch.tensor(Cd), torch.tensor(Cm),
                               1025.0, torch.tensor(times), **kw)
    for name in ("nodal_forces", "total_drag", "total_inertia",
                 "total_morison", "F1", "F2"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-12, name


@pytest.mark.parametrize("counter", ["native", "python"])
def test_spectral_fatigue_screen_matches_jax(jacket, counter, monkeypatch):
    """The screen of a seeded random stress history with per-member scf,
    with the native rainflow counter and with the Python stack, each
    against the JAX package's own counter of the same kind (1e-12)."""
    if counter == "native":
        if not (t_native.available() and j_native.available()):
            pytest.skip("no C++ compiler for the native rainflow counter")
    else:
        monkeypatch.setattr(t_native, "rainflow_damage_sums_native",
                            lambda *a: None)
        monkeypatch.setattr(j_native, "rainflow_damage_sums_native",
                            lambda *a: None)
    rng = np.random.default_rng(1)
    S, M = 300, 9
    t = np.arange(S)[:, None] * 0.5
    vm = (40.0 + 12.0 * np.sin(0.7 * t + rng.uniform(0, 6, M))
          + 5.0 * np.sin(2.3 * t) + rng.normal(0, 2.0, (S, M)))
    vm[:, 4] = 30.0                       # a member with no stress range
    scf = rng.uniform(1.0, 2.5, M)
    out = pt.spectral_fatigue_screen(torch.tensor(vm), 0.5, 25.0,
                                     curve="D-sea-cp", scf=scf,
                                     occurrence=0.4)
    ref = jsp.spectral_fatigue_screen(vm, 0.5, 25.0, curve="D-sea-cp",
                                      scf=scf, occurrence=0.4)
    for name in ("sigma_mpa", "nu0_hz", "damage_rayleigh",
                 "damage_rainflow"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-12, name
    for name in ("life_years_rayleigh", "life_years_rainflow"):
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        assert rel_err(a[~np.isinf(a)], b[~np.isinf(b)]) < 1e-12
    assert float(out.damage_rainflow[4]) == 0.0
    # both counters agree with each other exactly in the port
    r, wt = tsp._rainflow_ranges(vm[:, 0])
    assert r.shape == wt.shape and r.size > 0
    with pytest.raises(ValueError, match="S-N curve"):
        pt.spectral_fatigue_screen(vm, 0.5, 25.0, curve="X")


def test_linearized_loads_and_stats_match_jax(jacket):
    """Borgman-linearized load rows (spread sea, power-law current, per-
    member Cd / Cm) and the closed-form statistics of random transfer rows
    at 1e-10."""
    js, ts_ = jacket["seas"]["spread"]
    jr, tr = jacket["jr"], jacket["tr"]
    Cd, Cm = _member_coefs(tr.n_members)
    D = np.asarray(jr.sections.D_outer)[np.asarray(jr.sect_id)] / 1000.0
    ref = jfd.linearized_sea_loads(js, jr.coords, jr.conn, D, 38.0, 50.0,
                                   Cd, Cm, 1025.0, current_alpha=0.14)
    out = pt.linearized_sea_loads(ts_, tr.coords, tr.conn, torch.tensor(D),
                                  38.0, 50.0, torch.tensor(Cd),
                                  torch.tensor(Cm), 1025.0,
                                  current_alpha=0.14)
    for name in out._fields:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-10, name

    rng = np.random.default_rng(2)
    N, M, n_dof = 16, 20, 60
    omega = np.linspace(0.4, 2.0, N)
    rows = dict(stress_mean=rng.normal(size=(M, 8)),
                stress_cos=rng.normal(size=(N, M, 8)),
                stress_sin=rng.normal(size=(N, M, 8)),
                U_mean=rng.normal(size=n_dof),
                U_cos=rng.normal(size=(N, n_dof)),
                U_sin=rng.normal(size=(N, n_dof)),
                totals=rng.normal(size=(2 * N + 1, 3)))
    moment = rng.normal(size=(2 * N + 1, 3))
    scf = rng.uniform(1.0, 2.0, M)
    args = (355.0, 10800.0, 25.0)
    ref = jfd.spectral_stats(omega, *rows.values(), *args, scf=scf,
                             occurrence=0.3, totals_moment=moment)
    out = pt.spectral_stats(torch.tensor(omega),
                            *(torch.tensor(v) for v in rows.values()),
                            *args, scf=torch.tensor(scf), occurrence=0.3,
                            totals_moment=torch.tensor(moment))
    for name in out._fields:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-10, name


def test_sea_scan_prepared_matches_jax(jacket):
    """The random-sea scan on the prepared 4x handle (Wheeler, 128
    samples at Tp / 10) at 1e-9, and the screen of its history."""
    js, ts_ = jacket["seas"]["long"]
    case = sf.LoadCase(**STORM)
    times = np.arange(128) * 0.94
    ref = sf.sea_scan_prepared(jacket["jprep"], js, case, times,
                               stretching="wheeler")
    out = pt.sea_scan_prepared(jacket["tprep"], ts_, port_case(case), times,
                               stretching="wheeler")
    for name in ("ts", "U", "von_mises", "utilization", "reactions",
                 "total_morison"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name
    assert int(out.critical_index) == int(ref.critical_index)
    with pytest.raises(ValueError, match="slamming"):
        pt.sea_scan_prepared(jacket["tprep"], ts_,
                             pt.LoadCase(**STORM, slam_cs=3.14), times)


def test_spectral_transfer_and_response_prepared_match_jax(jacket):
    """The 2N+1 quasi-static transfer rows (spread sea, wind and calculated
    self-weight in the mean row only) and the closed-form response with a
    per-member scf, at 1e-9."""
    js, ts_ = jacket["seas"]["spread"]
    case = sf.LoadCase(**{**STORM, "sw_mode": "calculated"},
                       wind_speed_ms=30.0, wind_dir_deg=38.0)
    scf = np.random.default_rng(4).uniform(1.0, 2.0, jacket["tr"].n_members)
    rows = sf.spectral_transfer_prepared(jacket["jprep"], js, case)
    out = pt.spectral_transfer_prepared(jacket["tprep"], ts_, port_case(case))
    for name in out._fields:
        assert rel_err(getattr(out, name), getattr(rows, name)) < 1e-9, name
    ref = sf.spectral_response_prepared(jacket["jprep"], js, case,
                                        exposure_years=25.0, scf=scf,
                                        occurrence=0.5)
    out = pt.spectral_response_prepared(jacket["tprep"], ts_, port_case(case),
                                        exposure_years=25.0,
                                        scf=torch.tensor(scf),
                                        occurrence=0.5)
    assert_stats(out, ref, rows, 1e-9, scf)


def test_sea_response_batch_matches_jax(jacket):
    """The dense-model sea response, clamped and on springs, at 1e-9."""
    js, ts_ = jacket["seas"]["long"]
    case = sf.LoadCase(**STORM)
    times = np.arange(64) * 0.94
    for springs in (None, [1e6] * 3 + [1e12] * 3):
        ref = sf.sea_response_batch(jacket["jc"], js, case, times,
                                    stretching="wheeler",
                                    support_stiffness=springs)
        out = pt.sea_response_batch(jacket["tc"], ts_, port_case(case), times,
                                    stretching="wheeler",
                                    support_stiffness=springs)
        for name in ("ts", "U", "von_mises", "utilization", "reactions",
                     "total_morison"):
            assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, \
                (springs, name)


def test_sea_response_batch_past_kernel_gauss_limit_matches_jax(jacket):
    """n_gauss = 20, past the Morison kernel's 16 Gauss points: the port
    runs the plain version (the JAX package's separable engine takes any
    count), with no launch, at 1e-9."""
    js, ts_ = jacket["seas"]["long"]
    case = sf.LoadCase(**STORM)
    times = np.arange(16) * 0.94
    before = hk.morison_phase_batch_cuda.launches
    ref = sf.sea_response_batch(jacket["jc"], js, case, times, n_gauss=20)
    out = pt.sea_response_batch(jacket["tc"], ts_, port_case(case), times,
                                n_gauss=20)
    assert hk.morison_phase_batch_cuda.launches == before
    for name in ("U", "von_mises", "utilization", "reactions",
                 "total_morison"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name


def test_scatter_fatigue_matches_jax(jacket):
    """The time-domain scatter over two short states (one with its own
    heading), 12 components and 64 steps each, at 1e-9."""
    case = sf.LoadCase(**STORM)
    states = STATES[:2]
    kw = dict(n_components=12, n_steps=64, seed=5, U_c=0.5)
    ref = sf.scatter_fatigue(jacket["jprep"], case, states, 50.0, 25.0, **kw)
    out = pt.scatter_fatigue(jacket["tprep"], port_case(case), states, 50.0,
                             25.0, **kw)
    for name in ("damage_rainflow", "damage_rayleigh", "per_state_rainflow"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name
    assert out.states == ref.states
    with pytest.raises(ValueError, match="sum to"):
        pt.scatter_fatigue(jacket["tprep"], port_case(case),
                           ((2.0, 8.0, 0.7), (3.0, 9.0, 0.6)), 50.0, 1.0)


def check_scatter_spectral(jp, tp, jc, jr, seg, dynamic: bool, tol: float):
    """``scatter_fatigue_spectral`` over three states (one with its own
    heading) through the JAX handle ``jp`` and the port's ``tp`` (mesh
    ``jr``, ``seg`` segments), then the long-term extremes: the damages,
    deviations and rates at ``tol``, each state's means to a tied governing
    point of its JAX rows, the MPM utilization from those, the long-term
    levels of the same per-state statistics at 1e-12."""
    case = sf.LoadCase(**STORM)
    kw = dict(n_components=12, seed=2, U_c=0.5, dynamic=dynamic,
              n_chain_modes=CHAIN_MODES)
    ref = sf.scatter_fatigue_spectral(jp, case, STATES, 50.0, 25.0, **kw)
    out = pt.scatter_fatigue_spectral(tp, port_case(case), STATES, 50.0,
                                      25.0, **kw)
    for name in ("damage_nb", "damage_wl", "per_state_wl", "per_state_sigma",
                 "per_state_nu0"):
        assert rel_err(getattr(out, name), getattr(ref, name)) < tol, name
    for i, row in enumerate(STATES):
        sea = sf.make_random_sea(row[0], row[1], 50.0, n_components=12,
                                 seed=2 + i, U_c=0.5)
        head = row[3] if len(row) == 4 else STORM["wave_dir_deg"]
        case_i = dataclasses.replace(case, wave_dir_deg=head,
                                     current_dir_deg=head)
        rows = (sf.spectral_transfer_dynamic(
            jc, jr, seg, sea, case_i, n_chain_modes=CHAIN_MODES, prep=jp)
            if dynamic else sf.spectral_transfer_prepared(jp, sea, case_i))
        cand = tie_candidates(rows.stress_mean, rows.stress_cos,
                              rows.stress_sin)
        assert tie_err(out.per_state_mean[i], cand) < tol
    g = np.sqrt(2.0 * np.log(np.maximum(ref.per_state_nu0 * 3.0 * 3600.0,
                                        1.0 + 1e-9)))
    mpm = (np.abs(out.per_state_mean) + ref.per_state_sigma * g) / 355.0
    assert rel_err(out.mpm_utilization, mpm.max(axis=0)) < tol
    lt_ref = sf.long_term_extremes(ref, return_years=(1.0, 100.0))
    lt = pt.long_term_extremes(ref, return_years=(1.0, 100.0))
    assert rel_err(lt.stress_mpa, lt_ref.stress_mpa) < 1e-12
    np.testing.assert_array_equal(lt.governing_state, lt_ref.governing_state)
    lt = pt.long_term_extremes(out, return_years=(1.0, 100.0))
    assert np.isfinite(lt.stress_mpa).all()
    assert (lt.stress_mpa[1] >= lt.stress_mpa[0]).all()
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.scatter_fatigue_spectral(tp, port_case(case), STATES, 50.0,
                                    25.0, mesh=object())


def test_scatter_fatigue_spectral_and_extremes_match_jax(jacket):
    """The quasi-static frequency-domain scatter on the 4x mesh and its
    long-term extremes at 1e-9 (the Craig-Bampton form:
    ``test_torch_spectrum_dynamics.py``)."""
    check_scatter_spectral(jacket["jprep"], jacket["tprep"], jacket["jc"],
                           jacket["jr"], N_SEG, False, 1e-9)


SEA_CHUNK = 16   # modes of one pipeline stage of the general-mode kernel


def sea_field_factors(k: dict, hx, hy, UC, US, wheeler: bool):
    """The general-mode kernel's folded records (``sea_fold`` in
    ``csrc/morison_phase_batch.cu``): per field its per-(point, mode)
    factor c_f [M, Q, N] from the per-mode heading weights ``hx``, ``hy``
    [N] (1 and 0 for a long-crested sea) and U C(z), U S(z) [M, Q, N]; the
    cos-type fields (summed against cos(k x + phi - omega t)) first, then
    the sin-type ones, as (name, kind, c_f)."""
    E, om, kj = k["E"].double(), k["omega"].double(), k["k"].double()
    spread = k["dir"] is not None
    kUC, kUS = kj * UC, kj * US
    k2UC, k2US = kj * kUC, kj * kUS
    cos = [("eta", E.expand_as(UC)), ("ux", hx * UC), ("dw", -om * US)]
    sin = [("w", US), ("dux", hx * (om * UC))]
    if spread:
        cos.append(("uy", hy * UC))
        sin.append(("duy", hy * (om * UC)))
    if wheeler:
        cos += [("ux_z", hx * kUS), ("dw_z", -om * kUC),
                ("ux_zz", hx * k2UC), ("dw_zz", -om * k2US)]
        sin += [("w_z", kUC), ("dux_z", hx * (om * kUS)), ("w_zz", k2US),
                ("dux_zz", hx * (om * k2UC))]
        if spread:
            cos += [("uy_z", hy * kUS), ("uy_zz", hy * k2UC)]
            sin += [("duy_z", hy * (om * kUS)), ("duy_zz", hy * (om * k2UC))]
    return ([(n, "cos", c) for n, c in cos]
            + [(n, "sin", c) for n, c in sin])


def emulate_sea_kernel(k: dict, wheeler: bool, form: str):
    """The general-mode kernel's arithmetic on its packed operands
    (``hopper_kernels.sea_kernel_operands``), in f64 PyTorch: per (member,
    point) the records cos / sin(k x + phi) and the folded field factors
    (``sea_field_factors``); the mode sums over the f64 phase table in
    chunks of ``SEA_CHUNK`` modes, the last one zero-padded, in the f64
    instance's matrix-product form (``form="matrix"``: A = the chunk's
    (cos, sin) table columns [S, 2 x 16], B = the coefficient rows c cos,
    c sin (cos-type) or c sin, -c cos (sin-type) [2 x 16, points x F]) or
    the f32 instance's angle-difference form (``form="angle"``: cp, sp
    per (phase, point, mode), then one product per field); then Wheeler's
    Taylor rows with the kernel's +-d clip, the wet mask, drag and
    inertia, the member sums over its points in order and F1 = sum f -
    F2.  Returns (F1, F2, totals [S, 6])."""
    f64 = torch.float64
    coords, conn = k["coords"].double(), k["conn"]
    M, S, N = conn.shape[0], k["ts"].shape[0], k["E"].shape[0]
    s = torch.tensor(np.asarray(k["s"], np.float64))
    w = torch.tensor(np.asarray(k["w"], np.float64))
    d, Uc = k["d"].double(), k["Uc"].double()

    def num(v):
        return torch.as_tensor(v, dtype=f64)
    wave_dir, cur_dir = num(k["wave_dir"]), num(k["current_dir"])
    sin_w, cos_w = (torch.sin(torch.pi * (90 - wave_dir) / 180),
                    torch.cos(torch.pi * (90 - wave_dir) / 180))
    sin_c, cos_c = (torch.sin(torch.pi * (90 - cur_dir) / 180),
                    torch.cos(torch.pi * (90 - cur_dir) / 180))
    x1 = coords[conn[:, 0]]
    dx = coords[conn[:, 1]] - x1
    L = torch.linalg.norm(dx, dim=-1)
    e = dx / L[:, None]
    pts = x1[:, None, :] + s[None, :, None] * dx[:, None, :]   # [M, Q, 3]
    spread = k["dir"] is not None
    if spread:
        th = torch.pi * (90 - (wave_dir + k["dir"].double())) / 180
        hx, hy = torch.cos(th), torch.sin(th)                  # [N]
        proj = pts[..., 0:1] * hx + pts[..., 1:2] * hy
    else:
        hx, hy = torch.ones(N, dtype=f64), torch.zeros(N, dtype=f64)
        proj = (pts[..., 0] * cos_w + pts[..., 1] * sin_w)[..., None]
    kj = k["k"].double()
    arg = kj * proj + k["phi"].double()
    cx, sx = torch.cos(arg), torch.sin(arg)                    # [M, Q, N]
    z = pts[..., 2]
    A = kj * (z[..., None] + d)
    B = kj * d
    Aa = A.abs()
    scale = torch.exp(Aa - B) / (1 + torch.exp(-2 * B))
    UC = k["U"].double() * scale * (1 + torch.exp(-2 * Aa))
    US = k["U"].double() * torch.sign(A) * scale * (1 - torch.exp(-2 * Aa))
    fac = sea_field_factors(k, hx, hy, UC, US, wheeler)
    c = torch.stack([f for _, _, f in fac], -1)                # [M, Q, N, F]
    is_cos = torch.tensor([kind == "cos" for _, kind, _ in fac])
    n_pad = -N % SEA_CHUNK                                     # zero modes
    ph = k["phase"].double()
    ct = torch.nn.functional.pad(ph[:, :N], (0, n_pad))        # [S, Np]
    st = torch.nn.functional.pad(ph[:, N:], (0, n_pad))
    c = torch.nn.functional.pad(c, (0, 0, 0, n_pad))
    cx = torch.nn.functional.pad(cx, (0, n_pad))
    sx = torch.nn.functional.pad(sx, (0, n_pad))
    acc = torch.zeros(S, M, z.shape[1], len(fac), dtype=f64)
    for j0 in range(0, N + n_pad, SEA_CHUNK):
        ch = slice(j0, j0 + SEA_CHUNK)
        cxc, sxc, cc = cx[..., ch, None], sx[..., ch, None], c[..., ch, :]
        if form == "matrix":
            Bc = torch.where(is_cos, cc * cxc, cc * sxc)       # [M, Q, 16, F]
            Bs = torch.where(is_cos, cc * sxc, -(cc * cxc))
            Ac = torch.stack([ct[:, ch], st[:, ch]], -1)       # [S, 16, 2]
            Bk = torch.stack([Bc, Bs], 3)                      # [M, Q, 16, 2, F]
            acc += torch.einsum("sjc,mqjcf->smqf", Ac, Bk)
        else:
            ctc, stc = ct[:, None, None, ch], st[:, None, None, ch]
            cp = cxc[None, ..., 0] * ctc + sxc[None, ..., 0] * stc
            sp = sxc[None, ..., 0] * ctc - cxc[None, ..., 0] * stc
            acc += (torch.where(is_cos, cp[..., None], sp[..., None])
                    * cc[None]).sum(3)
    fl = {n: acc[..., i] for i, (n, _, _) in enumerate(fac)}
    eta, ux, w_, dux, dw = (fl[n] for n in ("eta", "ux", "w", "dux", "dw"))
    if spread:
        uy, duy = fl["uy"], fl["duy"]
    if wheeler:
        dz = torch.clamp(-(z + d) * eta / (d + eta), -d, d)
        h2 = 0.5 * dz * dz

        def stretch(n):
            return fl[n] + dz * fl[n + "_z"] + h2 * fl[n + "_zz"]
        ux, w_, dux, dw = (stretch(n) for n in ("ux", "w", "dux", "dw"))
        if spread:
            uy, duy = stretch("uy"), stretch("duy")
    if not spread:
        uy, duy = ux * sin_w, dux * sin_w
        ux, dux = ux * cos_w, dux * cos_w
    uc = Uc
    if k["alpha"] is not None:
        uc = Uc * torch.clamp((z + d) / d, 0, 1) ** num(k["alpha"])
    wet = (z <= eta).double()
    U = torch.stack([ux + uc * cos_c, uy + uc * sin_c, w_], -1)
    Acc = torch.stack([dux, duy, dw], -1)
    eb = e[None, :, None, :]
    Up = U - (U * eb).sum(-1, keepdim=True) * eb
    Ap = Acc - (Acc * eb).sum(-1, keepdim=True) * eb
    Umag = torch.linalg.norm(Up, dim=-1)
    D = k["D"].double()[:, None]
    Lw = L[:, None] * w[None, :]
    cd = 0.5 * num(k["rho"]) * torch.as_tensor(k["Cd"], dtype=f64)[:, None] \
        * D * Lw
    ci = num(k["rho"]) * torch.as_tensor(k["Cm"], dtype=f64)[:, None] \
        * (math.pi * D * D / 4) * Lw
    g = (torch.where(Umag > 1e-10, cd * Umag, 0.0) * wet)[..., None] * Up
    i = (ci * wet)[..., None] * Ap
    f2 = (s[None, None, :, None] * (g + i)).sum(2)
    F1 = (g + i).sum(2) - f2
    totals = torch.cat([g.sum((1, 2)), i.sum((1, 2))], -1)
    return F1, f2, totals


@pytest.mark.parametrize("label,wheeler,alpha,N,S", [
    ("long", True, None, 37, 45), ("spread", False, 1.0 / 7.0, 33, 64),
    ("spread", True, None, 16, 31)])
def test_sea_kernel_operand_emulation(jacket, label, wheeler, alpha, N, S):
    """The general-mode kernel's packed operands (f64 phase table, per-mode
    arrays, per-member Cd / Cm) through an emulation of its arithmetic in
    both forms (the f64 instance's matrix product over zero-padded mode
    chunks, the f32 instance's angle differences) against the plain
    version at 1e-12; N off the 16-mode chunk (37, 33), S off the 64- and
    128-phase tiles."""
    js = sf.make_random_sea(6.5, 9.4, 50.0, n_components=N, seed=4,
                            U_c=0.8, spreading_s=None if label == "long"
                            else 4.0)
    ts_ = port_sea(js)
    tr = jacket["tr"]
    Cd, Cm = (torch.tensor(c) for c in _member_coefs(tr.n_members))
    D = tr.sections.D_outer[tr.sect_id] / 1000.0
    times = torch.arange(S, dtype=torch.float64) * 1.7
    k = hk.sea_kernel_operands(ts_, tr.coords, tr.conn, D, 38.0, 50.0, Cd, Cm,
                               1025.0, times, 15, alpha)
    assert k["phase"].shape == (S, 2 * N) and k["phase"].is_contiguous()
    ref = tsp.morison_sea_end_forces(
        ts_, tr.coords, tr.conn, D, 38.0, 50.0, Cd, Cm, 1025.0, times,
        current_alpha=alpha, stretching="wheeler" if wheeler else "none")
    for form in ("matrix", "angle"):
        F1, F2, totals = emulate_sea_kernel(k, wheeler, form)
        assert rel_err(F1, ref[0]) < 1e-12, form
        assert rel_err(F2, ref[1]) < 1e-12, form
        assert rel_err(totals, torch.cat(ref[2:], -1)) < 1e-12, form
    # the wrapper's contract on the CPU: the plain version; mixed dtypes
    # raise at the kernel's operand check
    out = hk.morison_sea_end_forces_cuda(
        ts_, tr.coords, tr.conn, D, 38.0, 50.0, Cd, Cm, 1025.0, times,
        current_alpha=alpha, stretching="wheeler" if wheeler else "none")
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(TypeError, match="mixed dtypes"):
        hk.sea_kernel_operands(ts_.to(torch.float32), tr.coords, tr.conn, D,
                               38.0, 50.0, Cd, Cm, 1025.0, times, 15, alpha)
    with pytest.raises(RuntimeError, match="CUDA"):
        hk.launch_morison_sea(k, wheeler)
