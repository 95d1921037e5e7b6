"""PyTorch port vs the JAX package: the dense design tier — the dense
``design_envelope``, ``parallel.sweep.design_sweep`` / ``critical_case``,
npz persistence (files cross-load between the packages), resumable
envelopes — and ``apparent_period``.  f64 on the CPU, the default jacket,
3 cases; max |port - JAX| / max |JAX| <= 1e-10 per field unless a test
says otherwise."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.parallel import sweep as jsweep
from small_fem_solver_tpu.utils import persist as jpersist
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.parallel import sweep as tsweep
from test_torch_convert import port_case, port_model, port_wave, rel_err

TOL = 1e-10
HS = [4.0, 9.0, 14.0]
BASE = dict(current_dir_deg=38.0, F_axial_kN=25100.0, F_shear_kN=2900.0,
            custom_sw_tonnes=1100.0, sw_mode="custom")
SPRINGS = [1e6, 1e6, 1e6, 1e12, 1e12, 1e12]
ENV_FIELDS = ("ts", "utilization", "max_util_per_phase", "max_util_per_case",
              "member_envelope", "total_morison")


@pytest.fixture(scope="module")
def setup():
    """The default jacket with a conductor, a Stokes-5 batch of 3 waves
    with their own headings, times and a sealed-buoyancy, windy case, in
    both packages."""
    jm = sf.add_appurtenances(sf.default_3leg_jacket(), [
        {"name": "C1", "node1": "A2", "node2": "A3", "D_mm": 700.0,
         "cd_mult": 0.8, "cm_mult": 1.1}])
    jw = jsweep.make_wave_batch(HS, [8.0, 9.4, 11.0], 50.0, U_c=1.7,
                                model="stokes", N=5, n_modes=6,
                                dtype=jnp.float64)
    jc = jsweep.make_case_batch(
        sf.LoadCase(**BASE, buoyancy="sealed", wind_speed_ms=30.0,
                    wind_dir_deg=10.0),
        wave_dir_deg=jnp.asarray([0.0, 38.0, 120.0]),
        t_analysis=jnp.asarray([0.3, 2.1, 5.0]))
    return jm, jw, jc, port_model(jm), port_wave(jw), port_case(jc)


@pytest.mark.parametrize("springs,alpha", [(None, None), (SPRINGS, 1 / 7)])
def test_design_envelope_matches_jax(setup, springs, alpha):
    """The full [C, S, M] utilization and every reduction; on CPU tensors
    the loads run the kernel's plain version (no launch)."""
    jm, jw, jc, tm, tw, tc = setup
    ref = sf.design_envelope(jm, jw, jc, n_steps=8, current_alpha=alpha,
                             support_stiffness=springs)
    before = hk.morison_phase_batch_cuda.launches
    out = pt.design_envelope(tm, tw, tc, n_steps=8, current_alpha=alpha,
                             support_stiffness=springs)
    assert hk.morison_phase_batch_cuda.launches == before
    assert out.utilization.shape == (3, 8, tm.n_members)
    for name in ENV_FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < TOL, name
    np.testing.assert_array_equal(out.critical_phase.numpy(),
                                  np.asarray(ref.critical_phase))
    assert int(out.governing_case) == int(ref.governing_case)


def test_design_envelope_past_kernel_mode_limit_matches_jax(setup):
    """Airy waves padded to 40 modes, past the Morison kernel's 32: the
    JAX package's dense envelope (separable) runs them, and so does the
    port (the plain version, no launch)."""
    jm, _, jc, tm, _, tc = setup
    jw = jsweep.make_wave_batch(HS, [8.0, 9.4, 11.0], 50.0, U_c=1.7,
                                model="airy", n_modes=40, dtype=jnp.float64)
    ref = sf.design_envelope(jm, jw, jc, n_steps=4)
    before = hk.morison_phase_batch_cuda.launches
    out = pt.design_envelope(tm, port_wave(jw), tc, n_steps=4)
    assert hk.morison_phase_batch_cuda.launches == before
    for name in ENV_FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < TOL, name
    assert int(out.governing_case) == int(ref.governing_case)


def test_design_envelope_equals_phase_batches(setup):
    """Case i of the envelope is the separable phase loads of case i
    through the dense solve: the same as ``analyze_phase_batch`` up to its
    pointwise kinematics, exactly so for an Airy wave (1e-10)."""
    _, _, _, tm, _, tc = setup
    waves = pt.make_wave_batch(HS, 9.4, 50.0, U_c=1.7, model="airy",
                               dtype=torch.float64, device="cpu")
    env = pt.design_envelope(tm, waves, tc, n_steps=6)
    for i in range(len(HS)):
        _, batch = pt.analyze_phase_batch(tm, waves.case(i), tc.case(i),
                                          n_steps=6)
        assert rel_err(env.utilization[i], batch.utilization) < TOL


def test_design_envelope_guards(setup):
    _, _, _, tm, tw, tc = setup
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.design_envelope(tm, tw, tc, mesh=object())
    with pytest.raises(ValueError, match="identical across the batch"):
        pt.design_envelope(tm, tw, dataclasses.replace(
            tc, nu=torch.tensor([0.3, 0.25, 0.3])))
    with pytest.raises(ValueError, match="slam"):
        pt.design_envelope(tm, tw, dataclasses.replace(tc, slam_cs=1.0))
    with pytest.raises(ValueError, match="leading case axis"):
        pt.design_envelope(tm, tw.case(0), tc)


@pytest.mark.parametrize("solver,springs", [("chol", None),
                                            ("lu", SPRINGS)])
def test_design_sweep_and_critical_case_match_jax(setup, solver, springs):
    """Every AnalysisResults field with its case axis, and the governing
    case; each case equals its own ``analyze`` (``analyze_ssi``)."""
    jm, jw, jc, tm, tw, tc = setup
    ref = jsweep.design_sweep(jm, jw, jc, solver=solver,
                              support_stiffness=springs)
    out = tsweep.design_sweep(tm, tw, tc, solver=solver,
                              support_stiffness=springs)
    for f in pt.AnalysisResults._fields:
        if f == "morison":
            for g in pt.MorisonLoads._fields:
                assert rel_err(getattr(out.morison, g),
                               getattr(ref.morison, g)) < TOL, g
        elif getattr(ref, f) is None:
            assert getattr(out, f) is None, f
        elif f != "max_displacement_node":
            assert getattr(out, f).shape == np.shape(getattr(ref, f)), f
            assert rel_err(getattr(out, f), getattr(ref, f)) < TOL, f
    np.testing.assert_array_equal(out.max_displacement_node.numpy(),
                                  np.asarray(ref.max_displacement_node))
    crit, jcrit = tsweep.critical_case(out), jsweep.critical_case(ref)
    assert int(crit["index"]) == int(jcrit["index"])
    for k in ("max_utilization", "max_displacement_mm"):
        assert abs(float(crit[k]) / float(jcrit[k]) - 1.0) < TOL
    i = int(crit["index"])
    one = (pt.analyze(tm, tw.case(i), tc.case(i), solver="chol",
                      accel="analytic") if springs is None else
           pt.analyze_ssi(tm, tw.case(i), tc.case(i), springs,
                          accel="analytic"))
    for f in ("U", "reactions", "utilization"):
        assert rel_err(getattr(out, f)[i], getattr(one, f)) < TOL, f
    with pytest.raises(ValueError, match="dense solvers"):
        tsweep.design_sweep(tm, tw, tc, solver="pcg")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsweep.design_sweep(tm, tw, tc, mesh=object())


def test_persist_round_trip_and_cross_package_files(setup, tmp_path):
    """save/load keeps every field, nested MorisonLoads and None fields; a
    file written by the JAX package loads in the port and the reverse."""
    jm, jw, jc, tm, tw, tc = setup
    sweep = tsweep.design_sweep(tm, tw, tc)
    env = pt.design_envelope(tm, tw, tc, n_steps=4)
    cond = env._replace(utilization=None)
    for res in (sweep, env, cond):
        pt.save_results(tmp_path / "port.npz", res)
        back = pt.load_results(tmp_path / "port.npz")
        assert type(back) is type(res)
        for f in res._fields:
            a, b = getattr(res, f), getattr(back, f)
            if f == "morison":
                assert all(torch.equal(x, y) for x, y in zip(a, b))
            elif a is None:
                assert b is None
            else:
                assert torch.equal(a, b), f
        jback = jpersist.load_results(tmp_path / "port.npz")
        assert type(jback).__name__ == type(res).__name__
        for f in res._fields:
            a, b = getattr(back, f), getattr(jback, f)
            if f == "morison":
                a, b = a.nodal_forces, b.nodal_forces
            if a is None:
                assert b is None, f
            else:
                np.testing.assert_array_equal(np.asarray(b), a.numpy())
    jref = sf.design_envelope(jm, jw, jc, n_steps=4)
    jpersist.save_results(tmp_path / "jax.npz", jref)
    back = pt.load_results(tmp_path / "jax.npz")
    for name in ENV_FIELDS:
        assert rel_err(getattr(back, name), getattr(jref, name)) == 0.0, name
    assert rel_err(getattr(back, "utilization"), env.utilization) < TOL
    jpersist.save_results(tmp_path / "jax_sweep.npz",
                          jsweep.design_sweep(jm, jw, jc))
    back = pt.load_results(tmp_path / "jax_sweep.npz")
    assert rel_err(back.morison.nodal_forces, sweep.morison.nodal_forces) \
        < TOL


def test_resumable_envelope_kill_and_resume(setup, tmp_path):
    """A run cut after two chunks returns None; the resumed run skips the
    finished chunks and equals one design_envelope (1e-12); a resume with
    another sweep into the same directory raises."""
    _, _, _, tm, tw, tc = setup
    out_dir = tmp_path / "env"
    assert pt.design_envelope_resumable(tm, tw, tc, out_dir, chunk_size=1,
                                        max_chunks=2, n_steps=4) is None
    assert sorted(p.name for p in out_dir.glob("chunk_*.npz")) == [
        "chunk_0000.npz", "chunk_0001.npz"]
    first = (out_dir / "chunk_0000.npz").stat().st_mtime_ns
    merged = pt.design_envelope_resumable(tm, tw, tc, out_dir, chunk_size=1,
                                          n_steps=4)
    assert (out_dir / "chunk_0000.npz").stat().st_mtime_ns == first
    assert not list(out_dir.glob("*.tmp.npz"))
    one = pt.design_envelope(tm, tw, tc, n_steps=4)
    for name in ENV_FIELDS:
        assert rel_err(getattr(merged, name), getattr(one, name)) < 1e-12
    assert torch.equal(merged.critical_phase, one.critical_phase)
    assert int(merged.governing_case) == int(one.governing_case)
    other = dataclasses.replace(tc, wave_dir_deg=tc.wave_dir_deg + 1.0)
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        pt.design_envelope_resumable(tm, tw, other, out_dir, chunk_size=1,
                                     n_steps=4)
    with pytest.raises(ValueError, match="DIFFERENT sweep"):
        pt.design_envelope_resumable(tm, tw, tc, out_dir, chunk_size=2,
                                     n_steps=4)


def test_resumable_condensed_envelope_matches_one_shot(tmp_path):
    coarse = pt.default_3leg_jacket(device="cpu")
    refined = pt.refine_model(coarse, 2)
    waves = pt.make_wave_batch(HS, 9.4, 50.0, U_c=1.7, model="airy",
                               dtype=torch.float64, device="cpu")
    cases = pt.make_case_batch(pt.LoadCase(**BASE),
                               wave_dir_deg=[0.0, 38.0, 120.0])
    kw = dict(n_steps=4, solve_dtype=torch.float64, kinematics="separable")
    merged = pt.design_envelope_resumable(coarse, waves, cases, tmp_path,
                                          chunk_size=2, refined=refined,
                                          n_seg=2, **kw)
    one = pt.design_envelope_condensed(coarse, refined, 2, waves, cases, **kw)
    assert merged.utilization is None
    for name in ENV_FIELDS[2:]:
        assert rel_err(getattr(merged, name), getattr(one, name)) < 1e-12


def test_apparent_period_matches_jax():
    T = np.array([6.0, 9.4, 12.0, 15.0])
    U = np.array([-1.5, 0.0, 1.2, 2.5])
    ref = np.asarray(sf.apparent_period(jnp.asarray(T), 50.0,
                                        jnp.asarray(U)))
    out = pt.apparent_period(torch.tensor(T), 50.0, torch.tensor(U))
    assert out.dtype == torch.float64 and rel_err(out, ref) < 1e-12
    assert abs(float(pt.apparent_period(9.4, 50.0, 0.0)) - 9.4) < 1e-12
    assert float(pt.apparent_period(9.4, 30.0, 1.0)) > 9.4
