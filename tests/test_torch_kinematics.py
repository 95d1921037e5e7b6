"""PyTorch port vs the JAX package: Stokes waves, automatic wave-model
selection, pointwise kinematics, pointwise Morison loads and the Morison
phase scan (f64, CPU).

Tolerances (max |port - JAX| / max |JAX|): 1e-10 for wave coefficients,
kinematics with analytic acceleration and Morison loads; 1e-8 for the
finite-difference acceleration, which divides a velocity difference by
dt = 1e-3 and so amplifies sum-order rounding a thousandfold.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops.wave_models import airy_steepness as j_steep
from small_fem_solver_tpu.ops.waves import surface_velocity as j_surf_vel
from small_fem_solver_tpu.parallel.sweep import make_wave_batch as j_batch
import small_fem_solver_tpu_torch as pt
from test_torch_convert import port_model, port_wave, rel_err

TOL = 1e-10
TOL_FD = 1e-8
WAVE_FIELDS = ("k", "omega", "c", "d", "U_c", "H", "T", "E", "U")
WAVES = {   # (H, T, d, U_c, model, N)
    "airy": (9.5, 9.4, 50.0, 1.2, "airy", 1),
    "stokes": (12.0, 9.4, 50.0, 1.2, "stokes", 5),
    "fenton": (17.038, 9.4, 50.0, 1.7, "fenton", 12),
}


@pytest.fixture(scope="module")
def jax_waves():
    return {name: sf.make_wave(H, T, d, U_c=U_c, model=model, N=N)
            for name, (H, T, d, U_c, model, N) in WAVES.items()}


def _assert_wave(tw, jw, tol=TOL):
    for f in WAVE_FIELDS:
        assert rel_err(getattr(tw, f), getattr(jw, f)) < tol, f
    assert (tw.clamp_z, tw.model, tw.order, tw.n_modes) == \
        (jw.clamp_z, jw.model, jw.order, jw.E.shape[-1])


@pytest.mark.parametrize("order", [1, 2, 3, 4, 5])
def test_stokes_wave_matches_jax(order):
    """Fenton's (1985) fifth-order theory truncated at each order, in
    shallow-ish water (k d ~ 1.1) where the coefficients are large."""
    args = (6.0, 11.0, 30.0, 0.8)
    tw = pt.stokes_wave(*args, order=order, n_modes=7, device="cpu")
    jw = sf.stokes_wave(*args, order=order, n_modes=7)
    _assert_wave(tw, jw)
    assert tw.model_info() == jw.model_info()
    f32 = pt.stokes_wave(*args, order=order, dtype=torch.float32,
                         device="cpu")
    assert f32.E.dtype == torch.float32 and rel_err(f32.E, tw.E[:5]) < 1e-6


# steepness ~0.005 (airy), ~0.02 (stokes 3), ~0.045 (stokes 5), ~0.12
# (fenton N = 20), and a breaking case for validate_wave
@pytest.mark.parametrize("H,T,d", [(0.6, 9.4, 50.0), (2.5, 9.4, 50.0),
                                   (6.0, 9.4, 50.0), (12.0, 8.0, 50.0),
                                   (12.0, 5.0, 14.0)])
def test_auto_wave_selection_matches_jax(H, T, d):
    assert abs(pt.airy_steepness(H, T, d) - j_steep(H, T, d)) < 1e-14
    msgs = pt.validate_wave(H, T, d)
    assert msgs == sf.validate_wave(H, T, d)
    if msgs:
        with pytest.raises(ValueError, match="breaking"):
            pt.validate_wave(H, T, d, strict=True)
        return
    jw = sf.make_wave(H, T, d, U_c=1.0)
    tw = pt.make_wave(H, T, d, U_c=1.0, device="cpu")
    _assert_wave(tw, jw, tol=1e-9)


def test_stokes_wave_batch_matches_jax():
    Hs = [6.0, 9.0, 12.0]
    tw = pt.make_wave_batch(Hs, [8.0, 9.4, 11.0], 50.0, U_c=1.2,
                            model="stokes", N=5, n_modes=8,
                            dtype=torch.float64, device="cpu")
    jw = j_batch(Hs, [8.0, 9.4, 11.0], 50.0, U_c=1.2, model="stokes", N=5,
                 n_modes=8, dtype=jnp.float64)
    _assert_wave(tw, jw)


def _points(wave, n=400, seed=0):
    """Points over the whole water column and above the crest, at random
    times, plus points hugging the surface (the clamp band)."""
    rng = np.random.default_rng(seed)
    d, H = float(wave.d), float(wave.H)
    x = rng.uniform(-60.0, 60.0, n)
    t = rng.uniform(0.0, float(wave.T), n)
    z = rng.uniform(-d, 0.7 * H, n)
    eta = np.asarray(sf.surface_elevation(wave, x, t))
    z[: n // 4] = eta[: n // 4] - rng.uniform(0.0, 0.02, n // 4)
    return x, z, t


@pytest.mark.parametrize("name", list(WAVES))
@pytest.mark.parametrize("stretching", ["none", "wheeler"])
@pytest.mark.parametrize("accel", ["fd", "analytic"])
def test_kinematics_matches_jax(jax_waves, name, stretching, accel):
    jw = jax_waves[name]
    tw = port_wave(jw)
    x, z, t = _points(jw)
    ref = sf.kinematics(jw, x, z, t, accel=accel, stretching=stretching)
    out = pt.kinematics(tw, torch.tensor(x), torch.tensor(z),
                        torch.tensor(t), accel=accel, stretching=stretching)
    assert torch.equal(out.submerged, torch.tensor(np.asarray(ref.submerged)))
    assert not bool(out.submerged.all()) and bool(out.submerged.any())
    for f, tol in (("u", TOL), ("w", TOL), ("eta", TOL),
                   ("du_dt", TOL_FD if accel == "fd" else TOL),
                   ("dw_dt", TOL_FD if accel == "fd" else TOL)):
        assert rel_err(getattr(out, f), getattr(ref, f)) < tol, f
    assert rel_err(pt.surface_velocity(tw, torch.tensor(x), torch.tensor(t)),
                   j_surf_vel(jw, x, t)) < TOL


def test_clamp_z_applies_to_nonlinear_waves_only(jax_waves):
    """Just below the crest the clamp z + d <= d + eta - 0.01 changes a
    Stokes/Fenton velocity and leaves the closed-form Airy wave alone."""
    for name, clamps in (("airy", False), ("stokes", True),
                         ("fenton", True)):
        tw = port_wave(jax_waves[name])
        assert tw.clamp_z is clamps
        eta = pt.surface_elevation(tw, 0.0, 0.0)
        z = eta - 0.004
        free = pt.kinematics(dataclasses.replace(tw, clamp_z=False), 0.0,
                             z, 0.0)
        got = pt.kinematics(tw, 0.0, z, 0.0)
        assert bool(got.submerged)
        assert (float(got.u) != float(free.u)) is clamps, name


@pytest.fixture(scope="module")
def members():
    """The default jacket refined twice (102 members), some near the
    surface."""
    jm = sf.refine_model(sf.default_3leg_jacket(), 2)
    D = np.asarray(jm.sections.D_outer)[np.asarray(jm.sect_id)] / 1000.0
    return jm, port_model(jm), D


@pytest.mark.parametrize("name,accel,stretching,alpha,per_member,slam", [
    ("airy", "fd", "none", None, False, 0.0),
    ("fenton", "fd", "none", None, False, 0.0),
    ("stokes", "analytic", "wheeler", 1.0 / 7.0, True, 0.0),
    ("fenton", "analytic", "none", None, True, float(np.pi)),
    ("fenton", "fd", "wheeler", 0.2, False, 5.15),
])
def test_morison_loads_matches_jax(jax_waves, members, name, accel,
                                   stretching, alpha, per_member, slam):
    """One time as a number, and a batch of 12 times in one call (phases
    in chunks when over the chunk size) against JAX per time."""
    jm, tm, D = members
    jw = jax_waves[name]
    tw = port_wave(jw)
    M = jm.n_members
    Cd = (np.random.default_rng(1).uniform(0.6, 1.1, M) if per_member
          else 0.7)
    kw = dict(n_gauss=15, accel=accel, stretching=stretching,
              current_alpha=alpha, slam_cs=slam)
    args = (38.0, 120.0)
    ts = np.arange(12) * float(jw.T) / 12
    refs = [sf.morison_loads(jw, jm.coords, jm.conn, jnp.asarray(D), *args,
                             jnp.asarray(Cd), 2.0, 1025.0, t, **kw)
            for t in ts]
    tD, tCd = torch.tensor(D), torch.as_tensor(Cd, dtype=torch.float64)
    one = pt.morison_loads(tw, tm.coords, tm.conn, tD, *args, tCd, 2.0,
                           1025.0, float(ts[5]), **kw)
    for f in pt.MorisonLoads._fields:
        assert rel_err(getattr(one, f), getattr(refs[5], f)) < TOL, f
    old = pt.ops.morison.POINTWISE_CHUNK_ELEMS
    pt.ops.morison.POINTWISE_CHUNK_ELEMS = 5 * M * 15 * tw.n_modes
    try:
        batch = pt.morison_loads(tw, tm.coords, tm.conn, tD, *args, tCd, 2.0,
                                 1025.0, torch.tensor(ts), **kw)
    finally:
        pt.ops.morison.POINTWISE_CHUNK_ELEMS = old
    for f in pt.MorisonLoads._fields:
        ref = np.stack([np.asarray(getattr(r, f)) for r in refs])
        assert getattr(batch, f).shape == ref.shape, f
        assert rel_err(getattr(batch, f), ref) < TOL, f
    if slam:
        no_slam = pt.morison_loads(tw, tm.coords, tm.conn, tD, *args, tCd,
                                   2.0, 1025.0, torch.tensor(ts),
                                   **{**kw, "slam_cs": 0.0})
        assert not torch.allclose(batch.total_drag, no_slam.total_drag)


@pytest.mark.parametrize("name,accel,stretching,alpha,per_member,slam", [
    ("airy", "fd", "none", None, False, 0.0),
    ("fenton", "fd", "none", None, False, 0.0),
    ("stokes", "analytic", "wheeler", 1.0 / 7.0, True, 0.0),
    ("fenton", "analytic", "none", None, True, float(np.pi)),
    ("fenton", "fd", "wheeler", 0.2, False, 5.15),
])
def test_pointwise_end_forces_match_morison_loads(jax_waves, members, name,
                                                  accel, stretching, alpha,
                                                  per_member, slam):
    """The member end forces of the pointwise kernel's plain version,
    scattered onto the nodes, and its totals equal ``morison_loads``' at
    1e-15 (f64; 12 times, in chunks of 5 phases)."""
    jm, tm, D = members
    tw = port_wave(jax_waves[name])
    M = jm.n_members
    Cd = (torch.tensor(np.random.default_rng(1).uniform(0.6, 1.1, M))
          if per_member else 0.7)
    ts = torch.arange(12, dtype=torch.float64) * tw.T / 12
    args = (tw, tm.coords, tm.conn, torch.tensor(D), 38.0, 120.0, Cd, 2.0,
            1025.0, ts)
    kw = dict(n_gauss=15, accel=accel, stretching=stretching,
              current_alpha=alpha, slam_cs=slam)
    ref = pt.morison_loads(*args, **kw)
    old = pt.ops.morison.POINTWISE_CHUNK_ELEMS
    pt.ops.morison.POINTWISE_CHUNK_ELEMS = 5 * M * 15 * tw.n_modes
    try:
        F1, F2, drag, inertia = pt.ops.morison.morison_pointwise_end_forces(
            *args, **kw)
    finally:
        pt.ops.morison.POINTWISE_CHUNK_ELEMS = old
    assert F1.shape == F2.shape == (12, M, 3)
    nodal = pt.ops.morison.nodal_scatter(F1, F2, tm.conn, tm.n_nodes)
    assert rel_err(nodal, ref.nodal_forces) <= 1e-15
    assert rel_err(drag, ref.total_drag) <= 1e-15
    assert rel_err(inertia, ref.total_inertia) <= 1e-15


def test_phase_scan_matches_jax(jax_waves, members):
    jm, tm, D = members
    jw = jax_waves["fenton"]
    args = (38.0, 38.0, 0.7, 2.0, 1025.0)
    ref = sf.phase_scan(jw, jm.coords, jm.conn, jnp.asarray(D), *args,
                        n_steps=24, keep_nodal=True)
    out = pt.phase_scan(port_wave(jw), tm.coords, tm.conn, torch.tensor(D),
                        *args, n_steps=24, keep_nodal=True)
    for f in pt.PhaseScan._fields:
        if f != "critical_index":
            assert rel_err(getattr(out, f), getattr(ref, f)) < TOL, f
    assert int(out.critical_index) == int(ref.critical_index)


def test_nodal_sum_is_fixed_order():
    """The nodal sum of member-end values gathers each node's entries into
    a fixed table (bit-repeatable on the card, unlike index_add_'s
    atomics) and equals index_add_ to rounding; a node without members
    gets 0."""
    from small_fem_solver_tpu_torch.ops.assembly import (node_gather_table,
                                                         node_sum_ordered)
    rng = np.random.default_rng(3)
    nodes = torch.tensor(rng.integers(0, 9, 60))
    nodes[nodes == 4] = 5
    values = torch.tensor(rng.normal(size=(3, 60, 2)))
    out = node_sum_ordered(values, node_gather_table(nodes, 11))
    ref = torch.zeros(3, 11, 2, dtype=torch.float64).index_add_(1, nodes,
                                                                values)
    assert rel_err(out, ref) < 1e-15
    assert torch.all(out[:, [4, 9, 10]] == 0.0)
