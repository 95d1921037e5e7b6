"""PyTorch port vs the JAX package: the condensed design envelope (default
jacket refined 4x, 3 cases with their own headings, 6 phases, Airy and a
small Fenton batch, separable kinematics on the CPU), the batched Fenton
setup, and the chain sweep's CPU dispatch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import \
    design_envelope_condensed as j_envelope
from small_fem_solver_tpu.ops.fenton import \
    fenton_wave_batch as j_fenton_batch
from small_fem_solver_tpu.parallel import sweep as jsweep
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import condense as tcond
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from test_torch_convert import port_case, port_model, port_wave, rel_err

N_SEG, N_STEPS = 4, 6
HS = [4.0, 9.0, 14.0]
HEADINGS = [0.0, 38.0, 120.0]
BASE = dict(current_dir_deg=38.0, F_axial_kN=25100.0, F_shear_kN=2900.0,
            custom_sw_tonnes=1100.0, sw_mode="custom")
FIELDS = ("ts", "max_util_per_phase", "max_util_per_case", "member_envelope",
          "total_morison")
WAVE_FIELDS = ("k", "omega", "c", "d", "U_c", "H", "T", "E", "U")


def _jax_cases():
    return jsweep.make_case_batch(sf.LoadCase(**BASE),
                                  wave_dir_deg=jnp.asarray(HEADINGS))


@pytest.fixture(scope="module")
def jax_waves():
    """The JAX wave batches in float64: Airy and Fenton N = 8."""
    return {
        "airy": jsweep.make_wave_batch(HS, 9.4, 50.0, U_c=1.7, model="airy",
                                       n_modes=3, dtype=jnp.float64),
        "fenton": jsweep.make_wave_batch(HS, 9.4, 50.0, U_c=1.7,
                                         model="fenton", N=8, n_modes=8,
                                         dtype=jnp.float64),
    }


@pytest.mark.parametrize("solver,precision,wave", [
    ("thomas", "f64", "airy"),
    ("nested", "f64", "fenton"),
    ("thomas", "f32", "fenton"),
    ("nested", "f32", "airy"),
])
def test_envelope_matches_jax(jax_waves, solver, precision, wave):
    """The port's separable envelope against JAX's: f64 1e-9, f32 1e-4
    relative (the port adds one refinement round; the two sides also
    round differently in f32: measured 1e-5..5e-5)."""
    jdt, tdt, tol = {"f64": (jnp.float64, torch.float64, 1e-9),
                     "f32": (jnp.float32, torch.float32, 1e-4)}[precision]
    coarse = sf.default_3leg_jacket(dtype=jdt)
    refined = sf.refine_model(coarse, N_SEG)
    jw = jax.tree.map(lambda x: x.astype(jdt), jax_waves[wave])
    cases = _jax_cases()
    ref = j_envelope(coarse, refined, N_SEG, jw, cases, n_steps=N_STEPS,
                     solve_dtype=jdt, kinematics="separable",
                     chain_solver=solver)
    out = pt.design_envelope_condensed(
        port_model(coarse, tdt), port_model(refined, tdt), N_SEG,
        port_wave(jw, tdt), port_case(cases), n_steps=N_STEPS,
        solve_dtype=tdt, kinematics="separable", chain_solver=solver)
    assert out.utilization is None
    for name in FIELDS:
        assert getattr(out, name).dtype == tdt, name
        assert rel_err(getattr(out, name), getattr(ref, name)) < tol, name
    np.testing.assert_array_equal(out.critical_phase.numpy(),
                                  np.asarray(ref.critical_phase))
    assert int(out.governing_case) == int(ref.governing_case)


@pytest.fixture(scope="module")
def port_setup():
    coarse = pt.default_3leg_jacket(device="cpu")
    refined = pt.refine_model(coarse, N_SEG)
    waves = pt.make_wave_batch(HS, [8.0, 9.4, 11.0], 50.0, U_c=1.7,
                               model="fenton", N=8, n_modes=8,
                               dtype=torch.float64, device="cpu")
    cases = pt.make_case_batch(pt.LoadCase(**BASE),
                               wave_dir_deg=np.asarray(HEADINGS))
    return coarse, refined, waves, cases


def test_envelope_equals_per_case_scans_for_any_case_batch(port_setup):
    """Envelope case i equals the condensed scan of case i (f64, 1e-9),
    whatever ``case_batch`` is."""
    coarse, refined, waves, cases = port_setup
    envs = [pt.design_envelope_condensed(coarse, refined, N_SEG, waves,
                                         cases, n_steps=N_STEPS,
                                         solve_dtype=torch.float64,
                                         case_batch=cb,
                                         kinematics="separable")
            for cb in (1, 2, 32)]
    for env in envs[1:]:
        for name in FIELDS:
            assert rel_err(getattr(env, name), getattr(envs[0], name)) \
                < 1e-12, name
        assert torch.equal(env.critical_phase, envs[0].critical_phase)
    env = envs[0]
    member_max = []
    for i in range(len(HS)):
        scan = pt.phase_scan_condensed(coarse, refined, N_SEG, waves.case(i),
                                       cases.case(i), n_steps=N_STEPS,
                                       kinematics="separable")
        util = scan.utilization
        assert rel_err(env.max_util_per_phase[i], util.amax(dim=1)) < 1e-9
        assert rel_err(env.ts[i], scan.ts) < 1e-15
        assert rel_err(env.total_morison[i], scan.total_morison) < 1e-12
        assert int(env.critical_phase[i]) == int(scan.critical_index)
        member_max.append(util.amax(dim=0))
    assert rel_err(env.member_envelope,
                   torch.stack(member_max).amax(dim=0)) < 1e-9
    assert int(env.governing_case) == int(env.max_util_per_case.argmax())


def test_envelope_guards(port_setup, jax_waves):
    coarse, refined, waves, cases = port_setup

    def run(c=cases, **kw):
        return pt.design_envelope_condensed(coarse, refined, N_SEG, waves, c,
                                            n_steps=2,
                                            solve_dtype=torch.float64, **kw)
    mixed = dataclasses.replace(
        cases, E=torch.tensor([210000.0, 200000.0, 210000.0]))
    with pytest.raises(ValueError, match="identical across the batch"):
        run(mixed)
    with pytest.raises(ValueError, match="slam"):
        run(dataclasses.replace(cases, slam_cs=1.0))
    with pytest.raises(TypeError, match="DeviceMesh"):
        run(mesh=object())
    # foundation springs are ported: the sprung envelope against JAX's
    jc = sf.default_3leg_jacket()
    jr = sf.refine_model(jc, N_SEG)
    ref = j_envelope(jc, jr, N_SEG, jax_waves["airy"], _jax_cases(),
                     n_steps=2, solve_dtype=jnp.float64,
                     kinematics="separable", support_stiffness=[1e9] * 6)
    out = pt.design_envelope_condensed(
        port_model(jc), port_model(jr), N_SEG, port_wave(jax_waves["airy"]),
        port_case(_jax_cases()), n_steps=2, solve_dtype=torch.float64,
        kinematics="separable", support_stiffness=[1e9] * 6)
    for name in FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name
    with pytest.raises(ValueError, match="case field"):
        run(pt.make_case_batch(pt.LoadCase(**BASE), wave_dir_deg=[0.0, 1.0]))
    with pytest.raises(ValueError, match="unknown kinematics"):
        run(kinematics="magic")
    with pytest.raises(ValueError, match="unknown wave model"):
        pt.make_wave_batch(HS, 9.4, 50.0, model="cnoidal", device="cpu")


def test_fenton_wave_batch_matches_jax_and_single_solves():
    Hs, Ts = [6.0, 12.0, 17.0], [8.0, 9.4, 11.0]
    out = pt.fenton_wave_batch(Hs, Ts, 50.0, U_c=1.7, N=8, n_modes=10,
                               dtype=torch.float64, device="cpu")
    ref = j_fenton_batch(Hs, Ts, 50.0, U_c=1.7, N=8, n_modes=10,
                         dtype=jnp.float64)
    assert (out.model, out.order, out.n_modes, out.clamp_z) == \
        (ref.model, ref.order, ref.E.shape[-1], ref.clamp_z)
    for name in WAVE_FIELDS:
        assert getattr(out, name).shape[0] == 3, name
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-10, name
    single = pt.fenton_wave(Hs[2], Ts[2], 50.0, U_c=1.7, N=8, n_modes=10,
                            device="cpu")
    for name in WAVE_FIELDS:
        assert rel_err(getattr(out.case(2), name),
                       getattr(single, name)) < 1e-10, name
    with pytest.raises(ValueError, match=r"indices \[1\]"):
        pt.fenton_wave_batch([6.0, 40.0], 9.4, 50.0, N=8, device="cpu")


def test_chain_sweep_dispatch_on_cpu():
    """CPU tensors take the plain sweep and never count a launch; the
    kernel's wrapper refuses them."""
    rng = np.random.default_rng(0)
    Mc, n_int = 5, 3
    mats = [torch.tensor(rng.normal(size=(n_int, Mc, 6, 6)))
            for _ in range(3)]
    ends = [torch.tensor(rng.normal(size=(Mc, 6, 6))) for _ in range(2)]
    fac = tcond.ChainFactor(
        K_super=torch.zeros(Mc, 12, 12), Cprime=mats[0], DinvL=mats[1],
        Dinv=mats[2], Z0=mats[0], Zn=mats[0], B0=ends[0], Cn=ends[1])
    g = torch.tensor(rng.normal(size=(2, 4, n_int, Mc, 6)))
    before = hk.chain_sweep_cuda.launches
    out = tcond.condense_loads(fac, g)
    assert hk.chain_sweep_cuda.launches == before
    for a, b in zip(out, tcond.chain_sweep_plain(fac, g)):
        assert torch.equal(a, b)
    assert out[2].shape == g.shape and out[0].shape == (2, 4, Mc, 6)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.chain_sweep_cuda(fac, g)
