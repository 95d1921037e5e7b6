"""PyTorch port vs the JAX package: the condensed phase scan end to end
(default jacket refined 4x, Fenton N = 12 storm wave, 8 phases, separable
kinematics on the CPU), plus the port's default device, its CPU dispatch
of the fused kinematics and its guards."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import phase_scan_condensed as j_scan
from small_fem_solver_tpu.api import phase_scan_prepared as j_scan_prepared
from small_fem_solver_tpu.api import prepare_condensed as j_prepare
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from test_torch_convert import (port_case, port_model, port_prepared,
                                port_wave, rel_err)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_SEG, N_STEPS = 4, 8
FIELDS = ("U", "von_mises", "utilization", "reactions", "total_morison")
CASE = dict(wave_dir_deg=38.0, current_dir_deg=120.0, F_axial_kN=25100.0,
            F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")


def _setup(jdt, tdt):
    coarse = sf.default_3leg_jacket(dtype=jdt)
    refined = sf.refine_model(coarse, N_SEG)
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=12,
                        dtype=jdt)
    return (coarse, refined, wave, port_model(coarse, tdt),
            port_model(refined, tdt), port_wave(wave, tdt))


@pytest.mark.parametrize("solver", ["thomas", "nested"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_condensed_scan_matches_jax(solver, precision):
    """f64 solve: 1e-9 relative; f32 solve with one refinement round:
    1e-4 relative (the two sides round differently in f32)."""
    jdt, tdt, tol = {"f64": (jnp.float64, torch.float64, 1e-9),
                     "f32": (jnp.float32, torch.float32, 1e-4)}[precision]
    coarse, refined, wave, tc, tr, tw = _setup(jdt, tdt)
    case = sf.LoadCase(**CASE)
    ref = j_scan(coarse, refined, N_SEG, wave, case, n_steps=N_STEPS,
                 kinematics="separable", chain_solver=solver, solve_dtype=jdt)
    out = pt.phase_scan_condensed(tc, tr, N_SEG, tw, port_case(case),
                                  n_steps=N_STEPS, kinematics="separable",
                                  chain_solver=solver, solve_dtype=tdt)
    for name in FIELDS:
        assert getattr(out, name).dtype == tdt, name
        assert rel_err(getattr(out, name), getattr(ref, name)) < tol, name
    assert int(out.critical_index) == int(ref.critical_index)
    np.testing.assert_allclose(out.ts.numpy(), np.asarray(ref.ts),
                               rtol=1e-6)


@pytest.mark.parametrize("sw_mode", ["calculated", "none"])
def test_self_weight_modes_match_jax(sw_mode):
    coarse, refined, wave, tc, tr, tw = _setup(jnp.float64, torch.float64)
    case = sf.LoadCase(**{**CASE, "sw_mode": sw_mode})
    ref = j_scan(coarse, refined, N_SEG, wave, case, n_steps=4,
                 kinematics="separable")
    out = pt.phase_scan_condensed(tc, tr, N_SEG, tw, port_case(case),
                                  n_steps=4, kinematics="separable")
    for name in FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name


@pytest.mark.parametrize("solver", ["thomas", "nested"])
def test_prepared_scan_matches_one_shot_and_jax_handle(solver):
    """The port's prepare + scan equals its one-shot scan exactly; the JAX
    handle carried over through convert.prepared_from_numpy gives JAX's
    prepared scan."""
    coarse, refined, wave, tc, tr, tw = _setup(jnp.float64, torch.float64)
    case = sf.LoadCase(**CASE)
    tcase = port_case(case)
    one = pt.phase_scan_condensed(tc, tr, N_SEG, tw, tcase, n_steps=N_STEPS,
                                  kinematics="separable", chain_solver=solver)
    prep = pt.prepare_condensed(tc, tr, N_SEG, chain_solver=solver)
    pre = pt.phase_scan_prepared(prep, tw, tcase, n_steps=N_STEPS,
                                 kinematics="separable")
    for name in FIELDS:
        assert torch.equal(getattr(pre, name), getattr(one, name)), name

    jprep = j_prepare(coarse, refined, N_SEG, chain_solver=solver)
    ref = j_scan_prepared(jprep, wave, case, n_steps=N_STEPS,
                          kinematics="separable")
    out = pt.phase_scan_prepared(port_prepared(jprep, tc, tr), tw, tcase,
                                 n_steps=N_STEPS, kinematics="separable")
    for name in FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name

    with pytest.raises(ValueError, match="prepared factorization"):
        pt.phase_scan_prepared(prep, tw, pt.LoadCase(E=200000.0), n_steps=2,
                               kinematics="separable")


def test_fused_kinematics_refuses_cpu_tensors():
    """The kernels' launchers refuse CPU tensors (the wrappers hand such
    tensors to the plain versions instead, next test) and count nothing."""
    _, _, _, tc, tr, tw = _setup(jnp.float64, torch.float32)
    before = (hk.morison_phase_batch_cuda.launches,
              hk.chain_sweep_cuda.launches)
    D = tr.sections.D_outer[tr.sect_id] / 1000.0
    k = hk.kernel_operands(tw, tr.coords, tr.conn, D, 38.0, 120.0, 0.7, 2.0,
                           1025.0, torch.zeros(2), 15, None)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.launch_morison(k, False)
    prep = pt.prepare_condensed(tc, tr, N_SEG, chain_solver="thomas",
                                solve_dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        hk.chain_sweep_cuda(prep.fac, torch.zeros(2, N_SEG - 1,
                                                  tc.n_members, 6))
    assert (hk.morison_phase_batch_cuda.launches,
            hk.chain_sweep_cuda.launches) == before


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_fused_kinematics_on_cpu_equals_separable(precision):
    """On a CPU model the default kinematics="fused" runs the plain
    version: the scan and the envelope equal kinematics="separable" bit
    for bit, and no kernel launch is counted."""
    tdt = {"f64": torch.float64, "f32": torch.float32}[precision]
    _, _, _, tc, tr, tw = _setup(jnp.float64, tdt)
    case = pt.LoadCase(**CASE)
    before = hk.morison_phase_batch_cuda.launches
    runs = [pt.phase_scan_condensed(tc, tr, N_SEG, tw, case, n_steps=4,
                                    kinematics=kin, solve_dtype=tdt)
            for kin in ("fused", "separable")]
    for name in FIELDS:
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))
    waves = pt.make_wave_batch([8.0, 12.0], 9.4, 50.0, U_c=1.7,
                               model="airy", n_modes=1, dtype=tdt,
                               device="cpu")
    cases = pt.make_case_batch(case, wave_dir_deg=[0.0, 38.0])
    envs = [pt.design_envelope_condensed(tc, tr, N_SEG, waves, cases,
                                         n_steps=4, solve_dtype=tdt,
                                         kinematics=kin, case_batch=1)
            for kin in ("fused", "separable")]
    for name in ("max_util_per_phase", "member_envelope", "total_morison"):
        assert torch.equal(getattr(envs[0], name), getattr(envs[1], name))
    assert hk.morison_phase_batch_cuda.launches == before


def test_pallas_kinematics_is_an_alias_of_fused():
    """kinematics="pallas" (the JAX package's name of its kernel path) is
    "fused": the scan, the prepared scan and the condensed envelope equal
    the default bit for bit."""
    _, _, _, tc, tr, tw = _setup(jnp.float64, torch.float64)
    case = pt.LoadCase(**CASE)
    prep = pt.prepare_condensed(tc, tr, N_SEG)
    waves = pt.make_wave_batch([8.0, 12.0], 9.4, 50.0, U_c=1.7,
                               model="airy", n_modes=1, device="cpu")
    cases = pt.make_case_batch(case, wave_dir_deg=[0.0, 38.0])
    calls = (
        lambda kin: pt.phase_scan_condensed(tc, tr, N_SEG, tw, case,
                                            n_steps=4, kinematics=kin),
        lambda kin: pt.phase_scan_prepared(prep, tw, case, n_steps=4,
                                           kinematics=kin),
        lambda kin: pt.design_envelope_condensed(
            tc, tr, N_SEG, waves, cases, n_steps=4, kinematics=kin))
    for call in calls:
        fused, pallas = call("fused"), call("pallas")
        for name, a in fused._asdict().items():
            if a is not None:
                assert torch.equal(a, getattr(pallas, name)), name


def test_default_scan_past_kernel_mode_limit_matches_jax():
    """An Airy wave padded to 40 modes, past the Morison kernel's 32: the
    JAX package's default scan (separable) runs it, and so does the
    port's default (fused, whose CPU route is the plain version); no
    launch."""
    coarse, refined, _, tc, tr, _ = _setup(jnp.float64, torch.float64)
    wave = sf.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="airy",
                        n_modes=40)
    case = sf.LoadCase(**CASE)
    ref = j_scan(coarse, refined, N_SEG, wave, case, n_steps=4)
    before = hk.morison_phase_batch_cuda.launches
    out = pt.phase_scan_condensed(tc, tr, N_SEG, port_wave(wave),
                                  port_case(case), n_steps=4)
    assert hk.morison_phase_batch_cuda.launches == before
    for name in FIELDS:
        assert rel_err(getattr(out, name), getattr(ref, name)) < 1e-9, name


def test_default_device_is_the_card():
    """Built without ``device``, a model, wave or wave batch lies on the
    CUDA card; without a card building it raises and names device="cpu"
    (nothing lands on the CPU silently)."""
    builders = (lambda: pt.default_3leg_jacket(dtype=torch.float32),
                lambda: pt.make_wave(8.0, 9.4, 50.0, model="airy"),
                lambda: pt.fenton_wave(8.0, 9.4, 50.0, N=6),
                lambda: pt.make_wave_batch([8.0, 9.0], 9.4, 50.0,
                                           model="airy", n_modes=1),
                lambda: pt.tube_sections(800.0, 30.0))
    if torch.cuda.is_available():
        assert pt.resolve_device(None).type == "cuda"
        assert builders[0]().device.type == "cuda"
        assert builders[1]().E.device.type == "cuda"
        assert builders[2]().E.device.type == "cuda"
        assert builders[3]().E.device.type == "cuda"
        assert builders[4]().D_outer.device.type == "cuda"
    else:
        for build in builders:
            with pytest.raises(RuntimeError, match='device="cpu"'):
                build()
    assert pt.resolve_device("cpu") == torch.device("cpu")
    assert pt.default_3leg_jacket(device="cpu").device.type == "cpu"


def test_unported_options_raise():
    _, _, _, tc, tr, tw = _setup(jnp.float64, torch.float64)
    case = pt.LoadCase(**CASE)
    # mesh= is ported (tests/test_torch_distributed.py): a dense solver
    # with a mesh and a mesh of the wrong kind raise
    with pytest.raises(ValueError, match="requires solver='pcg'"):
        pt.analyze(tc, tw, case, solver="lu", mesh=object())
    waves = pt.make_wave_batch([8.0, 9.0], 9.4, 50.0, model="airy",
                               dtype=torch.float64, device="cpu")
    cases = pt.make_case_batch(case, wave_dir_deg=[0.0, 38.0])
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.design_envelope(tc, waves, cases, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        pt.parallel.sweep.design_sweep(tc, waves, cases, mesh=object())
    with pytest.raises(ValueError):
        pt.phase_scan_condensed(tc, tr, N_SEG, tw, case, n_steps=2,
                                kinematics="magic")


def test_port_imports_no_jax():
    code = ("import sys; import small_fem_solver_tpu_torch, "
            "small_fem_solver_tpu_torch.convert; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'small_fem_solver_tpu' not in sys.modules")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """On a machine without a CUDA card, and in a directory that holds
    chip_smoke.py alone, the smoke run exits non-zero and prints no
    result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (REPO, tmp_path):
        proc = _smoke(cwd)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
