"""PyTorch port vs the JAX package: the condensed phase scan end to end
(default jacket refined 4x, Fenton N = 12 storm wave, 8 phases, separable
kinematics on the CPU), plus the port's guards."""
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
    _, _, _, tc, tr, tw = _setup(jnp.float64, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        pt.phase_scan_condensed(tc, tr, N_SEG, tw, pt.LoadCase(**CASE),
                                n_steps=2, kinematics="fused",
                                solve_dtype=torch.float32)


def test_unported_options_raise():
    _, _, _, tc, tr, tw = _setup(jnp.float64, torch.float64)
    case = pt.LoadCase(**CASE)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.phase_scan_condensed(tc, tr, N_SEG, tw, case, n_steps=2,
                                kinematics="pointwise")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.prepare_condensed(tc, tr, N_SEG, support_stiffness=[1e9] * 6)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.phase_scan_condensed(tc, tr, N_SEG, tw,
                                pt.LoadCase(**CASE, buoyancy="sealed"),
                                n_steps=2, kinematics="separable")
    nodes, members, fixed, top = \
        pt.models.presets.default_3leg_jacket_geometry()
    members = [{**members[0], "release": "pinned"}] + members[1:]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt.build_model(nodes, members, fixed, top)
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
