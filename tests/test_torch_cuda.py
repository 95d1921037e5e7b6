"""The port's CUDA kernel on the card (tests marked ``cuda``; they skip
without a CUDA device).

This file imports no JAX, so it also runs on a GPU host without JAX:
``python3 -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py``.
"""
import dataclasses

import pytest
import torch

import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
from small_fem_solver_tpu_torch.ops.morison import morison_phase_batch

FIELDS = ("nodal_forces", "total_drag", "total_inertia", "total_morison",
          "F1", "F2")
KERNEL_TOL = 1e-5   # f32 kernel vs f64 plain, relative to the largest value


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("model,N,stretching,alpha,n_members", [
    ("fenton", 12, "none", None, None),
    ("fenton", 12, "wheeler", None, 13),
    ("airy", 1, "none", 1.0 / 7.0, 29),
])
def test_kernel_matches_plain_f64(model, N, stretching, alpha, n_members):
    """The f32 kernel against the plain version in f64 on the same
    (f32-rounded) inputs, with per-member Cd."""
    dev = _device()
    refined = pt.refine_model(pt.default_3leg_jacket(dtype=torch.float32,
                                                     device=dev), 4)
    M = n_members or refined.n_members
    wave = pt.make_wave(12.0, 9.4, 50.0, U_c=1.2, model=model, N=N,
                        dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(0)
    Cd = (0.6 + 0.5 * torch.rand(M, generator=gen)).to(dev)
    D = refined.sections.D_outer[refined.sect_id][:M] / 1000.0
    ts = torch.arange(24, dtype=torch.float32, device=dev) * wave.T / 24

    def args(dtype):
        return (wave.to(dtype, dev), refined.coords.to(dtype),
                refined.conn[:M], D.to(dtype), 38.0, 120.0, Cd.to(dtype),
                2.0, 1025.0, ts.to(dtype))

    before = hk.morison_phase_batch_cuda.launches
    out = hk.morison_phase_batch_cuda(*args(torch.float32),
                                      current_alpha=alpha,
                                      stretching=stretching)
    torch.cuda.synchronize()
    assert hk.morison_phase_batch_cuda.launches == before + 1
    ref = morison_phase_batch(*args(torch.float64), current_alpha=alpha,
                              stretching=stretching)
    for name in FIELDS:
        assert getattr(out, name).dtype == torch.float32
        assert _rel(getattr(out, name), getattr(ref, name)) < KERNEL_TOL, name


@pytest.mark.cuda
def test_kernel_is_bit_repeatable():
    """No float atomics: two launches give identical bits."""
    dev = _device()
    refined = pt.refine_model(pt.default_3leg_jacket(dtype=torch.float32,
                                                     device=dev), 8)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=torch.float32, device=dev)
    D = refined.sections.D_outer[refined.sect_id] / 1000.0
    ts = torch.arange(40, dtype=torch.float32, device=dev) * wave.T / 40
    args = (wave, refined.coords, refined.conn, D, 38.0, 38.0, 0.7, 2.0,
            1025.0, ts)
    a = hk.morison_phase_batch_cuda(*args)
    b = hk.morison_phase_batch_cuda(*args)
    for name in ("F1", "F2", "total_drag", "total_inertia"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
def test_fused_scan_matches_separable_scan():
    """The condensed scan through the kernel (f32 loads and solve) against
    the separable scan in f64 of the same f32-rounded model and wave, at
    n_seg = 4."""
    dev = _device()
    f32, f64 = torch.float32, torch.float64
    case = pt.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    coarse = pt.default_3leg_jacket(dtype=f32, device=dev)
    refined = pt.refine_model(coarse, 4)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=f32, device=dev)
    fused = pt.phase_scan_condensed(coarse, refined, 4, wave, case,
                                    n_steps=16, kinematics="fused",
                                    solve_dtype=f32)

    def as_f64(m):
        return dataclasses.replace(m, coords=m.coords.to(f64),
                                   sections=m.sections.to(f64))
    ref = pt.phase_scan_condensed(as_f64(coarse), as_f64(refined), 4,
                                  wave.to(f64), case, n_steps=16,
                                  kinematics="separable", solve_dtype=f64)
    u32, u64 = fused.utilization.double(), ref.utilization
    assert float((u32 - u64).abs().max() / u64.max()) < 2e-4
    assert _rel(fused.U, ref.U) < 1e-4
