"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the flagship condensed phase scan: the
default 3-leg jacket refined 32x (9,612 DOF), the Fenton N = 18 storm wave
(H = 17.038 m, T = 9.4 s, d = 50 m, U_c = 1.7 m/s), a full FEM solve at 360
wave phases in float32 with the fused Morison kernel — and checks it:

1. device and toolkit versions; full-f32 matmul settings;
2. builds the CUDA kernel from the sources in this checkout and times it;
3. kernel phase: ``morison_phase_batch_cuda`` (f32) against the plain
   ``morison_phase_batch`` in f64 on the same (f32-rounded) inputs, at the
   flagship shapes, for Fenton and Airy waves, Wheeler stretching and a
   member count that is not a multiple of the kernel's member group;
4. slice phase: ``phase_scan_condensed(kinematics="fused")`` then
   ``prepare_condensed`` + ``phase_scan_prepared``, with the kernel's launch
   count read around exactly that run; checked against the separable f64
   scan of an f64 model, for equilibrium, and prepared == one-shot;
5. timing with CUDA events (median of 20 synchronised runs after warm-up):
   the kernel's wrapper (operand packing included) and the kernel alone
   against the plain f32 version, the fused scan against the separable
   scan.

Prints the kernel record and the card's name and power limit on the lines
before the last, and ``{"ok": true, "device": {...}}`` as the last line.
Exits non-zero (and prints no result) without a CUDA device, outside a
checkout of the repository, or when any check fails.

Run from the repository root:  python3 chip_smoke.py
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

N_SEG = 32
N_STEPS = 360
KERNEL_TOL = 1e-5     # K1 (f32) vs plain f64: max |err| / max |value|
UTIL_TOL = 2e-4       # fused f32 scan vs separable f64: per-element utilization
MAX_UTIL_TOL = 1e-4   # ... governing (max) utilization
U_TOL = 1e-4          # ... displacements, relative to max |U|
EQ_TOL_F32 = 1e-4     # reactions balance the applied loads (f32 solve)
EQ_TOL_F64 = 1e-9     # ... (f64 solve)
PREP_TOL = 1e-6       # prepared scan vs one-shot scan
CASE = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
            F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"[check] {'ok  ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median over ``n`` synchronised runs of ``fn`` in ms (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import small_fem_solver_tpu_torch as pt
    from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
    from small_fem_solver_tpu_torch.ops.morison import morison_phase_batch

    # ---- 1. device ----
    dev = torch.device("cuda", 0)
    name, count, smi = (torch.cuda.get_device_name(0),
                        torch.cuda.device_count(), smi_line())
    nvcc = subprocess.run([hk.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[device] {smi} | count={count} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvcc {nvcc.splitlines()[-1]} | "
          f"python {sys.version.split()[0]} | ninja "
          f"{'found' if shutil.which('ninja') else 'not found'} (not needed)",
          flush=True)

    def full_f32():
        return (torch.backends.cuda.matmul.allow_tf32 is False
                and torch.get_float32_matmul_precision() == "highest")
    check(full_f32(), "TF32 off and float32 matmul precision 'highest'")

    # ---- 2. build ----
    t0 = time.perf_counter()
    hk.build()
    print(f"[build] morison_phase_batch.cu -> sm_90a in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel phase at the flagship shapes ----
    f32, f64 = torch.float32, torch.float64
    coarse32 = pt.default_3leg_jacket(dtype=f32, device=dev)
    refined32 = pt.refine_model(coarse32, N_SEG)
    coarse64 = pt.default_3leg_jacket(dtype=f64, device=dev)
    refined64 = pt.refine_model(coarse64, N_SEG)
    check(refined32.n_dof == 9612, f"refined model has {refined32.n_dof} DOF")
    wave32 = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                          dtype=f32, device=dev)
    wave64 = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                          dtype=f64, device=dev)
    airy32 = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="airy",
                          dtype=f32, device=dev)
    D32 = refined32.sections.D_outer[refined32.sect_id] / 1000.0
    ts32 = torch.arange(N_STEPS, dtype=f32, device=dev) * wave32.T / N_STEPS
    Mr = refined32.n_members

    def kernel_args(wave, n_members, dtype):
        return (wave.to(dtype, dev), refined32.coords.to(dtype),
                refined32.conn[:n_members], D32[:n_members].to(dtype),
                38.0, 38.0, 0.7, 2.0, 1025.0, ts32.to(dtype))

    fields = ("nodal_forces", "F1", "F2", "total_drag", "total_inertia",
              "total_morison")
    kernel_err = None
    for label, wave, n_members, stretching in (
            ("fenton", wave32, Mr, "none"),
            ("fenton+wheeler", wave32, Mr, "wheeler"),
            ("airy", airy32, Mr, "none"),
            (f"fenton, {Mr - 3} members", wave32, Mr - 3, "none")):
        out = hk.morison_phase_batch_cuda(*kernel_args(wave, n_members, f32),
                                          stretching=stretching)
        torch.cuda.synchronize()
        ref = morison_phase_batch(*kernel_args(wave, n_members, f64),
                                  stretching=stretching)
        errs = {f: rel(getattr(out, f), getattr(ref, f)) for f in fields}
        print(f"[kernel] {label}: S={N_STEPS} M={n_members} "
              f"P={n_members * 15} N={wave.n_modes} max rel err "
              + " ".join(f"{f}={e:.2e}" for f, e in errs.items()),
              flush=True)
        check(all(torch.isfinite(getattr(out, f)).all() for f in fields),
              f"kernel outputs finite ({label})")
        check(max(errs.values()) < KERNEL_TOL,
              f"kernel vs f64 plain ({label}): {max(errs.values()):.2e} "
              f"< {KERNEL_TOL:g}")
        if kernel_err is None:
            kernel_err = max(float((getattr(out, f).double()
                                    - getattr(ref, f)).abs().max())
                             for f in ("F1", "F2"))

    # ---- 4. slice phase: the main path, with the launch count ----
    case = pt.LoadCase(**CASE)
    hk.morison_phase_batch_cuda.launches = 0
    t0 = time.perf_counter()
    scan = pt.phase_scan_condensed(coarse32, refined32, N_SEG, wave32, case,
                                   n_steps=N_STEPS, kinematics="fused",
                                   solve_dtype=f32)
    prep = pt.prepare_condensed(coarse32, refined32, N_SEG, solve_dtype=f32)
    scan_p = pt.phase_scan_prepared(prep, wave32, case, n_steps=N_STEPS,
                                    kinematics="fused")
    torch.cuda.synchronize()
    launches = hk.morison_phase_batch_cuda.launches
    print(f"[slice] fused f32 one-shot + prepared scans: "
          f"{time.perf_counter() - t0:.2f} s wall (first call), "
          f"kernel launches={launches}", flush=True)
    check(launches >= 1, f"main path launched the kernel ({launches}x)")
    check(full_f32(), "matmul settings restored after the scans")

    ref = pt.phase_scan_condensed(coarse64, refined64, N_SEG, wave64, case,
                                  n_steps=N_STEPS, kinematics="separable",
                                  solve_dtype=f64)
    n_dof, S = refined32.n_dof, N_STEPS
    check(tuple(scan.U.shape) == (S, n_dof)
          and tuple(scan.utilization.shape) == (S, Mr)
          and tuple(scan.reactions.shape) == (S, 3, 6),
          f"result shapes U {tuple(scan.U.shape)}, utilization "
          f"{tuple(scan.utilization.shape)}, reactions "
          f"{tuple(scan.reactions.shape)}")
    check(all(torch.isfinite(t).all() for t in scan[1:6]),
          "scan results finite")
    u32, u64 = scan.utilization.double(), ref.utilization
    util_err = float((u32 - u64).abs().max() / u64.max())
    max_err = float((u32.max() - u64.max()).abs() / u64.max())
    check(util_err < UTIL_TOL, f"fused f32 vs separable f64 utilization "
          f"{util_err:.2e} < {UTIL_TOL:g}")
    check(max_err < MAX_UTIL_TOL, f"max utilization {float(u32.max()):.6f} "
          f"vs {float(u64.max()):.6f}: {max_err:.2e} < {MAX_UTIL_TOL:g}")
    U_err = rel(scan.U, ref.U)
    check(U_err < U_TOL, f"displacements {U_err:.2e} < {U_TOL:g}")

    def equilibrium(s):
        tm = s.total_morison.double()
        th = torch.deg2rad(torch.tensor(90.0 - CASE["wave_dir_deg"],
                                        dtype=f64, device=dev))
        shear = CASE["F_shear_kN"] * 1e3
        weight = CASE["custom_sw_tonnes"] * 1e3 * pt.G_GRAV
        applied = torch.stack([shear * torch.cos(th) + tm[:, 0],
                               shear * torch.sin(th) + tm[:, 1],
                               -CASE["F_axial_kN"] * 1e3 - weight
                               + tm[:, 2]], dim=1)
        R = s.reactions.double().sum(dim=1)[:, :3]
        return float((R + applied).abs().max() / applied.abs().max())
    eq32, eq64 = equilibrium(scan), equilibrium(ref)
    check(eq32 < EQ_TOL_F32, f"equilibrium, fused f32 scan: {eq32:.2e} < "
          f"{EQ_TOL_F32:g}")
    check(eq64 < EQ_TOL_F64, f"equilibrium, separable f64 scan: {eq64:.2e} "
          f"< {EQ_TOL_F64:g}")
    prep_err = max(rel(getattr(scan_p, f), getattr(scan, f))
                   for f in ("U", "utilization", "reactions"))
    check(prep_err <= PREP_TOL, f"prepared scan == one-shot scan: "
          f"{prep_err:.2e} <= {PREP_TOL:g}")
    crit, crit64 = int(scan.critical_index), int(ref.critical_index)
    print(f"[slice] {n_dof} DOF x {S} phases: max utilization "
          f"{float(u32.max()):.6f} (f64 {float(u64.max()):.6f}) at phase "
          f"{crit} (t = {float(scan.ts[crit]):.4f} s; f64 phase {crit64})",
          flush=True)

    # ---- 5. timing ----
    args32 = kernel_args(wave32, Mr, f32)
    packed = hk.kernel_inputs(*args32, n_gauss=15, current_alpha=None)
    raw_ms = cuda_ms(lambda: hk.launch_packed(packed, Mr, 15, False))
    k_ms = cuda_ms(lambda: hk.morison_phase_batch_cuda(*args32))
    p_ms = cuda_ms(lambda: morison_phase_batch(*args32))

    def scan_fn(kinematics):
        return lambda: pt.phase_scan_condensed(
            coarse32, refined32, N_SEG, wave32, case, n_steps=N_STEPS,
            kinematics=kinematics, solve_dtype=f32)
    fused_ms = cuda_ms(scan_fn("fused"))
    sep_ms = cuda_ms(scan_fn("separable"))
    print(f"[time] {smi}: morison wrapper {k_ms:.3f} ms (kernel alone on "
          f"packed operands {raw_ms:.3f} ms) vs plain f32 {p_ms:.3f} ms; "
          f"360-phase scan @ {n_dof} DOF: fused "
          f"{fused_ms:.3f} ms vs separable {sep_ms:.3f} ms "
          f"(median of 20, CUDA events)", flush=True)

    print(json.dumps({"kernels": [{
        "name": "morison_phase_batch",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/morison_phase_batch.cu",
        "replaces": "small_fem_solver_tpu/ops/pallas_kernels.py:229",
        "launches": launches,
        "max_abs_err": kernel_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
