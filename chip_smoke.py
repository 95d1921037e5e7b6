"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's two user paths at the JAX bench's sizes — the flagship
condensed phase scan (the default 3-leg jacket refined 32x to 9,612 DOF,
the Fenton N = 18 storm wave H = 17.038 m, T = 9.4 s, d = 50 m,
U_c = 1.7 m/s, a full FEM solve at 360 wave phases in float32) and the
condensed storm envelope (10 Fenton cases, H = linspace(8, 17, 10) m, x 360
phases on the same mesh) — through both hand-written kernels, the fused
Morison kernel (K1) and the chain-sweep kernel, and checks them:

1. device and toolkit versions; full-f32 matmul settings; the port's
   default device is the card (the flagship model and wave are built
   without ``device``);
2. builds both CUDA kernels from the sources in this checkout (one nvcc
   per source, started together);
3. K1 phase: ``morison_phase_batch_cuda`` (f32) against the plain
   ``morison_phase_batch`` in f64 on the same (f32-rounded) inputs, at the
   flagship shapes, for Fenton and Airy waves, Wheeler stretching, a
   member count and a phase count off the kernel's tiles, and the scan's
   0-d tensor coefficients; bit-repeatable;
4. sweep phase: ``chain_sweep_cuda`` in f32 and f64 against
   ``chain_sweep_plain`` in f64 on the flagship chain factors (nested
   level 1 and 2, thomas), on random loads for 360 and 37 right-hand sides
   (contiguous, and in the scan's transposed chain layout) and on the
   flagship scan's own loads, which the kernel reads in place (the nested
   level-1 (m, q) view, the transposed thomas layout); bit-repeatable (the
   f64 reference runs below go through the same kernel, so this phase is
   the sweep's independent check);
5. scan phase: ``phase_scan_condensed(kinematics="fused")`` then
   ``prepare_condensed`` + ``phase_scan_prepared``, with both kernels'
   launch counts read around exactly that run (launches per scan: half);
   checked against the separable f64 scan of an f64 model, for
   equilibrium, and prepared == one-shot;
6. envelope phase: ``design_envelope_condensed(kinematics="fused")`` with
   both launch counts read around exactly that call; checked against the
   separable f64 envelope of the f64 model and against per-case prepared
   scans;
7. timing with CUDA events (median of 20 synchronised runs after warm-up):
   K1 and its wrapper against the plain f32 version, the sweep kernel
   against the plain level loop, the fused scan against the separable
   scan, the envelope; under torch.profiler each kernel's device time
   beside its bound (the larger of its bytes over 3.35 TB/s and its FLOPs
   over 67 TFLOP/s, the H100 SXM's HBM and FP32 rates, counted from this
   run's shapes), and the scan's device operations and busy time.

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
N_CASES = 10          # envelope: H = linspace(8, 17, 10) m (bench.py:178-181)
KERNEL_TOL = 1e-5     # K1 / sweep (f32) vs plain f64: max |err| / max |value|
SWEEP_TOL_F64 = 1e-12 # sweep kernel (f64) vs plain f64: sum order only
ENV_CASE_TOL = 1e-4   # fused f32 envelope vs separable f64: max_util_per_case
ENV_MEMBER_TOL = 2e-4 # ... member_envelope, relative to its maximum
UTIL_TOL = 2e-4       # fused f32 scan vs separable f64: per-element utilization
MAX_UTIL_TOL = 1e-4   # ... governing (max) utilization
U_TOL = 1e-4          # ... displacements, relative to max |U|
EQ_TOL_F32 = 1e-4     # reactions balance the applied loads (f32 solve)
EQ_TOL_F64 = 1e-9     # ... (f64 solve)
PREP_TOL = 1e-6       # prepared scan vs one-shot scan
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12     # H100 SXM FP32 outside the tensor cores
EPILOGUE_FLOP = 60    # K1 per (phase, point): normal projection, drag,
                      # inertia, lever-rule sums
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


def bound_us(nbytes: float, flops: float):
    """(bound in us, what bounds it): the larger of the bytes over the
    device-memory rate and the FLOPs over the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e6,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import small_fem_solver_tpu_torch as pt
    from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
    from small_fem_solver_tpu_torch.ops.condense import (ChainFactor,
                                                         chain_sweep_plain)
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
    hk.build_all()
    print(f"[build] {', '.join(f'{n}.cu' for n in hk.KERNELS)} -> sm_90a "
          f"in {time.perf_counter() - t0:.2f} s (one nvcc each, in "
          f"parallel)", flush=True)

    # ---- 3. kernel phase at the flagship shapes ----
    f32, f64 = torch.float32, torch.float64
    # built without ``device``: the port's default is the card
    coarse32 = pt.default_3leg_jacket(dtype=f32)
    check(coarse32.device.type == "cuda", f"default device of a model "
          f"built without device: {coarse32.device}")
    refined32 = pt.refine_model(coarse32, N_SEG)
    coarse64 = pt.default_3leg_jacket(dtype=f64, device=dev)
    refined64 = pt.refine_model(coarse64, N_SEG)
    check(refined32.n_dof == 9612, f"refined model has {refined32.n_dof} DOF")
    wave32 = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                          dtype=f32)
    check(wave32.E.device.type == "cuda", "default device of a wave")
    wave64 = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                          dtype=f64, device=dev)
    airy32 = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="airy",
                          dtype=f32, device=dev)
    D32 = refined32.sections.D_outer[refined32.sect_id] / 1000.0
    Mr = refined32.n_members

    def kernel_args(wave, n_members, dtype, S=N_STEPS, tensors=False):
        ts = torch.arange(S, dtype=f32, device=dev) * wave32.T / S
        nums = (38.0, 38.0, 0.7, 2.0, 1025.0)
        if tensors:   # as the scan passes them: 0-d tensors on the card
            nums = tuple(torch.tensor(v, dtype=dtype, device=dev)
                         for v in nums)
        return (wave.to(dtype, dev), refined32.coords.to(dtype),
                refined32.conn[:n_members], D32[:n_members].to(dtype),
                *nums, ts.to(dtype))

    fields = ("nodal_forces", "F1", "F2", "total_drag", "total_inertia",
              "total_morison")
    kernel_err, kernel_rel = None, 0.0
    for label, wave, n_members, stretching, S, tensors in (
            ("fenton", wave32, Mr, "none", N_STEPS, False),
            ("fenton, 0-d tensor coefficients", wave32, Mr, "none", N_STEPS,
             True),
            ("fenton+wheeler", wave32, Mr, "wheeler", N_STEPS, False),
            ("airy", airy32, Mr, "none", N_STEPS, False),
            # 38, not 37, phases: at 37 a Gauss point of member 1033 lies
            # 0.7 um below the phase-29 surface, where f32 and f64 differ
            # on the wet/dry mask (a jump, not a kernel error)
            (f"fenton, {Mr - 3} members, 38 phases", wave32, Mr - 3, "none",
             38, False)):
        out = hk.morison_phase_batch_cuda(
            *kernel_args(wave, n_members, f32, S, tensors),
            stretching=stretching)
        torch.cuda.synchronize()
        ref = morison_phase_batch(*kernel_args(wave, n_members, f64, S,
                                               tensors),
                                  stretching=stretching)
        errs = {f: rel(getattr(out, f), getattr(ref, f)) for f in fields}
        print(f"[kernel] {label}: S={S} M={n_members} "
              f"P={n_members * 15} N={wave.n_modes} max rel err "
              + " ".join(f"{f}={e:.2e}" for f, e in errs.items()),
              flush=True)
        check(all(torch.isfinite(getattr(out, f)).all() for f in fields),
              f"kernel outputs finite ({label})")
        check(max(errs.values()) < KERNEL_TOL,
              f"kernel vs f64 plain ({label}): {max(errs.values()):.2e} "
              f"< {KERNEL_TOL:g}")
        kernel_rel = max(kernel_rel, max(errs.values()))
        if kernel_err is None:
            kernel_err = max(float((getattr(out, f).double()
                                    - getattr(ref, f)).abs().max())
                             for f in ("F1", "F2"))
            again = hk.morison_phase_batch_cuda(
                *kernel_args(wave, n_members, f32, S, tensors),
                stretching=stretching)
            # the kernel's own outputs (the nodal scatter after it is
            # PyTorch's index_add_, which adds with atomics on the card)
            check(all(torch.equal(getattr(out, f), getattr(again, f))
                      for f in ("F1", "F2", "total_drag", "total_inertia")),
                  f"kernel bit-repeatable ({label})")

    # ---- 4. sweep phase at the flagship chain shapes ----
    prep_th = pt.prepare_condensed(coarse32, refined32, N_SEG,
                                   chain_solver="thomas", solve_dtype=f32)
    prep = pt.prepare_condensed(coarse32, refined32, N_SEG, solve_dtype=f32)
    check(prep.chain_solver == "nested", "flagship chain solver is nested")
    sweep_facs = {"nested level 1": prep.fac.fac1,
                  "nested level 2": prep.fac.fac2, "thomas": prep_th.fac}

    def as_dtype(fac, dtype):
        return ChainFactor(*(t.to(dtype).contiguous() for t in fac))

    def sweep_loads(fac, B, seed, transposed=False):
        n_int, Mc = fac.Cprime.shape[:2]
        rng = np.random.default_rng(seed)
        if transposed:   # the scan's chain layout: [B, Mc, n_int, 6] memory
            return torch.tensor(rng.normal(size=(B, Mc, n_int, 6)) * 1e5,
                                dtype=f32, device=dev).transpose(1, 2)
        return torch.tensor(rng.normal(size=(B, n_int, Mc, 6)) * 1e5,
                            dtype=f32, device=dev)

    # the main path's own loads, as the kernel reads them in place: the
    # sweep inputs of one flagship scan's nested condensation (level 1, the
    # (m, q) view of the chain-position loads; then level 2) and, for
    # thomas, the scan's chain-layout loads themselves (transposed)
    from small_fem_solver_tpu_torch.api import _scan_loads
    from small_fem_solver_tpu_torch.ops import condense as condense_mod
    case = pt.LoadCase(**CASE)
    g_scan = _scan_loads(prep, wave32, case, N_STEPS, 15, "fused", "none",
                         None)[2]
    scan_sweeps = []

    def recording_sweep(fac, g, split=False):
        scan_sweeps.append((f"flagship scan loads, nested level "
                            f"{len(scan_sweeps) + 1}", fac, g, split))
        return hk.chain_sweep_cuda(fac, g, split)
    condense_mod.chain_sweep_cuda = recording_sweep
    try:
        condense_mod.condense_loads_nested(prep.fac, g_scan)
    finally:
        condense_mod.chain_sweep_cuda = hk.chain_sweep_cuda
    check(len(scan_sweeps) == 2, "the nested condensation ran two sweeps")
    check(scan_sweeps[0][3] and not scan_sweeps[0][2].is_contiguous(),
          "level 1 reads the (m, q) view of the scan's loads in place")
    sweep_inputs = [(f"{label}, random 1e5 loads{', transposed' * tr}", fac,
                     sweep_loads(fac, B, seed, tr), False)
                    for seed, (label, fac) in enumerate(sweep_facs.items())
                    for B in (N_STEPS, 37) for tr in (False, True)]
    sweep_inputs += scan_sweeps + [("flagship scan loads, thomas",
                                    prep_th.fac, g_scan, False)]

    sweep_err, sweep_rel = 0.0, 0.0
    for label, fac, g, split in sweep_inputs:
        fac64 = as_dtype(fac, f64)
        g_chain = (g.reshape(*g.shape[:-3], -1, 6) if split else g)
        ref = chain_sweep_plain(fac64, g_chain.double())
        out = hk.chain_sweep_cuda(fac, g, split)
        torch.cuda.synchronize()
        plain32 = chain_sweep_plain(fac, g_chain)
        errs = [rel(a, b) for a, b in zip(out, ref)]
        perrs = [rel(a, b) for a, b in zip(plain32, ref)]
        out64 = hk.chain_sweep_cuda(fac64, g.double(), split)
        errs64 = [rel(a, b) for a, b in zip(out64, ref)]
        again = hk.chain_sweep_cuda(fac, g, split)
        again64 = hk.chain_sweep_cuda(fac64, g.double(), split)
        torch.cuda.synchronize()
        B, n_int, Mc = g.shape[0], *fac.Cprime.shape[:2]
        label = f"{label}, B={B}"
        print(f"[sweep] {label}: n_int={n_int} chains={Mc} tile "
              f"{hk.SWEEP_LANES}x{hk.sweep_chains_per_block(n_int, 4)} "
              f"max|v|={float(ref[2].abs().max()):.3e}; max "
              f"rel err (fI, fJ, v) kernel f32 "
              + " ".join(f"{e:.2e}" for e in errs)
              + " | plain f32 " + " ".join(f"{e:.2e}" for e in perrs)
              + " | kernel f64 " + " ".join(f"{e:.2e}" for e in errs64),
              flush=True)
        check(all(torch.isfinite(t).all() for t in out),
              f"sweep outputs finite ({label})")
        check(max(errs) <= KERNEL_TOL, f"sweep kernel f32 vs f64 plain "
              f"({label}): {max(errs):.2e} <= {KERNEL_TOL:g}")
        check(max(errs64) <= SWEEP_TOL_F64, f"sweep kernel f64 vs f64 "
              f"plain ({label}): {max(errs64):.2e} <= {SWEEP_TOL_F64:g}")
        check(all(torch.equal(a, b) for a, b in zip(out, again))
              and all(torch.equal(a, b) for a, b in zip(out64, again64)),
              f"sweep kernel bit-repeatable ({label})")
        sweep_rel = max(sweep_rel, max(errs))
        sweep_err = max(sweep_err, max(
            float((a.double() - b).abs().max()) for a, b in zip(out, ref)))

    # ---- 5. scan phase: the flagship scan, with the launch counts ----
    hk.morison_phase_batch_cuda.launches = 0
    hk.chain_sweep_cuda.launches = 0
    t0 = time.perf_counter()
    scan = pt.phase_scan_condensed(coarse32, refined32, N_SEG, wave32, case,
                                   n_steps=N_STEPS, kinematics="fused",
                                   solve_dtype=f32)
    scan_p = pt.phase_scan_prepared(prep, wave32, case, n_steps=N_STEPS,
                                    kinematics="fused")
    torch.cuda.synchronize()
    scan_launches = {"morison_phase_batch": hk.morison_phase_batch_cuda.launches,
                     "chain_sweep": hk.chain_sweep_cuda.launches}
    print(f"[slice] fused f32 one-shot + prepared scans: "
          f"{time.perf_counter() - t0:.2f} s wall (first call), "
          f"kernel launches {scan_launches} (two scans)", flush=True)
    for kname, n in scan_launches.items():
        check(n >= 1, f"scan path launched {kname} ({n}x)")
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

    # ---- 6. envelope phase: 10 Fenton cases x 360 phases ----
    Hs = np.linspace(8.0, 17.0, N_CASES)
    t0 = time.perf_counter()
    waves32 = pt.make_wave_batch(Hs, 9.4, 50.0, U_c=1.7, model="fenton",
                                 N=18, n_modes=18, dtype=f32, device=dev)
    waves64 = pt.make_wave_batch(Hs, 9.4, 50.0, U_c=1.7, model="fenton",
                                 N=18, n_modes=18, dtype=f64, device=dev)
    cases = pt.make_case_batch(case, t_analysis=np.zeros(N_CASES))
    print(f"[envelope] two batched Fenton setups ({N_CASES} cases, N=18): "
          f"{time.perf_counter() - t0:.2f} s host", flush=True)

    def envelope32():
        return pt.design_envelope_condensed(
            coarse32, refined32, N_SEG, waves32, cases, n_steps=N_STEPS,
            solve_dtype=f32, kinematics="fused")
    hk.morison_phase_batch_cuda.launches = 0
    hk.chain_sweep_cuda.launches = 0
    t0 = time.perf_counter()
    env = envelope32()
    torch.cuda.synchronize()
    env_launches = {"morison_phase_batch": hk.morison_phase_batch_cuda.launches,
                    "chain_sweep": hk.chain_sweep_cuda.launches}
    print(f"[envelope] fused f32 envelope: {time.perf_counter() - t0:.2f} s "
          f"wall (first call), kernel launches {env_launches}", flush=True)
    for kname, n in env_launches.items():
        check(n >= 1, f"envelope path launched {kname} ({n}x)")

    env64 = pt.design_envelope_condensed(
        coarse64, refined64, N_SEG, waves64, cases, n_steps=N_STEPS,
        solve_dtype=f64, kinematics="separable")
    C = N_CASES
    check(tuple(env.ts.shape) == (C, S)
          and tuple(env.max_util_per_phase.shape) == (C, S)
          and tuple(env.max_util_per_case.shape) == (C,)
          and tuple(env.member_envelope.shape) == (Mr,)
          and tuple(env.total_morison.shape) == (C, S, 3)
          and env.utilization is None,
          f"envelope shapes ts {tuple(env.ts.shape)}, member_envelope "
          f"{tuple(env.member_envelope.shape)}, total_morison "
          f"{tuple(env.total_morison.shape)}")
    check(all(torch.isfinite(t).all() for t in
              (env.ts, env.max_util_per_phase, env.member_envelope,
               env.total_morison)), "envelope results finite")
    case_err = rel(env.max_util_per_case, env64.max_util_per_case)
    member_err = rel(env.member_envelope, env64.member_envelope)
    check(case_err <= ENV_CASE_TOL, f"fused f32 vs separable f64 envelope "
          f"max_util_per_case {case_err:.2e} <= {ENV_CASE_TOL:g}")
    check(member_err <= ENV_MEMBER_TOL, f"fused f32 vs separable f64 "
          f"member_envelope {member_err:.2e} <= {ENV_MEMBER_TOL:g}")
    gov, gov64 = int(env.governing_case), int(env64.governing_case)
    check(gov == gov64, f"governing case {gov} == f64 {gov64}")
    scan_err = 0.0
    for i in range(C):
        sc = pt.phase_scan_prepared(prep, waves32.case(i), cases.case(i),
                                    n_steps=N_STEPS, kinematics="fused")
        scan_err = max(scan_err,
                       rel(env.max_util_per_case[i:i + 1],
                           sc.utilization.max().reshape(1)),
                       rel(env.max_util_per_phase[i],
                           sc.utilization.amax(dim=1)))
    check(scan_err <= PREP_TOL, f"envelope == per-case prepared scans: "
          f"{scan_err:.2e} <= {PREP_TOL:g}")
    print(f"[envelope] {C} cases x {S} phases @ {n_dof} DOF: max "
          f"utilization per case "
          + " ".join(f"{float(u):.6f}" for u in env.max_util_per_case)
          + f"; governing case {gov} (H = {Hs[gov]:.1f} m, f64 "
          f"{float(env64.max_util_per_case[gov64]):.6f})", flush=True)

    # ---- 7. timing ----
    args32 = kernel_args(wave32, Mr, f32)
    k_ops = hk.kernel_operands(*args32, n_gauss=15, current_alpha=None)
    raw_ms = cuda_ms(lambda: hk.launch_morison(k_ops, False))
    k_ms = cuda_ms(lambda: hk.morison_end_forces_cuda(*args32))
    p_ms = cuda_ms(lambda: morison_phase_batch(*args32))

    def scan_fn(kinematics):
        return lambda: pt.phase_scan_condensed(
            coarse32, refined32, N_SEG, wave32, case, n_steps=N_STEPS,
            kinematics=kinematics, solve_dtype=f32)
    fused_ms = cuda_ms(scan_fn("fused"))
    sep_ms = cuda_ms(scan_fn("separable"))
    print(f"[time] {smi}: morison wrapper {k_ms:.3f} ms (kernel alone on "
          f"its operands {raw_ms:.3f} ms) vs plain f32 {p_ms:.3f} ms; "
          f"360-phase scan @ {n_dof} DOF: fused "
          f"{fused_ms:.3f} ms vs separable {sep_ms:.3f} ms "
          f"(median of 20, CUDA events)", flush=True)

    from torch.profiler import ProfilerActivity, profile

    def device_events(fn):
        """Device-side operations (kernels, copies) of one ``fn()`` call,
        recorded by torch.profiler: a list of (name, microseconds)."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]

    def kernel_us(events, name):
        times = [t for n, t in events if name in n]
        return sum(times) / len(times) if times else float("nan")

    # the wrappers on the scan's operands (0-d tensor coefficients on the
    # card, the transposed chain layout): no synchronisation (PyTorch's sync
    # debug mode raises on one) and nothing but the kernels on the device
    targs = kernel_args(wave32, Mr, f32, tensors=True)
    calls = {"K1": lambda: hk.morison_end_forces_cuda(*targs),
             "sweep": lambda: hk.chain_sweep_cuda(prep_th.fac, g_scan)}
    for kname, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ops = [n for n, _ in device_events(fn)]
        check(ops and all("kernel" in n for n in ops), f"{kname} wrapper: "
              f"{len(ops)} device operations, all its kernels ({ops}), no "
              "host-to-device copy, no synchronisation")

    # K1: its two kernels (fused pass + fixed-order totals) on one launch
    ev = device_events(lambda: hk.launch_morison(k_ops, False))
    k1_us = (kernel_us(ev, "morison_phase_batch_kernel")
             + kernel_us(ev, "morison_totals_kernel"))
    S_, M_, Q_, N_ = N_STEPS, Mr, 15, wave32.n_modes
    k1_bytes = 4 * (2 * S_ * M_ * 3 + S_ * 6 + S_ + 2 * N_ + 4
                    + refined32.n_nodes * 3 + M_) + 8 * 2 * M_
    k1_flops = S_ * M_ * Q_ * (2 * 2 * N_ * 5 + EPILOGUE_FLOP)
    k1_bound, k1_by = bound_us(k1_bytes, k1_flops)
    print(f"[bound] {smi}: K1 {k1_us:.1f} us on the device "
          f"(fused pass {kernel_us(ev, 'morison_phase_batch_kernel'):.1f} "
          f"+ totals {kernel_us(ev, 'morison_totals_kernel'):.1f}); bound "
          f"{k1_bound:.1f} us by {k1_by} ({k1_flops / 1e9:.2f} GFLOP, "
          f"{k1_bytes / 1e6:.1f} MB): {k1_bound / k1_us:.0%} of the bound; "
          f"{scan_launches['morison_phase_batch'] // 2} launch per scan, "
          f"{env_launches['morison_phase_batch']} per envelope call "
          f"(torch.profiler)", flush=True)

    # the sweep at the main path's own operands and layouts
    sweep_runs = {"nested level 1": scan_sweeps[0][1:],
                  "nested level 2": scan_sweeps[1][1:],
                  "thomas": (prep_th.fac, g_scan, False)}
    sweep_ms = {}
    for label, (fac, g, split) in sweep_runs.items():
        B, (n_int, Mc) = N_STEPS, fac.Cprime.shape[:2]
        g_chain = (g.reshape(*g.shape[:-3], -1, 6) if split else g)
        us = kernel_us(device_events(
            lambda: hk.chain_sweep_cuda(fac, g, split)), "chain_sweep_kernel")
        nbytes = 4 * (2 * B * n_int * Mc * 6 + 2 * B * Mc * 6
                      + 3 * n_int * Mc * 36 + 2 * Mc * 36)
        flops = 2 * B * Mc * (3 * n_int + 2) * 36
        sweep_ms[label] = (
            cuda_ms(lambda: hk.chain_sweep_cuda(fac, g, split)),
            cuda_ms(lambda: chain_sweep_plain(fac, g_chain)),
            us, *bound_us(nbytes, flops), nbytes)
    per_scan = scan_launches["chain_sweep"] // 2
    print(f"[time] {smi}: chain sweep, B={N_STEPS}, f32, the scan's own "
          f"layouts: "
          + "; ".join(f"{k}: kernel {a:.4f} ms through its wrapper "
                      f"({d:.1f} us on the device, bound {bd:.1f} us by "
                      f"{by} ({nb / 1e6:.1f} MB): {bd / d:.0%}) vs plain "
                      f"loop {b:.4f} ms"
                      for k, (a, b, d, bd, by, nb) in sweep_ms.items())
          + f"; {per_scan} launches per scan (2 per nested solve), "
          f"{env_launches['chain_sweep']} per envelope call (median of 20, "
          f"CUDA events; device time from torch.profiler)", flush=True)

    env_ms = cuda_ms(envelope32)
    print(f"[time] {smi}: fused f32 envelope {C} cases x {S} phases @ "
          f"{n_dof} DOF: {env_ms:.3f} ms total, {env_ms / C:.3f} ms per "
          f"360-phase scan (median of 20, CUDA events)", flush=True)

    for label, fn, per in (("one fused f32 flagship scan",
                            scan_fn("fused"), 1),
                           (f"the fused f32 envelope ({C} scans)",
                            envelope32, C)):
        events = device_events(fn)
        busy = sum(t for _, t in events) / 1e3
        n_sweep = sum("chain_sweep_kernel" in n for n, _ in events)
        print(f"[profile] {smi}: {label}: {len(events)} device operations "
              f"({len(events) / per:.0f} per scan; {n_sweep} chain-sweep "
              f"kernels), device busy {busy:.3f} ms ({busy / per:.3f} ms "
              f"per scan); K1 {kernel_us(events, 'morison_phase_batch'):.1f}"
              f" us, sweep {kernel_us(events, 'chain_sweep_kernel'):.1f} us "
              f"per launch (torch.profiler)" if events else
              f"[profile] {label}: torch.profiler recorded no device "
              "events: not measured", flush=True)

    l1 = sweep_ms["nested level 1"]
    print(json.dumps({"kernels": [{
        "name": "morison_phase_batch",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/morison_phase_batch.cu",
        "replaces": "small_fem_solver_tpu/ops/pallas_kernels.py:229",
        "launches": env_launches["morison_phase_batch"],
        "launches_by_path": {"scan": scan_launches["morison_phase_batch"],
                             "envelope": env_launches["morison_phase_batch"]},
        "launches_per_scan": scan_launches["morison_phase_batch"] // 2,
        "max_abs_err": kernel_err,
        "max_rel_err": kernel_rel,
        "ms": k_ms,
        "plain_ms": p_ms,
        "device_us": k1_us,
        "bound_us": k1_bound,
        "bound": k1_by,
        "bound_ms": k1_bound / 1e3,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "chain_sweep",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/chain_sweep.cu",
        "replaces": "benchmarks/ab_pallas_sweep.py:106 and "
                    "benchmarks/ab_pallas_sweep.py:114",
        "launches": env_launches["chain_sweep"],
        "launches_by_path": {"scan": scan_launches["chain_sweep"],
                             "envelope": env_launches["chain_sweep"]},
        "launches_per_scan": per_scan,
        "max_abs_err": sweep_err,
        "max_rel_err": sweep_rel,
        "ms": l1[0],
        "plain_ms": l1[1],
        "device_us": l1[2],
        "bound_us": l1[3],
        "bound": l1[4],
        "bound_ms": l1[3] / 1e3,
        "bound_by": l1[4],
        "library_ms": None,
        "by_level": {k: {"ms": a, "plain_ms": b, "device_us": d,
                         "bound_us": bd, "bound": by}
                     for k, (a, b, d, bd, by, _) in sweep_ms.items()},
    }]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
