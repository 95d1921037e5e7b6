"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's user paths at the JAX bench's sizes — the flagship
condensed phase scan (the default 3-leg jacket refined 32x to 9,612 DOF,
the Fenton N = 18 storm wave H = 17.038 m, T = 9.4 s, d = 50 m,
U_c = 1.7 m/s, a full FEM solve at 360 wave phases in float32), the
condensed storm envelope (10 Fenton cases, H = linspace(8, 17, 10) m, x 360
phases on the same mesh), the reference ``analyze`` on the six JSON
goldens, the dense and pointwise paths at 9,612 DOF in float64, the
99,882-DOF ``analyze_condensed`` / ``analyze_prepared`` in float64, the
same storm scan with every model and load option on foundation springs,
the dense design tier (``design_envelope``, ``design_sweep`` and the
resumable envelope over 1,000 Stokes cases), and structural dynamics
(modal, Craig-Bampton, harmonic and transient response at 9,612 DOF, modal
at 99,882 DOF, in float64), irregular seas, and the sparse and iterative
tier (``analyze(solver="pcg")`` at 9,612 and 99,882 DOF, the direct-write
BCSR assembly at 99,882 DOF; plain PyTorch, no kernel), and the design
tier after the envelope (pile springs and SSI, response spectra,
pushover and its rose, the member-removal screen, the code checks and
combinations, in float64), and the long-term tier (member and
environmental reliability under a fitted (Hs, Tp) climate, importance
sampling, section sensitivities and gradient sizing through autograd,
model I/O and reports), and the command line (all 23 subcommands) and
the GUI's headless core —
through both hand-written kernels, the fused Morison kernel (K1) and the
chain-sweep kernel, and checks them:

1. device and toolkit versions; full-f32 matmul settings; the port's
   default device is the card (the flagship model and wave are built
   without ``device``);
2. builds both CUDA kernels from the sources in this checkout (one nvcc
   per source, started together);
3. K1 phase: ``morison_phase_batch_cuda`` (f32) against the plain
   ``morison_phase_batch`` in f64 on the same (f32-rounded) inputs, at the
   flagship shapes, for Fenton and Airy waves, Wheeler stretching, a
   member count and a phase count off the kernel's tiles, and the scan's
   0-d tensor coefficients; bit-repeatable; then K1's case-batched
   float64 instance (its build report first: registers, spills and DMMA
   counts from ptxas -v and cuobjdump -sass) against the plain version in
   f64 (1e-12), with and without Wheeler, at its paths' four shapes: the
   dense envelope's 1,000 cases in one launch (36 phases, 51 members,
   Stokes-5 with 8 modes, per-case headings, per-(case, member) Cd,
   per-case Cm; cases 0, 517 and 999 bit-equal to one-case launches), the
   flagship (360 phases), the harmonic response (72) and the transient
   (1,536); one f64 launch a call, bit-repeatable, each shape's device
   time against its bound; and the f32 instance at the dense envelope's
   shapes (its own 8-mode template instance) against the f64 plain
   version (1e-5) (the f64 and dense-shape checks run after phase 4's
   wrapper checks, which stay the run's first profiler sessions); then
   K1's case-batched f32 instance (its build report: no spill, no HMMA)
   on the dense envelope's 1,000 cases in one launch, with and without
   Wheeler, against the plain version in f64 on the same f32-rounded
   inputs (1e-5), bit-repeatable, one case, a mid-batch block and the
   last case launched alone bit-equal to the whole batch's; its device
   time against its bound; then the pointwise Morison kernel
   (``csrc/morison_pointwise.cu``, no tensor-core instruction) at the
   slam scan's shapes (360 phases, 1,632 members, Fenton N 18, exact
   acceleration, slamming), both instances against the plain version in
   f64 (f32 1e-5 off the pairs with a point within 1e-4 m of a jump, f64
   1e-12), one launch a call, bit-repeatable, each instance's device time
   against its bound and the plain version's time, and the slam scan
   (``phase_scan_prepared``, f32, 360 phases, Cs 5.15) with its launch
   counts read from a reset: one pointwise launch, no K1 launch;
4. sweep phase: ``chain_sweep_cuda`` in f32 and f64 against
   ``chain_sweep_plain`` in f64 on the flagship chain factors (nested
   level 1 and 2, thomas), on random loads for 360 and 37 right-hand sides
   (the wide form) and 18 and 1 (the narrow form), contiguous and in the
   scan's transposed chain layout, and on the
   flagship scan's own loads, which the kernel reads in place (the nested
   level-1 (m, q) view, the transposed thomas layout); bit-repeatable (the
   f64 reference runs below go through the same kernel, so this phase is
   the sweep's independent check); then both wrappers on the scan's
   operands under PyTorch's sync debug mode (no synchronisation) and,
   in the run's first torch.profiler sessions, nothing but their kernels
   on the device;
5. scan phase: ``phase_scan_condensed(kinematics="fused")`` then
   ``prepare_condensed`` + ``phase_scan_prepared``, with both kernels'
   launch counts read around exactly that run (launches per scan: half);
   checked against the separable f64 scan of an f64 model, for
   equilibrium, and prepared == one-shot;
6. envelope phase: ``design_envelope_condensed(kinematics="fused")`` with
   both launch counts read around exactly that call; checked against the
   separable f64 envelope of the f64 model and against per-case prepared
   scans;
7. reference phase: the six goldens of ``tests/golden/`` (read with
   ``json``) through ``analyze`` on the card in f64, LU and Cholesky: load
   vector, displacements, reactions, member end forces, von Mises,
   utilization and the largest displacement at 1e-8 (numpy's allclose
   form), the singular case's least-squares fallback at 1e-6 with the
   orphan node's DOFs exactly 0, equilibrium at 1e-9, and the reference's
   36-step Morison phase scan (totals, critical time); the median
   ``analyze`` time at 126 DOF;
8. dense-at-size phase (9,612 DOF, f64; K is 739 MB): ``analyze``
   Cholesky against LU and against ``analyze_condensed`` (cuSOLVER against
   the chain-sweep kernel, 1e-9); ``analyze_phase_batch`` against
   ``phase_scan_condensed(kinematics="pointwise")`` at 36 phases (1e-9;
   the scan's loads through the pointwise kernel's f64 instance);
   the pointwise 360-phase f64 scan against the separable f64 scan of
   phase 5 (2e-6 of max |U| and of the Morison totals: the 1 cm clamp
   band), with the sweep's launch count read around exactly that scan;
   times and peak device memory;
9. large phase (n_seg = 327, 99,882 DOF, f64): ``analyze_condensed`` with
   the checks of ``tests/test_large.py`` (refined residual via
   ``chain_matvec`` 1e-9, equilibrium 1e-10, interface displacements
   within 5e-3 of n_seg = 8, total Morison within 5% of the coarse
   ``analyze``, 0.15 < max utilization < 0.35); ``analyze_prepared``
   against it (U, reactions, von Mises 1e-12, F2 1e-9); the f64 sweep
   kernel (its narrow form: every sweep here has B = 1) against the plain
   sweep on this analysis's own factors and loads, each bit-equal to
   column 0 of a wide launch of 40 columns; the sweep's launch counts
   around exactly one call of each (``analyze_prepared``: 4, all narrow);
   times, peak memory, and under torch.profiler
   the device operations and time of ``analyze_prepared`` and the sweep
   kernel's device time at both levels beside its bound;
10. timing with CUDA events (median of 20 synchronised runs after warm-up):
   K1 and its wrapper against the plain f32 version, the sweep kernel
   against the plain level loop, the fused scan against the separable
   scan, the envelope; under torch.profiler each kernel's device time
   beside its bound (the larger of its bytes over 3.35 TB/s and its FLOPs
   over 67 TFLOP/s FP32 or 34 TFLOP/s FP64, the H100 SXM's HBM and
   non-tensor-core rates, counted from this run's shapes; K1's f64 mode
   sums, a product of phase factors and spatial records, at the 67
   TFLOP/s of FP64 on the tensor cores, which is exact FP64), and the scan's
   device operations and busy time;
11. options phase (9,612 DOF, f64 model and solve): the default jacket
   with pinned h-braces and two conductors, legs-flooded buoyancy, 40 m/s
   wind with an 800 m^2 topside, supports on springs [1e6]*3 + [1e12]*3:
   ``phase_scan_condensed(kinematics="fused")`` over the 360-phase storm
   with the launch counts read around exactly that call (K1's f64
   instance once, its f32 one never, the sweep 4 times), against the
   separable f64 scan at 1e-12 (utilization, its maximum, U: the same f64
   loads), equilibrium 1e-9, reactions == -k u_support 1e-8, and stiff
   springs [1e13]*3 + [1e19]*3 within 1e-5 of the clamped scan; then the
   condensed envelope of the f64 model (3 Stokes-5 cases x 36 phases at
   n_seg 8, f64 solve) with the default kinematics: K1 f64 once a case,
   ``max_util_per_case``, ``member_envelope`` and ``max_util_per_phase``
   equal to the separable envelope's at 1e-12;
12. dense envelope phase: 1,000 cases (Stokes-5, H = linspace(2, 14, 50)
   m x 20 headings of wave and current, T = 9.4 s, d = 50 m, U_c = 1.7
   m/s) x 36 phases through ``design_envelope`` on the default jacket
   (126 DOF, f64): exactly one launch of K1's case-batched f64 instance
   for the 1,000 cases, every case against the CPU f64 plain run at 1e-10
   (the reductions, the full
   utilization [C, S, M] and the Morison totals), the governing case
   against ``analyze_phase_batch``; time, device operations and busy time,
   peak memory; then an f32 copy of the model through the same call (one
   launch of K1's case-batched f32 instance for the 1,000 cases, its
   Morison totals at 1e-6, its full utilization at 3e-5: the f32 solve
   and recovery as well), its time and its K1 device time;
13. sweep phase: ``design_sweep`` of the same cases at t_analysis = 0 and
   ``critical_case``; the governing and 4 seeded random cases against a
   per-case ``analyze`` (1e-10); time;
14. resume phase: ``design_envelope_resumable`` in chunks of 64 in a
   temporary directory: a bounded call returns None, the resumed call
   equals the one-shot envelope (1e-12), a mismatched resume raises;
15. dynamics phase (9,612 DOF, f64, 1,100 t topside), every call against
   the port's CPU f64 run of the same call, with its launch counts read
   around exactly that call: ``modal_analysis_condensed`` (10 modes, 12
   chain modes; clamped and dry, then on springs with added mass: 10
   sweep launches each, frequencies 1e-10, 1 - MAC 1e-8, longer periods);
   the dense ``modal_analysis`` on the card at n_seg = 8 against
   Craig-Bampton with 16 chain modes (2e-6); ``dynamic_response_condensed``
   of the flagship storm (72 steps, 6 harmonics: one launch of K1's f64
   instance, 10 sweep launches) and ``fatigue_screen`` on its von Mises
   history; the harmonic response at 10, 12 and 14 chain modes, card vs
   CPU (at 10 and 14 utilization too at 1e-9), with the chain that carries
   the difference, its Ritz and exact gaps at the cut, and the CPU run
   against itself on the jacket moved 1e-11 m;
   ``transient_response_condensed`` over 12 periods at T/128 ramped over 2
   (one K1 launch at S = 1,536) against the harmonic steady
   state (5e-3 utilization, 2e-2 tip history); the transient with relative
   drag (2 iterations), free decay from mode 1 (the damping-ratio check)
   and a seeded ground-acceleration record; each call's host time, device
   operations, busy time and peak memory;
16. large modal phase: ``modal_analysis_condensed`` at 99,882 DOF (10
   sweep launches at depth 326, all in the narrow form), the first 8
   frequencies within 2e-3 of the 9,612-DOF ones; time and peak memory;
   then the narrow sweep phase: the sweep's narrow form on the first
   sweep of the 99,882-DOF ``analyze_prepared`` (B 1, 108 levels) and of
   the chain-mode iteration at 9,612 and 99,882 DOF (B 18, 31 and 326
   levels), f64 against the plain sweep (1e-12), f64 and an f32 copy
   bit-equal to a wide launch's columns, bit-repeatable; device times
   beside the bytes bound and the dependent-step floor (2 n_int steps x
   one step's latency, the slope between the two chain-mode depths);
17. K1-sea phase: K1's general-mode (random sea) instance on the flagship
   mesh with per-member Cd / Cm, f32 against the plain version in f64 on
   the same f32-rounded inputs (1e-5) and f64 against f64 (1e-12), one
   launch a call, bit-repeatable, at N = 64 (2,048 samples, Wheeler), 48
   (a power-law current), 37 (spread, Wheeler, 1,023 samples) and 256
   (spread); its device time at the sea scan's shapes beside its bound;
18. sea phase: ``sea_scan_prepared`` (JONSWAP Hs 6.5 m, Tp 9.4 s, 64
   components, U_c 1 m/s, Wheeler, 2,048 samples at Tp / 10) on the f32
   and the f64 handle of the flagship mesh (one K1-sea launch and the
   scan's sweeps each), f32 against f64, equilibrium, card against the
   port's CPU f64 run at 256 samples (1e-9), the spread sea (s = 4, 256
   samples) likewise, and the spectral fatigue screen of the history;
19. frequency-domain phase: ``spectral_response_prepared`` and
   ``spectral_response_dynamic`` (12 chain modes) at 9,612 DOF in f64,
   card against CPU (the quasi-static response at refine 8, 1e-9; the
   dynamic one at phase 15's 12-chain-mode limits);
20. scatter phase: ``scatter_fatigue_spectral`` as the JAX bench runs it
   (refine 8, f32, its 10 and 40 states, 32 components: ms per state and
   the marginal ms per state), the dynamic diagram of the 10 states at
   9,612 DOF in f64 and ``long_term_extremes`` on it, 3 states at refine 8
   card against CPU (1e-9), and the time-domain ``scatter_fatigue`` over 4
   states at 9,612 DOF (one K1-sea launch a state);
21. sea transient phase: ``transient_response_condensed`` driven by the
   sea (64 components, dt 0.1 s, 1,024 steps, 12 chain modes, f64) and
   its relative-drag variant (256 steps), card against CPU (U 1e-9,
   utilization 1e-7);
22. Queue C phase: calls past K1's limits that the JAX package runs, a
   40-mode Airy ``design_envelope`` (126 DOF, f64) and a
   ``dynamic_response`` at ``n_gauss`` = 20: no K1 launch, one plain
   route each, the CPU's result (1e-12 / 1e-9);
23. PCG phase (9,612 DOF, f64, the storm of ``tests/test_pcg_precond.py``):
   ``analyze(solver="pcg")`` with block-Jacobi and two-level at tol 1e-10
   against the Cholesky solve (U rtol 1e-8 / atol 1e-9 x max |U|,
   utilization rtol 1e-7), two-level >= 3x fewer iterations, the counts
   within 1% of the port's CPU run (printed beside JAX's recorded 4,275 /
   621), ``pcg_chunk`` 50 bit-equal to 0, a second run bit-equal; times,
   peak memory and the per-iteration device profile against its bound;
24. large PCG phase (99,882 DOF, two-level, chunks of 200, f64) against
   phase 9's ``analyze_condensed``: the bench's call (tol 1e-8,
   ``accel="fd"``; utilization within 0.1) and the condensed solve's
   loads (``accel="analytic"``) at tol 1e-8 and 1e-10 (utilization within
   1e-8); each with ||P(K U - F)|| / ||P F|| recomputed on the host in
   extended precision (2e-8) and a second run bit-equal; times, peak
   memory, the iteration's and the mat-vec's device time against their
   bytes bounds;
25. assembly phase (99,882 DOF, f32 and f64): the direct-write BCSR
   assembly against the generic one (5e-6 / 1e-12), bit-repeatable;
   GDOF/s of single calls and of 64 in a row, device time against the
   bytes bound;
26. single-rank distribution phase (an NCCL group of this process,
   ``parallel.multihost.init_multihost``, 1-D DeviceMeshes ``cases`` and
   ``dof``): the flagship condensed envelope (10 Fenton cases x 360
   phases, f32, fused) bit-equal to phase 6 with the same K1 and sweep
   launches, the 1,000-case f64 dense envelope (one K1 launch) bit-equal
   to phase 12, the sweep and the bench's scatter diagram bit-equal to
   their unsharded calls, and ``analyze(solver="pcg", mesh=)`` at 99,882
   DOF (the bench's call and the condensed loads' call: iterations within
   1% of phase 24's and of 1,354, utilization within 1e-8 of
   ``analyze_condensed``, a second run bit-equal, collectives, wall and
   busy time an iteration); the group is destroyed; then the host time
   of a call of the PCG's collectives in two new single-rank processes,
   c10d's flight recorder at its default buffer and off: fresh, after
   10,000 collectives and after a profiler session;
27. two-rank distribution phase (``spawn_ranks``: two gloo ranks on the
   one card, collectives staged through the host): K1's f64 instance on
   the second half of the 1,000 cases against its plain version and bit
   for bit against the whole batch's launch; the flagship envelope (5
   cases a rank) bit-equal to phase 6, the dense envelope (500 cases a
   rank) against phase 12 (1e-12, bit-equality reported) and PCG at 9,612
   DOF against the Cholesky solve; both ranks bit-equal, each rank's
   launches and collectives;
28. P-delta and buckling phase (f64): ``analyze_pdelta`` and
   ``buckling_analysis`` at 126 DOF against the CPU (1e-9),
   ``analyze_pdelta_condensed`` at 9,612 DOF against the dense
   ``analyze_pdelta`` (1e-9) and at 99,882 DOF, with the sweep launches
   of each round and the sweep kernel against its plain version on a
   round's factor, and ``buckling_analysis_condensed`` (12 chain modes)
   against the dense factors at 9,612 DOF (1%);
29. soil phase (f64, the Airy storm at t = 0.34 s): ``soil_support_stiffness``
   of the CLI's clay-over-sand profile and a 2,134 x 50 mm, 60 m pile
   (64 elements) from the clamped analysis's reactions, its 9 Newton
   solves on the card, against the CPU (1e-10), Newton residuals below
   1e-8; ``analyze_ssi`` on those springs against the CPU (1e-9) and
   ``analyze_condensed(support_stiffness=)`` at 9,612 and 99,882 DOF
   (equilibrium 1e-9, the sweep launches);
30. seismic phase (EC8 ground C, 0.2 g, three directions, 1,100 t):
   ``response_spectrum`` at 126 DOF against the CPU (CQC 1e-9; SRSS and
   100-40-40 on the CPU's shapes), ``response_spectrum_condensed`` at
   9,612 DOF (10 sweep launches) against the CPU (CQC, 1e-9 at 14 chain
   modes; at 12 the periods at 1e-9, the rest reported: that cut splits
   degenerate chain-mode pairs) and at 99,882 DOF (periods against phase
   16's);
31. pushover phase (the CLI's defaults: lambda to 6 in 25 steps, 120
   iterations): ``pushover`` against the CPU (RSR, first yield and flags
   equal, curves 1e-9), ``pushover_rose`` at 16 headings (400 states a
   batched iteration) against the CPU at 4 headings, bit-equal in a
   single-rank NCCL group, and in two gloo ranks (phase 27's spawn);
32. removal phase: ``member_removal_screen``, 51 removals in one batched
   factorization, against the CPU (flags equal, utilizations 1e-10);
33. checks phase: the API RP 2A and ISO 19902 member checks, the API joint
   check, the VIV screen, the air gap (Airy and Stokes-5) and
   ``combo_envelope`` of three load cases against the CPU (1e-12); each
   of phases 29-33 with its wall time, device operations, busy time and
   peak memory;
34. reliability phase (f64, the default jacket, the storm case, Airy
   design waves, 12 phases, the synthetic climate of
   tests/test_reliability.py): ``member_reliability`` on
   ``member_utilization_response_batch`` at threshold 0.3 (K1's f64
   launches = ``n_envelopes``, one a batch; K1 against its plain version
   at the first batch, 1e-12; flags and envelope count equal to a CPU run,
   beta and design storms 1e-8), ``importance_sample_batch`` at 1,000
   samples (one K1 launch; pf and cov against the CPU on the same samples,
   1e-10) and the scalar ``environmental_reliability`` (no launch; its
   evaluations and beta against the CPU);
35. design phase (f64, the Stokes-5 storm at t = 0.34 s):
   ``section_sensitivities`` at 126 and 9,612 DOF (the backward of a
   dense f64 Cholesky on the card) against the CPU f64 (1e-10) and
   central differences at h = 1e-3 mm and 10h (1e-6 at 126 DOF; 4e-5 and
   4e-6 at 9,612 DOF, the roundoff bound);
   ``optimize_sections`` to 0.5 in 80 iterations against the CPU (1e-8);
   no launch;
36. I/O phase: a model JSON loaded onto the card, the member-force CSV
   and the text reports of the card's storm analysis against the CPU's
   (1e-9), ``validate_sections``; matplotlib not imported.  Each of phases
   34-35 with its wall time, device operations, busy time and peak
   memory;
37. CLI phase: all 23 subcommands of ``small_fem_solver_tpu_torch.cli``
   through ``cli.main(argv)`` in this process, stdout captured, no
   ``--device`` (the card), at the CLI's defaults (34 invocations: also
   ``refined --f32``, ``pushover --rose 16``, ``pile --from-analysis
   --analyze``, the four ``fatigue`` routes, both ``spectral`` and both
   ``transient`` forms; ``contour`` and ``reliability`` on the seed-3
   climate of phase 34 written to a file, ``reliability --monte-carlo
   1000`` at phase 34's threshold and Airy waves): each exits cleanly;
   both kernels' launches read around exactly that call (``refined``: K1
   f64 1, f32 0; ``refined --f32``: f32 1; ``envelope``: f64 8);
   ``refined`` (f64 and f32) and the importance check with the same
   launches and result as
   the script's own library call (f64 1e-9, f32 vs f64 1e-4, pf and cov
   1e-10); the 24 invocations at 126 DOF print what the same argv with
   ``--device cpu`` prints (``tests/cli_text.py``: numbers within one unit
   of the last digit; the CPU runs in 3 spawned processes meanwhile);
   ``run --wave-model airy --json-out`` against the default golden
   (1e-8); ``python -m small_fem_solver_tpu_torch.cli`` once as a
   subprocess (its JSON equal to the in-process one); K1 f64 launch
   shapes with ``harm64_bound``, and the device time of each invocation's
   first K1 f64 launch on its own operands beside that bound; the device
   operations and busy time of ``refined``'s f64 scan; each invocation's
   host wall time;
38. GUI phase: ``gui.run_analysis_core`` on the card against the default
   golden (1e-8) and the CLI's run (1e-12), and ``show_damage_screen`` /
   ``show_spectral_fatigue`` through stubs on the card's results against
   the CPU's text; no tkinter imported.

Every new path is run with the launch counts set to 0 just before it and
read just after it; a mean or MPM stress is compared to one of its
member's tied governing circumferential points (opposite points of a
member without axial stress variance tie to roundoff).

Prints the whole script's wall time, then the kernel record and the
card's name and power limit on the lines before the last, and ``{"ok": true, "device": {...}}`` as the last line.
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
F64_LOADS_TOL = 1e-12 # an f64 model's fused scan and envelope (K1 f64 loads)
                      # vs separable: the same f64 loads, summed in another
                      # order
F64_ENV_SEG = 8       # the f64 condensed envelope check: n_seg (the CLI's
F64_ENV_HS = (8.0, 12.5, 17.0)  # envelope), Stokes-5 heights, 36 phases
EQ_TOL_F32 = 1e-4     # reactions balance the applied loads (f32 solve)
EQ_TOL_F64 = 1e-9     # ... (f64 solve)
PREP_TOL = 1e-6       # prepared scan vs one-shot scan
N_SEG_LARGE = 327     # 99,882 DOF (bench.py:563-598, tests/test_large.py)
N_DOF_LARGE = 99882
GOLDENS = ("default", "variant", "shallow", "singular", "custom_tower",
           "autogen_4leg")
GOLDEN_TOL = 1e-8     # analyze vs the reference's goldens (allclose_err)
SINGULAR_TOL = 1e-6   # ... the least-squares fallback (LAPACK gelsd's tail)
DENSE_TOL = 1e-9      # f64 at 9,612 DOF: Cholesky vs LU vs condensed,
                      # phase batch vs pointwise condensed scan
POINTWISE_TOL = 2e-6  # pointwise vs separable f64 scan (the clamp band;
                      # tests/test_condense.py:103-128)
RESID_TOL = 1e-9      # 99,882 DOF: refined residual (tests/test_large.py)
EQ_TOL_LARGE = 1e-10  # ... equilibrium
INTERFACE_TOL = 5e-3  # ... interface U vs n_seg = 8
MORISON_TOTAL_TOL = 0.05  # ... total Morison vs the coarse analyze
QUEUE_C_ENV_TOL = 1e-12  # 40-mode design_envelope, card vs CPU (plain
                         # version on both)
QUEUE_C_DYN_TOL = 1e-9   # dynamic_response at n_gauss 20, card vs CPU
PCG_TOL = 1e-10       # 9,612-DOF PCG (tests/test_pcg_precond.py:27-44)
PCG_UTIL_RTOL = 1e-7  # ... utilization vs Cholesky, relative
PCG_PROFILE_ITERS = 50  # CG iterations in one profiler session
PCG_LARGE_UTIL_TOL = 0.1  # 99,882 DOF, the bench's call (accel fd) vs
                          # analyze_condensed (accel analytic; JAX 4.96e-2)
PCG_LARGE_UTIL_TOL_MATCHED = 1e-8  # ... with the condensed solve's loads
                          # (accel analytic), tol 1e-8 (PERF.md §6)
PCG_LARGE_UTIL_TOL_1E10 = 1e-8  # ... and at tol 1e-10 (PERF.md §6)
PCG_TRUE_RESID_LIMIT = 2e-8  # ||P(KU - F)|| / ||P F|| recomputed on the
                          # host: the CG recurrence's residual drifts from
                          # it by rounding (PERF.md §6)
ASM_TOL_F32 = 5e-6    # direct-write vs generic assembly
ASM_TOL_F64 = 1e-12   # (tests/test_assembly_direct.py:25-28)
PREP_ANALYZE_TOL = 1e-12  # analyze_prepared vs analyze_condensed: U,
PREP_F2_TOL = 1e-9        # reactions, von Mises; F2 (tests/test_condense.py)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12     # H100 SXM FP32 outside the tensor cores
FP64_FLOP_PER_S = 34e12     # H100 SXM FP64 outside the tensor cores
FP64_TC_FLOP_PER_S = 67e12  # ... on the tensor cores (DMMA: exact FP64)
SWEEP_KERNEL = "chain_sweep"  # device records of both sweep forms' kernels
F32_BATCH_KERNELS = ("morison_f32_batch_kernel",
                     "morison_f32_batch_totals_kernel")
EPILOGUE_FLOP = 60    # K1 per (phase, point): normal projection, drag,
                      # inertia, lever-rule sums
POINTWISE_MODE_FLOP = 18    # pointwise kernel per (phase, point, mode)
POINTWISE_POINT_FLOP = 100  # ... per (phase, point): sincos, forces, slam,
                            # lever-rule sums
CASE = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
            F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
# options phase: two conductors between leg nodes (tests/test_appurtenances.py
# specs), legs flooded, 40 m/s wind at 38 deg on an 800 m^2 topside
# (tests/test_wind.py:83-84), supports on foundation springs
APPS = [{"name": "C1", "node1": "A2", "node2": "A3", "D_mm": 700.0,
         "cd_mult": 0.8, "cm_mult": 1.1},
        {"name": "RISER-B", "node1": "B1", "node2": "B2", "D_mm": 610.0,
         "cd_mult": 1.05, "cm_mult": 0.95}]
OPTIONS_CASE = dict(buoyancy="legs-flooded", wind_speed_ms=40.0,
                    wind_dir_deg=38.0, wind_topside_area_m2=800.0)
SPRINGS = [1e6] * 3 + [1e12] * 3      # N/mm, N*mm/rad
STIFF_SPRINGS = [1e13] * 3 + [1e19] * 3   # tests/test_ssi.py:21-31
SPRING_TOL = 1e-8     # reactions == -k u_support
STIFF_TOL = 1e-5      # stiff springs vs the clamped scan
# dense design tier: 50 heights x 20 headings = 1,000 cases (BASELINE.md:31)
DESIGN_HS = (2.0, 14.0, 50)           # linspace(2, 14, 50) m
DESIGN_HEADINGS = (0.0, 360.0, 18.0)  # arange: 0-342 deg, wave = current
DESIGN_STEPS = 36
DENSE_LOAD_TOL = 1e-6 # dense envelope of the f32 model on the card (K1 f32
                      # loads) vs the CPU f64 run: total_morison, relative to
                      # its maximum (K1's f32 error against its plain
                      # version is ~6e-7, phase 3)
DENSE_UTIL32_TOL = 3e-5  # ... its full utilization [C, S, M], relative to
                        # its maximum: the f32 solve and recovery as well,
                        # set from measurement (1.31e-5 on an H100)
GOV_TOL = 2e-5        # governing case vs analyze_phase_batch
                      # (tests/test_envelope.py:97-102)
SWEEP_CASE_TOL = 1e-10  # design_sweep vs per-case analyze
RESUME_TOL = 1e-12    # resumed chunked envelope vs one design_envelope
RESUME_CHUNK = 64
SHORT_REPS = 50       # calls of a short function in one profiler session
KERNEL_TOL_F64 = 1e-12  # K1's f64 instance vs its plain f64 version
N_GAUSS = 15          # Gauss points a member (the Morison paths' default)
DENSE_F64_TOL = 1e-10 # dense f64 envelope on the card (K1 f64) vs the CPU
                      # f64 run: utilization, total_morison, reductions
# dynamics at 9,612 DOF (f64), against the port's CPU f64 run of each call
TOPSIDE_T = 1100.0    # topside mass (tests/test_dynamics.py)
HARMONIC_STEPS = 72   # dynamic_response_condensed's phases (phase 15)
TRANSIENT_STEPS = 1536  # transient_response_condensed: 12 periods at T / 128
CHAIN_MODES = 12      # retained chain modes of the Craig-Bampton basis
MODAL_FREQ_TOL = 1e-10  # frequencies, relative
MODAL_MAC_TOL = 1e-8  # 1 - MAC of each card mode against its CPU mode's
                      # span (the span of a degenerate pair: sway pairs
                      # rotate freely inside it)
CB_DENSE_TOL = 2e-6   # Craig-Bampton (16 chain modes) vs dense modal at
                      # n_seg = 8 (tests/test_dynamics.py:188-205)
HARMONIC_TOL = 1e-9   # dynamic_response_condensed card vs CPU: U, DAF
TRANSIENT_TOL = 1e-9  # transient_response_condensed card vs CPU: U, tip
UTIL_DYN_TOL = 1e-7   # ... their utilization and the fatigue screen on it
                      # at 12 chain modes, set from measurement (1.6e-8
                      # harmonic, 2.4e-8 transient on an H100): the
                      # 12-mode cut splits exactly degenerate bending pairs
                      # whose Ritz values the subspace iteration leaves
                      # only ~3e-10 apart in two chains, so roundoff
                      # rotates the kept vector (the CPU run alone, on the
                      # jacket moved 1e-11 m, moves by 3.4e-9); 10 and 14
                      # chain modes, Ritz gaps from ~1e-8, are held at
                      # HARMONIC_TOL
STEADY_UTIL_TOL = 5e-3  # transient last period vs harmonic (n_steps = 128)
STEADY_TIP_TOL = 2e-2   # ... tip history (tests/test_dynamics.py:329-366)
DECAY_ZETA_RTOL = 0.01  # free decay: damping ratio, damped period
DECAY_PERIOD_RTOL = 5e-3  # (tests/test_dynamics.py:248-284)
MESH_FREQ_TOL = 2e-3  # 99,882 vs 9,612 DOF frequencies
# irregular seas (JONSWAP gamma 3.3, d = 50 m; the half-hour realization of
# the JAX package's sea_scan_prepared example)
SEA_HS, SEA_TP, SEA_D, SEA_UC = 6.5, 9.4, 50.0, 1.0
SEA_N = 64            # components
SEA_STEPS = 2048      # samples at Tp / 10
SPREADING_S = 4.0     # the spread sea's cos^2s spreading exponent
SPREAD_STEPS = 256
SEA_CHECK_STEPS = 256  # card vs CPU f64 at a reduced sample count
SEA_TOL = 1e-9        # sea scan card vs CPU f64 (U, von Mises, reactions)
# f32 sea scan vs f64 over every sample, set from measurement (4.2e-4 and
# 6.2e-4 on an H100): a Gauss point within ~1e-6 m of the surface flips
# wet / dry between the f32 and f64 models; off the samples with a point
# within hk.SURFACE_BAND of it the flagship's limits (U_TOL, UTIL_TOL) hold
SEA_F32_U_TOL = 1e-3
SEA_F32_UTIL_TOL = 1.5e-3
# ... its Morison totals off the band (4.95e-5 measured): the f32 sea's
# frequencies carry a relative rounding of ~6e-8, which the 1,925 s
# record turns into phase drifts of ~1e-4 rad
SEA_F32_TOTAL_TOL = 2e-4
FD_TOL = 1e-9         # spectral response / scatter card vs CPU f64, refine 8
TIED = 1e-9           # two circumferential points' variances tie
SEA_TRANSIENT_STEPS = 1024
# bench.py:285-289: the scatter diagrams of the JAX bench
SCATTER_STATES = [(2.5 + 0.5 * i, 7.0 + 0.3 * i, 0.05, 36.0 * i)
                  for i in range(10)]
SCATTER_STATES40 = [(2.5 + 0.125 * i, 7.0 + 0.075 * i, 0.0125, 9.0 * i)
                    for i in range(40)]
TD_STATES = 4         # time-domain scatter: the first 4 bench states
                      # (tests/test_dynamics.py:207-220)


SMI = ""              # the card's name and power limit (set in main)


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


def bound_us(nbytes: float, flops: float, flop_rate=FP32_FLOP_PER_S):
    """(bound in us, what bounds it): the larger of the bytes over the
    device-memory rate and the FLOPs over the given rate (FP32 unless
    said)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e6,
            "bytes" if t_bytes >= t_ops else "operations")


def sweep_bound(itemsize: int, B: int, n_int: int, C: int):
    """(bound us, by, bytes) of one chain sweep: factors Dinv, DinvL,
    Cprime and B0, Cn read once, g read and v written once, fI and fJ
    written once; 36 multiply-adds per 6x6 block product (3 per level
    and right-hand side, plus the 2 interface products)."""
    nbytes = itemsize * (2 * B * n_int * C * 6 + 2 * B * C * 6
                         + 3 * n_int * C * 36 + 2 * C * 36)
    flops = 2 * B * C * (3 * n_int + 2) * 36
    return (*bound_us(nbytes, flops, FP32_FLOP_PER_S if itemsize == 4
                      else FP64_FLOP_PER_S), nbytes)


def device_events(fn, reps: int = 1, host: bool = True):
    """Device-side operations (kernels, copies) of ``reps`` calls of
    ``fn`` in one torch.profiler session: a list of (name, microseconds).
    ``host=False`` traces the device only (cheaper for calls of tens of
    thousands of operations).

    On the H100 host the profiler loses a few device records of every
    session once earlier sessions were traced, more with each session
    (``profiler_probe.py``): a session of one short call can come back
    empty, so short calls are recorded ``SHORT_REPS`` times over."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # the device-side mirrors of record_function spans (the port's fem.*
    # layer spans) are not device operations
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_us(events, name):
    times = [t for n, t in events if name in n]
    return sum(times) / len(times) if times else float("nan")


def kernel_median_us(events, name):
    """The median device time of the records named ``name`` (one record
    of a session can come back far off its launch's time)."""
    times = sorted(t for n, t in events if name in n)
    return times[len(times) // 2] if times else float("nan")


def top_device_ops(events, k: int = 5) -> str:
    """The ``k`` device operations with the most total time: "name
    count x total us" each, names cut to 40 characters."""
    total, count = {}, {}
    for n, t in events:
        total[n] = total.get(n, 0.0) + t
        count[n] = count.get(n, 0) + 1
    top = sorted(total, key=total.get, reverse=True)[:k]
    return "; ".join(f"{n[:40]} {count[n]}x {total[n]:.1f} us" for n in top)


def narrow_equals_wide(hk, fac, gs, split, got, width: int) -> bool:
    """Whether ``got`` (a narrow launch's fI, fJ, v on ``gs``) is bit-equal
    to the first columns of a wide launch on the same factors: ``gs``'s
    B columns followed by seeded random ones up to ``width`` (>= the
    narrow threshold)."""
    import numpy as np
    import torch
    g = gs.reshape(*gs.shape[:-3], -1, 6) if split else gs
    g = g.reshape(-1, *g.shape[-3:])
    B = g.shape[0]
    pad = torch.tensor(np.random.default_rng(width).normal(
        size=(width - B, *g.shape[1:])), dtype=g.dtype, device=g.device)
    wide = hk.chain_sweep_cuda(fac, torch.cat([g, pad * g.abs().max()]))
    n_int, C = fac.Cprime.shape[:2]
    fI, fJ, v = got
    mine = (fI.reshape(B, C, 6), fJ.reshape(B, C, 6),
            v.reshape(B, n_int, C, 6))
    return (hk.sweep_narrow_rhs(width, n_int, g.element_size()) == 0
            and all(torch.equal(a, b[:B]) for a, b in zip(mine, wide)))


def first_sweep(condense_mod, hk, fn):
    """The operands (fac, g, split) of the first chain sweep that ``fn()``
    runs; ``fn`` is stopped there."""
    class Stop(Exception):
        pass
    seen = []

    def stopping_sweep(fac, g, split=False):
        seen.append((fac, g, split))
        raise Stop
    condense_mod.chain_sweep_cuda = stopping_sweep
    try:
        fn()
    except Stop:
        pass
    finally:
        condense_mod.chain_sweep_cuda = hk.chain_sweep_cuda
    return seen[0]


def record_sweeps(condense_mod, hk, fn):
    """Run ``fn()`` with every chain sweep of ``ops.condense`` recorded:
    a list of the kernel's operands (fac, g, split), in call order."""
    seen = []

    def recording_sweep(fac, g, split=False):
        seen.append((fac, g, split))
        return hk.chain_sweep_cuda(fac, g, split)
    condense_mod.chain_sweep_cuda = recording_sweep
    try:
        fn()
    finally:
        condense_mod.chain_sweep_cuda = hk.chain_sweep_cuda
    return seen


def peak_mib(fn) -> float:
    """Peak device memory allocated during ``fn()`` in MiB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def peak_over_mib(fn) -> float:
    """Peak device memory ``fn()`` allocates above what the process holds
    when it starts, in MiB."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def allclose_err(a, b) -> float:
    """max |a - b| / (|b| + max(max |b|, 1)): ``<= tol`` is numpy's
    ``assert_allclose(a, b, rtol=tol, atol=tol * max(max |b|, 1))``, the
    goldens' criterion in ``tests/test_end_to_end.py``."""
    import torch
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    return float(((a - b).abs()
                  / (b.abs() + b.abs().max().clamp(min=1.0))).max())


def golden_setup(pt, g, dev):
    """(model, wave, case) of a reference golden on ``dev``, in f64."""
    p = g["params"]
    sections = dict(leg_section=(p["D_leg"], p["t_leg"]),
                    brace_section=(p["D_brace"], p["t_brace"]),
                    rho_steel=p["rho_steel"])
    if "geometry" in g:
        geom = g["geometry"]
        model = pt.build_model({k: tuple(v) for k, v in geom["nodes"].items()},
                               geom["members"], geom["fixed"], geom["top"],
                               **sections, device=dev)
    else:
        model = pt.default_3leg_jacket(**sections, device=dev)
    case = pt.LoadCase(
        E=p["E"], nu=p["nu"], fy=p["fy"], rho_water=p["rho_water"],
        wave_dir_deg=p["wave_dir"], current_dir_deg=p["current_dir"],
        Cd=p["Cd"], Cm=p["Cm"], F_axial_kN=p["F_axial_kN"],
        F_shear_kN=p["F_shear_kN"], M_moment_kNm=p["M_moment_kNm"],
        M_torsion_kNm=p["M_torsion_kNm"],
        custom_sw_tonnes=p.get("custom_sw_tonnes", 0.0),
        t_analysis=p["t_analysis"], sw_mode=p["sw_mode"])
    return (model, pt.airy_wave(p["H"], p["T"], p["d"], p["U_c"],
                                device=dev), case)


def golden_errors(res, model, fem) -> dict:
    """:func:`allclose_err` of every recorded field of a golden."""
    import torch
    ref_if = fem["internal_forces"]
    errs = {"F_global": allclose_err(res.F_applied, fem["F_global"]),
            "U": allclose_err(res.U, fem["U"]),
            "reactions": allclose_err(res.reactions, [
                fem["reactions"][n] for n in model.fixed_node_names()]),
            "von_mises": allclose_err(res.von_mises, [
                m["von_mises_max_MPa"] for m in ref_if]),
            "utilization": allclose_err(res.utilization, [
                m["utilization"] for m in ref_if])}
    for col, key, scale in ((0, "Fx_max_kN", 1e3), (1, "Fy_max_kN", 1e3),
                            (2, "Fz_max_kN", 1e3), (4, "My_max_kNm", 1e6),
                            (5, "Mz_max_kNm", 1e6)):
        ours = torch.maximum(res.F1_local[:, col].abs(),
                             res.F2_local[:, col].abs()) / scale
        errs[key] = allclose_err(ours, [m[key] for m in ref_if])
    disp = torch.tensor(fem["U"], dtype=torch.float64).reshape(-1, 6)[:, :3] \
        .norm(dim=-1)
    errs["max_displacement_mm"] = abs(float(res.max_displacement_mm)
                                      / float(disp.max()) - 1.0)
    return errs


def reference_phase(pt, dev) -> float:
    """The six reference goldens through ``analyze`` on the card (126-DOF
    class models, f64): every recorded field at 1e-8 (LU and Cholesky),
    the singular case's least-squares fallback at 1e-6 with the orphan's
    DOFs exactly 0, equilibrium, and the reference's 36-step Morison scan.
    Returns the median ``analyze`` time of the default golden (Cholesky)."""
    import torch
    from small_fem_solver_tpu_torch.models import autogen
    gdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "golden")
    worst, setups = {}, {}
    for name in GOLDENS:
        with open(os.path.join(gdir, f"{name}_case.json")) as f:
            g = json.load(f)
        fem, scan_ref, p = g["fem"], g["phase_scan"], g["params"]
        model, wave, case = setups[name] = golden_setup(pt, g, dev)
        singular = name == "singular"
        tol = SINGULAR_TOL if singular else GOLDEN_TOL
        if name == "autogen_4leg":
            nodes = g["geometry"]["nodes"]
            check(autogen.auto_generate_h_braces(
                nodes, autogen.auto_generate_legs(nodes, []))
                == [{k: m[k] for k in ("name", "node1", "node2", "type")}
                    for m in g["geometry"]["members"]],
                "autogen reproduces the reference's generated members")
        for solver in ("lu",) if singular else ("lu", "chol"):
            res = pt.analyze(model, wave, case, solver=solver,
                             lstsq_fallback=singular)
            check(res.U.device.type == "cuda" and res.U.dtype
                  == torch.float64, f"{name} {solver}: f64 on the card")
            errs = golden_errors(res, model, fem)
            disp = torch.tensor(fem["U"]).reshape(-1, 6)[:, :3].norm(dim=-1)
            check(int(res.max_displacement_node) == int(disp.argmax()),
                  f"{name} {solver}: node of the largest displacement")
            check(allclose_err(res.length_m, [m["length_m"] for m in
                                              fem["internal_forces"]])
                  <= 1e-10, f"{name}: member lengths")
            field, err = max(errs.items(), key=lambda kv: kv[1])
            worst[f"{name} {solver}"] = err
            check(err <= tol, f"golden {name} ({solver}{', lstsq' * singular}"
                  f"): {len(errs)} fields, worst {field} {err:.2e} <= {tol:g}")
            if singular:
                orphan = model.node_index("ZZ_ORPHAN")
                check(bool((res.U.reshape(-1, 6)[orphan] == 0.0).all()),
                      "singular: the orphan node's DOFs are exactly 0")
            else:
                F = res.F_applied.reshape(-1, 6)[:, :3].sum(dim=0)
                eq = float((res.total_reaction[:3] + F).abs().max()
                           / F.abs().max())
                check(eq <= EQ_TOL_F64, f"{name} {solver}: equilibrium "
                      f"{eq:.2e} <= {EQ_TOL_F64:g}")
        D = model.sections.D_outer[model.sect_id] / 1000.0
        scan = pt.phase_scan(wave, model.coords, model.conn, D,
                             p["wave_dir"], p["current_dir"], p["Cd"],
                             p["Cm"], p["rho_water"],
                             n_steps=len(scan_ref["t"]))
        err = max(allclose_err(getattr(scan, f), scan_ref[f])
                  for f in ("total_kN", "drag_kN", "inertia_kN"))
        crit_t = float(scan.t[int(scan.critical_index)])
        check(err <= GOLDEN_TOL and abs(crit_t - scan_ref["critical_t"])
              <= 1e-12, f"golden {name}: {len(scan_ref['t'])}-step phase "
              f"scan totals {err:.2e}, critical t = {crit_t:.4f} s")
    print("[reference] worst field per golden and solver: "
          + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()), flush=True)
    model, wave, case = setups["default"]
    return cuda_ms(lambda: pt.analyze(model, wave, case, solver="chol"))


def dense_phase(pt, hk, dev, coarse64, refined64, wave64, sep_scan):
    """9,612 DOF in f64: dense ``analyze`` (Cholesky against LU, both
    against ``analyze_condensed``), ``analyze_phase_batch`` against the
    pointwise condensed scan, and the 360-phase pointwise scan against the
    separable scan ``sep_scan``.  Returns times (ms), peaks (MiB) and the
    pointwise scan's sweep and pointwise-kernel launches, read from
    counters reset to 0 before it."""
    import torch
    case_t = pt.LoadCase(**CASE, t_analysis=0.34)
    out = {}
    out["dense_peak_mib"] = peak_mib(lambda: pt.analyze(
        refined64, wave64, case_t, solver="chol"))
    chol = pt.analyze(refined64, wave64, case_t, solver="chol")
    lu = pt.analyze(refined64, wave64, case_t, solver="lu")
    cond = pt.analyze_condensed(coarse64, refined64, N_SEG, wave64, case_t,
                                accel="fd")
    for label, other in (("lu", lu), ("analyze_condensed", cond)):
        errs = {f: rel(getattr(chol, f), getattr(other, f))
                for f in ("U", "reactions", "utilization")}
        check(max(errs.values()) <= DENSE_TOL, f"dense Cholesky vs {label} "
              f"at {refined64.n_dof} DOF: " + ", ".join(
                  f"{k} {v:.2e}" for k, v in errs.items())
              + f" <= {DENSE_TOL:g}")
    ts, batch = pt.analyze_phase_batch(refined64, wave64, case_t, n_steps=36)
    pw36 = pt.phase_scan_condensed(coarse64, refined64, N_SEG, wave64,
                                   case_t, n_steps=36, kinematics="pointwise")
    errs = {f: rel(getattr(pw36, f), getattr(batch, f))
            for f in ("U", "utilization", "reactions")}
    errs["total_morison"] = rel(pw36.total_morison,
                                batch.morison.total_morison)
    check(max(errs.values()) <= DENSE_TOL, "analyze_phase_batch vs "
          "pointwise condensed scan, 36 phases, accel analytic: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {DENSE_TOL:g}")

    def pointwise():
        return pt.phase_scan_condensed(
            coarse64, refined64, N_SEG, wave64, pt.LoadCase(**CASE),
            n_steps=N_STEPS, kinematics="pointwise", accel="analytic")
    hk.launch_counts(reset=True)
    pw = pointwise()
    torch.cuda.synchronize()
    n = hk.launch_counts()
    out["pointwise_launches"] = n["sweep"]
    out["pointwise_kernel_launches"] = n["pointwise"]
    check(out["pointwise_launches"] >= 1, f"pointwise scan launched the "
          f"chain sweep ({out['pointwise_launches']}x)")
    check(n["pointwise"] == 1 and n["k1"] == 0, f"pointwise f64 scan: "
          f"{n['pointwise']} pointwise launch, {n['k1']} K1 launches")
    errs = {f: rel(getattr(pw, f), getattr(sep_scan, f))
            for f in ("U", "total_morison")}
    check(max(errs.values()) <= POINTWISE_TOL, f"pointwise vs separable f64 "
          f"scan, {N_STEPS} phases: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {POINTWISE_TOL:g} (the 1 cm clamp band)")
    out["pointwise_peak_mib"] = peak_mib(pointwise)
    out["dense_chol_ms"] = cuda_ms(lambda: pt.analyze(
        refined64, wave64, case_t, solver="chol"), n=5, warmup=1)
    out["dense_lu_ms"] = cuda_ms(lambda: pt.analyze(
        refined64, wave64, case_t, solver="lu"), n=5, warmup=1)
    out["phase_batch_ms"] = cuda_ms(lambda: pt.analyze_phase_batch(
        refined64, wave64, case_t, n_steps=36), n=5, warmup=1)
    out["pointwise_ms"] = cuda_ms(pointwise, n=5, warmup=1)
    for label, fn in (("dense Cholesky analyze", lambda: pt.analyze(
            refined64, wave64, case_t, solver="chol")),
            ("pointwise 360-phase scan", pointwise)):
        events = device_events(fn)
        print(f"[profile] {label} at {refined64.n_dof} DOF: {len(events)} "
              f"device operations, device busy "
              f"{sum(t for _, t in events) / 1e3:.3f} ms; most time: "
              f"{top_device_ops(events)} (torch.profiler)", flush=True)
    print(f"[dense] {refined64.n_dof} DOF f64: max utilization "
          f"{float(chol.utilization.max()):.6f}; peak device memory: dense "
          f"analyze {out['dense_peak_mib']:.0f} MiB, pointwise 360-phase scan "
          f"{out['pointwise_peak_mib']:.0f} MiB", flush=True)
    return out


def large_phase(pt, hk, dev, coarse64, wave64):
    """``analyze_condensed`` at n_seg = 327 (99,882 DOF, f64) with the checks
    of ``tests/test_large.py``, ``analyze_prepared`` against it, the sweep
    kernel against its plain version on this analysis's own operands, the
    launch counts around exactly one call of each path, times and the
    device profile."""
    import torch
    from small_fem_solver_tpu_torch.ops import condense as condense_mod
    from small_fem_solver_tpu_torch.ops.beams import element_stiffness
    from small_fem_solver_tpu_torch.ops.condense import (chain_matvec,
                                                         chain_sweep_plain)
    n_seg = N_SEG_LARGE
    t0 = time.perf_counter()
    refined = pt.refine_model(coarse64, n_seg)
    check(refined.n_dof == 99882, f"large model has {refined.n_dof} DOF")
    case = pt.LoadCase(**CASE, t_analysis=0.34)
    out = {}
    hk.chain_sweep_cuda.launches = hk.chain_sweep_cuda.narrow_launches = 0
    res = pt.analyze_condensed(coarse64, refined, n_seg, wave64, case)
    torch.cuda.synchronize()
    out["analyze_condensed_launches"] = hk.chain_sweep_cuda.launches
    out["analyze_condensed_narrow"] = hk.chain_sweep_cuda.narrow_launches
    print(f"[large] refine + first analyze_condensed: "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    check(out["analyze_condensed_launches"] >= 1, f"analyze_condensed "
          f"launched the chain sweep ({out['analyze_condensed_launches']}x)")
    U, F = res.U, res.F_applied
    check(bool(torch.isfinite(U).all()) and U.shape == (99882,),
          "large displacements finite, 99,882 of them")

    nc, Mc = coarse64.n_nodes, coarse64.n_members
    E, G = 210000.0, 210000.0 / 2.6
    Kg = element_stiffness(refined.coords, refined.conn, refined.sections,
                           refined.sect_id, E, G)[0]
    U_In = U[None, :6 * nc].reshape(1, nc, 6)
    v = U[None, 6 * nc:].reshape(1, Mc, n_seg - 1, 6).transpose(1, 2)
    y_I, y_int = chain_matvec(Kg, n_seg, coarse64.conn, U_In, v)
    KU = torch.cat([y_I.reshape(-1), y_int.transpose(1, 2).reshape(-1)])
    free = torch.logical_not(refined.fixed_mask).repeat_interleave(6)
    resid = float((F - KU)[free].abs().max() / F.abs().max())
    check(resid <= RESID_TOL, f"refined residual via chain_matvec "
          f"{resid:.2e} <= {RESID_TOL:g}")
    eq = float((res.total_reaction[:3] + F.reshape(-1, 6)[:, :3].sum(0))
               .abs().max() / F.abs().max())
    check(eq <= EQ_TOL_LARGE, f"large equilibrium {eq:.2e} <= "
          f"{EQ_TOL_LARGE:g}")
    case_sw = pt.LoadCase(**{**CASE, "sw_mode": "calculated"},
                          t_analysis=0.34)
    U_l = pt.analyze_condensed(coarse64, refined, n_seg, wave64,
                               case_sw).U[:6 * nc]
    U_8 = pt.analyze_condensed(coarse64, pt.refine_model(coarse64, 8), 8,
                               wave64, case_sw).U[:6 * nc]
    iface = rel(U_l, U_8)
    check(iface < INTERFACE_TOL, f"interface U vs n_seg = 8 ('calculated' "
          f"self-weight) {iface:.2e} < {INTERFACE_TOL:g}")
    coarse_res = pt.analyze(coarse64, wave64, case, solver="chol",
                            accel="analytic")
    mor = rel(res.morison.total_morison, coarse_res.morison.total_morison)
    check(mor < MORISON_TOTAL_TOL, f"total Morison vs the coarse analyze "
          f"{mor:.2e} < {MORISON_TOTAL_TOL:g}")
    umax = float(res.utilization.max())
    check(0.15 < umax < 0.35, f"max utilization {umax:.6f} in (0.15, 0.35)")

    prep = pt.prepare_condensed(coarse64, refined, n_seg)
    check(prep.chain_solver == "nested" and tuple(
        prep.fac.fac1.Cprime.shape[:2]) == (108, 153) and tuple(
        prep.fac.fac2.Cprime.shape[:2]) == (2, 51),
        "nested split 327 = 3 x 109: level 1 108 x 153, level 2 2 x 51")
    hk.chain_sweep_cuda.launches = hk.chain_sweep_cuda.narrow_launches = 0
    rp = pt.analyze_prepared(prep, wave64, case)
    torch.cuda.synchronize()
    out["analyze_prepared_launches"] = hk.chain_sweep_cuda.launches
    out["analyze_prepared_narrow"] = hk.chain_sweep_cuda.narrow_launches
    check(out["analyze_prepared_launches"] == 4
          and out["analyze_prepared_narrow"] == 4, f"analyze_prepared "
          f"launched the chain sweep {out['analyze_prepared_launches']}x, "
          f"{out['analyze_prepared_narrow']}x in its narrow form (4, 4: two "
          "solves x two levels, each at B = 1)")
    errs = {f: rel(getattr(rp, f), getattr(res, f))
            for f in ("U", "reactions", "von_mises")}
    f2 = rel(rp.F2_local, res.F2_local)
    check(max(errs.values()) <= PREP_ANALYZE_TOL and f2 <= PREP_F2_TOL,
          "analyze_prepared vs analyze_condensed: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {PREP_ANALYZE_TOL:g}, F2 {f2:.2e} <= {PREP_F2_TOL:g}")

    # the sweep kernel on the operands of one analyze_prepared call: the
    # solve and the refinement round, each nested level 1 then level 2
    sweeps = record_sweeps(condense_mod, hk,
                           lambda: pt.analyze_prepared(prep, wave64, case))
    check(len(sweeps) == 4 and all(
        hk.sweep_narrow_rhs(hk.sweep_operand(gs, split)[1],
                            fac.Cprime.shape[0], 8) == 1
        for fac, gs, split in sweeps),
          "analyze_prepared ran four sweeps (two solves x two levels), "
          "each at B = 1: the narrow form (level 1: 108 levels x 153 chains, "
          "f64)")
    out["sweeps"] = sweeps
    # the path finds the 16 MB of level-1 factors cold in the 50 MB L2
    # cache: time each launch after overwriting a 128 MB buffer, and warm
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    levels = {}
    for i, (fac, gs, split) in enumerate(sweeps):
        level = f"level {i % 2 + 1}"
        g_chain = gs.reshape(*gs.shape[:-3], -1, 6) if split else gs
        ref = chain_sweep_plain(fac, g_chain)
        got = hk.chain_sweep_cuda(fac, gs, split)
        err = max(rel(a, b) for a, b in zip(got, ref))
        check(err <= SWEEP_TOL_F64, f"sweep kernel f64 vs plain, 99,882 DOF "
              f"{level} ({'solve' if i < 2 else 'refinement round'}): "
              f"{err:.2e} <= {SWEEP_TOL_F64:g}")
        check(narrow_equals_wide(hk, fac, gs, split, got, 40),
              f"99,882 DOF {level} ({'solve' if i < 2 else 'refinement'}): "
              "the narrow launch bit-equal to column 0 of a wide launch of "
              "40 columns")
        if i >= 2:   # the refinement round repeats the solve's shapes
            continue
        (n_int, C), B = fac.Cprime.shape[:2], g_chain.shape[0]
        cold = kernel_us(device_events(lambda: (
            l2_flush.zero_(), hk.chain_sweep_cuda(fac, gs, split)),
            SHORT_REPS), SWEEP_KERNEL)
        warm = kernel_us(device_events(
            lambda: hk.chain_sweep_cuda(fac, gs, split), SHORT_REPS),
            SWEEP_KERNEL)
        levels[level] = (
            cuda_ms(lambda: hk.chain_sweep_cuda(fac, gs, split)),
            cuda_ms(lambda: chain_sweep_plain(fac, g_chain), n=5),
            cold, *sweep_bound(8, B, n_int, C), err, (B, n_int, C), warm)
    del l2_flush
    out["levels"] = levels

    out["peak_mib"] = peak_mib(lambda: pt.analyze_condensed(
        coarse64, refined, n_seg, wave64, case))
    out["analyze_condensed_ms"] = cuda_ms(lambda: pt.analyze_condensed(
        coarse64, refined, n_seg, wave64, case), n=5, warmup=1)
    out["analyze_prepared_ms"] = cuda_ms(lambda: pt.analyze_prepared(
        prep, wave64, case), n=10, warmup=2)
    out["prepare_ms"] = cuda_ms(lambda: pt.prepare_condensed(
        coarse64, refined, n_seg), n=5, warmup=1)
    events = device_events(lambda: pt.analyze_prepared(prep, wave64, case))
    out["prepared_ops"] = len(events)
    out["prepared_busy_ms"] = sum(t for _, t in events) / 1e3
    out["prepared_sweeps"] = sum(SWEEP_KERNEL in n for n, _ in events)
    out["prepared_top"] = top_device_ops(events)
    print(f"[large] {refined.n_dof} DOF f64: residual {resid:.2e}, "
          f"equilibrium {eq:.2e}, interface vs n_seg 8 {iface:.2e}, Morison "
          f"total vs coarse {mor:.2e}, max utilization {umax:.6f}; peak "
          f"device memory of analyze_condensed {out['peak_mib']:.0f} MiB",
          flush=True)
    out.update(refined=refined, case=case, wave=wave64, condensed=res)
    return out


# ---- Queue C: K1's limits bind on the card only ----

def queue_c_phase(pt, hk, dev):
    """Calls past K1's limits, which the JAX package's separable engine
    runs: a 40-mode Airy ``design_envelope`` (126 DOF, f64, 3 cases x 8
    phases) and a ``dynamic_response`` at ``n_gauss`` = 20.  On the card
    each picks the plain version from its shapes: no K1 launch, one plain
    route; each against the port's CPU run of the same call."""
    import torch
    coarse = pt.default_3leg_jacket(device=dev)
    coarse_cpu = pt.default_3leg_jacket(device="cpu")
    case = pt.LoadCase(**CASE)
    out = {}

    def envelope(model, device):
        waves = pt.make_wave_batch([4.0, 9.0, 14.0], [8.0, 9.4, 11.0], 50.0,
                                   U_c=1.7, model="airy", n_modes=40,
                                   dtype=torch.float64, device=device)
        cases = pt.make_case_batch(case, wave_dir_deg=[0.0, 38.0, 120.0])
        return pt.design_envelope(model, waves, cases, n_steps=8)

    def dynamic(model, device):
        wave = pt.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5,
                            device=device)
        return pt.dynamic_response(model, wave, case, n_harmonics=4,
                                   n_steps=24, n_gauss=20)

    for label, fn, fields, tol in (
            ("design_envelope, 40 Airy modes", envelope,
             ("utilization", "max_util_per_case", "total_morison"),
             QUEUE_C_ENV_TOL),
            ("dynamic_response, n_gauss 20", dynamic,
             ("U_time", "utilization", "daf"), QUEUE_C_DYN_TOL)):
        k1 = hk.morison_phase_batch_cuda
        k1.launches, k1.plain_routes = 0, 0
        card = fn(coarse, dev)
        torch.cuda.synchronize()
        n, routes = k1.launches, k1.plain_routes
        cpu = fn(coarse_cpu, "cpu")
        errs = {f: rel(getattr(card, f).cpu(), getattr(cpu, f))
                for f in fields}
        check(n == 0 and routes == 1, f"{label} on the card: {n} K1 "
              f"launches (0), {routes} plain route (1)")
        check(max(errs.values()) <= tol, f"{label}: card vs CPU "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" <= {tol:g}")
        out[label] = {"launches": n, "plain_routes": routes, "errs": errs}
    return out


# ---- the sparse and iterative tier: PCG and BCSR assembly ----

def pcg_iteration_bytes(A, n_dof: int, n_agg: int | None, slots: int):
    """Bytes one CG iteration must move, each input read once and each
    output written once: the BCSR blocks and one column and one row index
    a block (the mat-vec), the block-Jacobi inverse, with the two-level
    preconditioner the prolongator's real blocks and their columns, the
    explicit coarse inverse and its scaling, and the vectors (x, r, p and
    the free-DOF mask read; x, r, p written)."""
    nb, n = A.pattern.n_blocks, A.pattern.n_nodes
    it = A.blocks.element_size()
    nbytes = nb * (36 * it + 16) + n * 36 * it + 7 * n_dof * it
    if n_agg is not None:
        nbytes += slots * (36 * it + 8) + ((6 * n_agg) ** 2 + 6 * n_agg) * it
    return nbytes


def matvec_bound(A, n_dof: int):
    """(bound us, by, bytes) of one ``bcsr_matvec``: blocks and their two
    indices read once, x read and y written once; 72 FLOPs a block (a 6x6
    block times a 6-vector)."""
    nb, it = A.pattern.n_blocks, A.blocks.element_size()
    nbytes = nb * (36 * it + 16) + 2 * n_dof * it
    return (*bound_us(nbytes, 72 * nb, FP64_FLOP_PER_S if it == 8
                      else FP32_FLOP_PER_S), nbytes)


def pcg_profile(pt, model, F, precond: str, iters: int):
    """Device operations, busy time (us) and most time of ``iters`` CG
    iterations of ``analyze(solver='pcg')``'s operators on ``model`` and
    the load vector ``F`` (torch.profiler, the solve's own operator and
    preconditioner; tol 0, so exactly ``iters`` iterations run), the
    matvec's device time, and the iteration's and the matvec's bounds."""
    import numpy as np
    import torch
    from small_fem_solver_tpu_torch import api
    from small_fem_solver_tpu_torch.ops import solve as solve_mod
    from small_fem_solver_tpu_torch.ops.assembly import (assemble_bcsr,
                                                         bcsr_matvec)
    from small_fem_solver_tpu_torch.ops.beams import element_stiffness
    E, G = 210000.0, 210000.0 / 2.6
    Kg = element_stiffness(model.coords, model.conn, model.sections,
                           model.sect_id, E, G)[0]
    A = assemble_bcsr(Kg, api._cached_bcsr_pattern(model.conn,
                                                   model.n_nodes))
    fmask, op, pre = api._pcg_operators(A, model, precond)
    b = fmask * F
    state = solve_mod.pcg_init(op, b, pre)
    bnorm = solve_mod.pcg_bnorm(b)
    events = device_events(lambda: solve_mod.pcg_run(
        op, pre, state, bnorm, 0.0, iters, iters), host=False)
    busy = sum(t for _, t in events)
    n_agg, slots = None, 0
    if precond == "two_level":
        _, n_agg, plan = api._cached_aggregates(A.pattern)
        slots = int(plan.valid.sum())
    it_bytes = pcg_iteration_bytes(A, model.n_dof, n_agg, slots)
    x = torch.tensor(np.random.default_rng(0).standard_normal(F.shape),
                     dtype=F.dtype, device=F.device)
    mv = device_events(lambda: bcsr_matvec(A, x), SHORT_REPS, host=False)
    mv_bound, mv_by, mv_bytes = matvec_bound(A, model.n_dof)
    return {"ops_per_iter": len(events) / iters,
            "busy_us_per_iter": busy / iters,
            "top": top_device_ops(events),
            "iter_bytes": it_bytes,
            "iter_bound_us": bound_us(it_bytes, 0.0, FP64_FLOP_PER_S)[0],
            "matvec_us": sum(t for _, t in mv) / SHORT_REPS,
            "matvec_ops": len(mv) / SHORT_REPS,
            "matvec_bound_us": mv_bound, "matvec_by": mv_by,
            "matvec_bytes": mv_bytes, "n_blocks": A.pattern.n_blocks,
            "n_agg": n_agg}


def timed_call(fn):
    """(result, host-clock s, CUDA-event ms) of one synchronised call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, start.elapsed_time(end)


def pcg_phase(pt, dev, coarse64, refined64):
    """``analyze(solver="pcg")`` on the 9,612-DOF flagship mesh in f64 with
    the storm and ``accel="analytic"`` of ``tests/test_pcg_precond.py``:
    block-Jacobi and two-level at tol 1e-10 against the Cholesky solve on
    the card (U rtol 1e-8 / atol 1e-9 x max |U|, utilization rtol 1e-7),
    two-level >= 3x fewer iterations, iteration counts within 1% of the
    port's CPU run of the same call, ``pcg_chunk`` 50 bit-equal to 0, a
    second run bit-equal to the first; times and the per-iteration
    profile."""
    import torch
    wave = pt.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5,
                        device=dev)
    case = pt.LoadCase(**CASE)
    cpu_r = pt.refine_model(pt.default_3leg_jacket(device="cpu"), N_SEG)
    wave_cpu = wave.to(torch.float64, "cpu")

    def solve(model, w, precond, **kw):
        return pt.analyze(model, w, case, solver="pcg", accel="analytic",
                          pcg_precond=precond, pcg_maxiter=20000, **kw)
    chol = pt.analyze(refined64, wave, case, solver="chol",
                      accel="analytic")
    scale = float(chol.U.abs().max())
    out = {"iters": {}, "cpu_iters": {}, "ms": {}, "wall_s": {}}
    for precond in ("block_jacobi", "two_level"):
        res, wall, ms = timed_call(lambda: solve(refined64, wave, precond))
        out["wall_s"][precond], out["ms"][precond] = wall, ms
        it = int(res.solver_iters)
        out["iters"][precond] = it
        u_err = float(((res.U - chol.U).abs()
                       / (1e-8 * chol.U.abs() + 1e-9 * scale)).max())
        util_err = float(((res.utilization - chol.utilization).abs()
                          / chol.utilization.abs()).max())
        check(float(res.solver_residual) <= PCG_TOL and u_err <= 1.0
              and util_err <= PCG_UTIL_RTOL,
              f"PCG {precond} at {refined64.n_dof} DOF: {it} iterations, "
              f"residual {float(res.solver_residual):.2e} <= {PCG_TOL:g}; "
              f"vs Cholesky U within rtol 1e-8 / atol 1e-9 x max|U| "
              f"(worst {u_err:.2f} of the limit), utilization rtol "
              f"{util_err:.2e} <= {PCG_UTIL_RTOL:g}")
        again = solve(refined64, wave, precond)
        chunked = solve(refined64, wave, precond, pcg_chunk=50)
        check(int(again.solver_iters) == it and torch.equal(again.U, res.U)
              and int(chunked.solver_iters) == it
              and torch.equal(chunked.U, res.U)
              and torch.equal(chunked.solver_residual, res.solver_residual),
              f"PCG {precond} on the card bit-repeatable (a second run) and "
              "pcg_chunk=50 bit-equal to pcg_chunk=0")
        t0 = time.perf_counter()
        cpu = solve(cpu_r, wave_cpu, precond)
        cpu_it = int(cpu.solver_iters)
        out["cpu_iters"][precond] = cpu_it
        check(abs(it - cpu_it) <= 0.01 * cpu_it, f"PCG {precond} card "
              f"{it} vs CPU {cpu_it} iterations (within 1%; CPU run "
              f"{time.perf_counter() - t0:.2f} s); U card vs CPU "
              f"{rel(res.U.cpu(), cpu.U):.2e}")
    bj, tl = out["iters"]["block_jacobi"], out["iters"]["two_level"]
    check(3 * tl <= bj, f"two-level {tl} x 3 <= block-Jacobi {bj} "
          "iterations")
    out["peak_mib"] = peak_over_mib(lambda: solve(refined64, wave,
                                                 "two_level"))
    out["profile"] = pcg_profile(pt, refined64, chol.F_applied, "two_level",
                                 PCG_PROFILE_ITERS)
    print(f"[pcg] {refined64.n_dof} DOF f64 tol {PCG_TOL:g}: iterations "
          f"block-Jacobi {bj} (CPU {out['cpu_iters']['block_jacobi']}; "
          f"JAX recorded 4,275), two-level {tl} (CPU "
          f"{out['cpu_iters']['two_level']}; JAX recorded 621) -- "
          "arithmetic counts, not speeds", flush=True)
    return out


def true_residual(model, U, F) -> float:
    """||P(K U - F)|| / ||P F|| recomputed member by member on the host in
    extended precision (numpy longdouble): each K_e u_e summed onto its
    nodes with np.add.at, no BCSR operator and no CG recurrence."""
    import numpy as np
    from small_fem_solver_tpu_torch.ops.beams import element_stiffness
    E, G = 210000.0, 210000.0 / 2.6
    ld = np.longdouble
    Kg = element_stiffness(model.coords, model.conn, model.sections,
                           model.sect_id, E, G)[0].cpu().numpy().astype(ld)
    conn = model.conn.cpu().numpy()
    dofs = (6 * conn[:, :, None] + np.arange(6)).reshape(-1, 12)
    U = U.cpu().numpy().astype(ld)
    KU = np.zeros(model.n_dof, ld)
    np.add.at(KU, dofs, np.einsum("mij,mj->mi", Kg, U[dofs]))
    free = ~np.repeat(model.fixed_mask.cpu().numpy(), 6)
    F = F.cpu().numpy().astype(ld)
    d, f = (KU - F)[free], F[free]
    return float(np.sqrt((d * d).sum() / (f * f).sum()))


def pcg_large_phase(pt, dev, large):
    """``analyze(solver="pcg")`` at 99,882 DOF, two-level, chunks of 200,
    f64, against phase 9's ``analyze_condensed``:

    - the bench's call (``bench.py:602-606``: tol 1e-8, maxiter 3,000,
      ``analyze``'s default ``accel="fd"``): utilization within 0.1 of the
      condensed solve (which runs ``accel="analytic"``; JAX measured
      4.96e-2 between the same two calls);
    - the same with ``accel="analytic"``, the condensed solve's loads, at
      tol 1e-8 and at tol 1e-10: utilization within the limits set in
      PERF.md before the run;
    - each: ||P(K U - F)|| / ||P F|| recomputed independently
      (:func:`true_residual`) within ``PCG_TRUE_RESID_LIMIT``, a second
      run bit-equal; times, the per-iteration profile, peak memory."""
    import torch
    refined, case, wave, cond = (large["refined"], large["case"],
                                 large["wave"], large["condensed"])
    out = {"runs": {}}
    for label, accel, tol, maxiter, limit in (
            ("bench (accel fd)", "fd", 1e-8, 3000, PCG_LARGE_UTIL_TOL),
            ("accel analytic", "analytic", 1e-8, 3000,
             PCG_LARGE_UTIL_TOL_MATCHED),
            ("accel analytic", "analytic", 1e-10, 6000,
             PCG_LARGE_UTIL_TOL_1E10)):
        def solve():
            return pt.analyze(refined, wave, case, solver="pcg",
                              accel=accel, pcg_precond="two_level",
                              pcg_tol=tol, pcg_maxiter=maxiter,
                              pcg_chunk=200)
        res, wall, ms = timed_call(solve)
        it = int(res.solver_iters)
        resid = true_residual(refined, res.U, res.F_applied)
        util = rel(res.utilization, cond.utilization)
        u_rel = rel(res.U, cond.U)
        tag = f"PCG at {refined.n_dof} DOF, {label}, tol {tol:g}"
        check(float(res.solver_residual) <= tol
              and resid <= PCG_TRUE_RESID_LIMIT,
              f"{tag}: {it} iterations, solver's residual "
              f"{float(res.solver_residual):.3e} <= {tol:g}; ||P(KU - F)|| "
              f"/ ||P F|| recomputed on the host {resid:.3e} <= "
              f"{PCG_TRUE_RESID_LIMIT:g}")
        check(util <= limit, f"{tag}: utilization vs analyze_condensed "
              f"{util:.3e} <= {limit:g} (U {u_rel:.3e})")
        again, wall2, ms2 = timed_call(solve)
        check(int(again.solver_iters) == it and torch.equal(again.U, res.U),
              f"{tag}: a second run bit-equal")
        out["runs"][(label, tol)] = {
            "iters": it, "resid": resid,
            "solver_resid": float(res.solver_residual), "util": util,
            "U": u_rel, "wall_s": (wall, wall2), "ms": (ms, ms2)}
        print(f"[pcg large] {label}, tol {tol:g}: {it} iterations (JAX "
              f"recorded 1,354 for the bench's call, through its band "
              f"operators), utilization vs condensed {util:.3e}, U "
              f"{u_rel:.3e}, true residual {resid:.3e}; wall {wall:.3f} / "
              f"{wall2:.3f} s, CUDA events {ms:.1f} / {ms2:.1f} ms",
              flush=True)
    out["peak_mib"] = peak_over_mib(lambda: pt.analyze(
        refined, wave, case, solver="pcg", pcg_precond="two_level",
        pcg_tol=1e-8, pcg_maxiter=3000, pcg_chunk=200))
    out["profile"] = pcg_profile(pt, refined, cond.F_applied, "two_level",
                                 PCG_PROFILE_ITERS)
    return out


def assembly_phase(pt, large):
    """Direct-write BCSR assembly at 99,882 DOF (``bench.py:433-560``), f32
    (the bench's dtype) and f64: against the generic ``assemble_bcsr`` of
    ``element_global_stiffness`` (5e-6 / 1e-12 of the largest block
    entry), bit-repeatable; GDOF/s of single synchronised calls and
    sustained over 64 back-to-back assemblies at geometry scales
    linspace(1, 1.01, 64) (CUDA events); device time against the bytes
    bound."""
    import torch
    from small_fem_solver_tpu_torch import api
    from small_fem_solver_tpu_torch.ops import assembly as asm
    from small_fem_solver_tpu_torch.ops.beams import element_global_stiffness
    out = {}
    for dtype, tol in ((torch.float32, ASM_TOL_F32),
                       (torch.float64, ASM_TOL_F64)):
        m = large["refined"] if dtype == torch.float64 else pt.refine_model(
            pt.default_3leg_jacket(dtype=dtype,
                                   device=large["refined"].coords.device),
            N_SEG_LARGE)
        E, G = 210000.0, 210000.0 / 2.6
        prep = asm.prepare_direct_assembly(m.coords, m.conn, m.sect_id,
                                           m.n_nodes)
        direct = asm.assemble_bcsr_direct(prep, m.sections, E, G)
        generic = asm.assemble_bcsr(
            element_global_stiffness(m.coords, m.conn, m.sections,
                                     m.sect_id, E, G),
            api._cached_bcsr_pattern(m.conn, m.n_nodes))
        # the direct [diag | ij | ji] order against the generic sorted one
        n = m.n_nodes
        key = direct.pattern.block_rows * n + direct.pattern.block_cols
        gkey = generic.pattern.block_rows * n + generic.pattern.block_cols
        order = torch.argsort(key)
        check(torch.equal(key[order], gkey), "direct-write pattern holds "
              "the generic pattern's blocks")
        err = rel(direct.blocks[order], generic.blocks)
        again = asm.assemble_bcsr_direct(prep, m.sections, E, G)
        check(err <= tol and torch.equal(again.blocks, direct.blocks),
              f"direct-write assembly {dtype} at {m.n_dof} DOF vs generic "
              f"assemble_bcsr: {err:.2e} <= {tol:g}; bit-repeatable")
        single = cuda_ms(lambda: asm.assemble_bcsr_direct(prep, m.sections,
                                                          E, G))
        scales = torch.linspace(1.0, 1.01, 64, dtype=dtype,
                                device=m.coords.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(2):          # the second round is timed
            torch.cuda.synchronize()
            start.record()
            for k in range(64):
                asm.assemble_bcsr_direct(prep, m.sections, E, G,
                                         scale=scales[k])
            end.record()
            torch.cuda.synchronize()
        sustained = start.elapsed_time(end) / 64
        events = device_events(lambda: asm.assemble_bcsr_direct(
            prep, m.sections, E, G), SHORT_REPS, host=False)
        dev_us = sum(t for _, t in events) / SHORT_REPS
        nb, it = prep.pattern.n_blocks, direct.blocks.element_size()
        lanes = prep.sect.shape[0]
        # inputs read once: two end coordinates, a section id and a
        # quadrant code a lane, the diagonal's padding mask; the blocks
        # written once; ~360 FLOPs a lane (its quadrant's closed form: ~12
        # nonzero pattern entries x 9 rotation products x 3, plus the
        # coefficients)
        nbytes = lanes * (6 * it + 16) + prep.diag_mask.numel() * it \
            + nb * 36 * it
        bound, by = bound_us(nbytes, 360.0 * lanes, FP32_FLOP_PER_S
                             if it == 4 else FP64_FLOP_PER_S)
        out[str(dtype).split(".")[-1]] = {
            "err": err, "single_ms": single, "sustained_ms": sustained,
            "gdofs_single": m.n_dof / single / 1e6,
            "gdofs_sustained": m.n_dof / sustained / 1e6,
            "device_us": dev_us, "ops": len(events) / SHORT_REPS,
            "bound_us": bound, "bound_by": by, "bytes": nbytes,
            "top": top_device_ops(events)}
    return out


def options_jacket(pt, dev):
    """The default jacket (f64) with pinned h-braces and two conductors."""
    nodes, members, fixed, top = \
        pt.models.presets.default_3leg_jacket_geometry()
    members = [{**m, "release": "pinned" if m["type"] == "h_brace"
                else "none"} for m in members]
    return pt.add_appurtenances(pt.build_model(nodes, members, fixed, top,
                                               device=dev), APPS)


def options_phase(pt, hk, dev, wave64):
    """The 9,612-DOF f64 options scan (releases, appurtenances, buoyancy,
    wind, foundation springs) with ``kinematics="fused"``: launch counts
    around exactly that call, the separable f64 scan at the flagship
    limits, equilibrium, spring reactions and stiff springs vs clamped."""
    import torch
    from small_fem_solver_tpu_torch import api
    f64 = torch.float64
    coarse = options_jacket(pt, dev)
    refined = pt.refine_model(coarse, N_SEG)
    n_pinned = sum(m == "h_brace" for m in coarse.member_types)
    check(refined.n_dof == 9612 and refined.n_appurtenances == 2
          and int((refined.release > 0).sum()) == 2 * n_pinned,
          f"options model: {refined.n_dof} DOF, {n_pinned} pinned h-braces "
          f"(released end segments), {refined.n_appurtenances} conductors")
    case = pt.LoadCase(**CASE, **OPTIONS_CASE)
    S, out = N_STEPS, {}

    def scan(kinematics="fused", springs=SPRINGS):
        return pt.phase_scan_condensed(
            coarse, refined, N_SEG, wave64, case, n_steps=S,
            kinematics=kinematics, solve_dtype=f64, support_stiffness=springs)
    fused, n, _ = counted(hk, scan)
    out["k1_launches"] = n["f64"]
    out["sweep_launches"] = n["sweep"]
    check(same_counts(n, {"f64": 1, "sweep": 4}),
          f"options scan launched {n}: K1's f64 instance once (M + A = "
          f"{refined.n_members + 2} members, per-member Cd/Cm; the f64 "
          f"model's loads in f64), the f32 instance never, the chain sweep "
          f"4 times (two solves x two levels)")
    sep = scan("separable")
    check(all(torch.isfinite(t).all() for t in fused[1:6]),
          "options scan results finite")
    u, u64 = fused.utilization, sep.utilization
    errs = {"utilization": float((u - u64).abs().max() / u64.max()),
            "max utilization": float((u.max() - u64.max()).abs() / u64.max()),
            "U": rel(fused.U, sep.U)}
    out["errs"] = errs
    check(max(errs.values()) <= F64_LOADS_TOL, "options scan, fused (K1 "
          "f64 loads) vs separable f64: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {F64_LOADS_TOL:g}")

    # equilibrium: the separable scan against independently summed loads
    # (the steady ones through the dense path's assembly, with no wave),
    # the fused scan against the chain-layout loads its solve was given
    c64 = case.cast(f64, dev)
    L_m = torch.linalg.norm(refined.coords[refined.conn[:, 1]]
                            - refined.coords[refined.conn[:, 0]], dim=-1)
    steady = api.assemble_loads(
        refined, c64, torch.zeros(refined.n_nodes, 3, dtype=f64, device=dev),
        L_m).reshape(-1, 6)[:, :3].sum(dim=0)
    prep = pt.prepare_condensed(coarse, refined, N_SEG,
                                support_stiffness=SPRINGS)
    _, F_I, g, _ = api._scan_loads(prep, wave64, c64, S, 15, "fused", "none",
                                   None)
    given = F_I[..., :3].sum(dim=1) + g[..., :3].sum(dim=(1, 2))

    def equilibrium(s, applied):
        R = s.reactions.sum(dim=1)[:, :3]
        return float((R + applied).abs().max() / applied.abs().max())
    eqs = {"separable": equilibrium(sep, steady + sep.total_morison),
           "fused": equilibrium(fused, given)}
    check(max(eqs.values()) <= EQ_TOL_F64, "options scan equilibrium: "
          + ", ".join(f"{k} {v:.2e}" for k, v in eqs.items())
          + f" <= {EQ_TOL_F64:g}")
    ks = torch.tensor(SPRINGS, dtype=f64, device=dev)
    supports = torch.nonzero(coarse.fixed_mask).flatten()
    spring = {k: rel(s.reactions, -ks * s.U.reshape(S, -1, 6)[:, supports])
              for k, s in (("fused", fused), ("separable", sep))}
    check(max(spring.values()) <= SPRING_TOL, "reactions == -k u_support: "
          + ", ".join(f"{k} {v:.2e}" for k, v in spring.items())
          + f" <= {SPRING_TOL:g}")
    stiff, clamped = scan(springs=STIFF_SPRINGS), scan(springs=None)
    stiff_err = {f: rel(getattr(stiff, f), getattr(clamped, f))
                 for f in ("U", "utilization", "reactions")}
    check(max(stiff_err.values()) <= STIFF_TOL, "stiff springs (1e13 / "
          "1e19) vs the clamped scan: " + ", ".join(
              f"{k} {v:.2e}" for k, v in stiff_err.items())
          + f" <= {STIFF_TOL:g}")
    out["ms"] = cuda_ms(scan, n=10, warmup=2)
    events = device_events(scan)
    out["ops"], out["busy_ms"] = len(events), sum(t for _, t in events) / 1e3
    out["k1_us"] = harm64_us(events)["total"]
    print(f"[options] {refined.n_dof} DOF x {S} phases on springs: max "
          f"utilization {float(u.max()):.6f} (f64 {float(u64.max()):.6f}; "
          f"clamped {float(clamped.utilization.max()):.6f}), max |U| "
          f"{float(fused.U.abs().max()):.2f} mm; fused scan "
          f"{out['ms']:.3f} ms (median of 10, CUDA events), "
          f"{out['ops']} device operations, device busy "
          f"{out['busy_ms']:.3f} ms, K1 f64 {out['k1_us']:.1f} us "
          "(torch.profiler)", flush=True)
    return out


def f64_envelope_phase(pt, hk, dev, coarse64):
    """The condensed envelope of an f64 model (f64 solve) with the default
    kinematics ("fused") against ``kinematics="separable"``: one launch of
    K1's f64 instance a case, none of the f32 one, and the reductions at
    F64_LOADS_TOL.  A few Stokes-5 cases at the CLI envelope's n_seg."""
    import torch
    f64 = torch.float64
    refined = pt.refine_model(coarse64, F64_ENV_SEG)
    waves = pt.make_wave_batch(list(F64_ENV_HS), 9.4, 50.0, U_c=1.7,
                               model="stokes", N=5, n_modes=8, dtype=f64,
                               device=dev)
    C = len(F64_ENV_HS)
    cases = pt.make_case_batch(pt.LoadCase(**CASE),
                               wave_dir_deg=[0.0, 38.0, 120.0][:C])

    def envelope(**kw):
        return pt.design_envelope_condensed(
            coarse64, refined, F64_ENV_SEG, waves, cases,
            n_steps=DESIGN_STEPS, solve_dtype=f64, **kw)
    env, n, s = counted(hk, envelope)
    check(same_counts(n, {"f64": C, "sweep": 2 * C}),
          f"f64 condensed envelope ({C} cases, n_seg {F64_ENV_SEG}) "
          f"launched {n}: K1 f64 once a case, the sweep twice a case")
    ref = envelope(kinematics="separable")
    errs = {f: rel(getattr(env, f), getattr(ref, f))
            for f in ("max_util_per_case", "member_envelope",
                      "max_util_per_phase")}
    check(max(errs.values()) <= F64_LOADS_TOL
          and int(env.governing_case) == int(ref.governing_case),
          "f64 condensed envelope, fused (K1 f64 loads) vs separable: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {F64_LOADS_TOL:g}; governing case "
          f"{int(env.governing_case)} == {int(ref.governing_case)}")
    return {"launches": n, "errs": errs, "s": s}


def design_batch(pt):
    """The 1,000-case design batch on the CPU in f64: Stokes-5 waves of 50
    heights (8 modes; the wave does not depend on the heading), each under
    20 headings of wave and current, at t_analysis = 0."""
    import dataclasses
    import numpy as np
    import torch
    Hs = np.linspace(*DESIGN_HS)
    heads = np.arange(*DESIGN_HEADINGS)
    for h in (Hs[0], Hs[-1]):
        check(not pt.validate_wave(h, 9.4, 50.0), f"validate_wave accepts "
              f"H = {h:g} m, T = 9.4 s, d = 50 m")
    w = pt.make_wave_batch(Hs, 9.4, 50.0, U_c=1.7, model="stokes", N=5,
                           n_modes=8, dtype=torch.float64, device="cpu")
    idx = torch.arange(len(Hs)).repeat_interleave(len(heads))
    waves = dataclasses.replace(w, **{
        f.name: getattr(w, f.name)[idx] for f in dataclasses.fields(w)
        if torch.is_tensor(getattr(w, f.name))})
    dirs = np.tile(heads, len(Hs))
    cases = pt.make_case_batch(pt.LoadCase(**CASE), wave_dir_deg=dirs,
                               current_dir_deg=dirs,
                               t_analysis=np.zeros(len(dirs)))
    return waves, cases, Hs[idx.numpy()], dirs


ENV_FIELDS = ("ts", "utilization", "max_util_per_phase", "max_util_per_case",
              "member_envelope", "total_morison")


def dense_envelope_phase(pt, hk, dev, coarse64, waves_cpu, cases):
    """``design_envelope`` of the 1,000 cases x 36 phases on the default
    jacket in f64: exactly one launch of K1's case-batched f64 instance for
    all the cases, every case against the CPU f64 plain run (1e-10), the
    governing case against ``analyze_phase_batch``; time, device
    operations and peak memory.  Then an f32 copy of the model through the
    same call: one launch of K1's case-batched f32 instance for all the
    cases, its Morison totals at K1's f32 limit, its full utilization at
    the f32 model's limit; its time and its K1 device time."""
    import torch
    waves = waves_cpu.to(torch.float64, dev)
    C, out = waves.E.shape[0], {}

    def envelope():
        return pt.design_envelope(coarse64, waves, cases, n_steps=DESIGN_STEPS)
    env, n, out["first_s"] = counted(hk, envelope)
    out["launches"] = n["f64"]
    check(same_counts(n, {"f64": 1}), f"design_envelope of the f64 model "
          f"launched {n} (K1's case-batched f64 instance once for the {C} "
          "cases)")
    check(tuple(env.utilization.shape) == (C, DESIGN_STEPS,
                                           coarse64.n_members)
          and all(torch.isfinite(getattr(env, f)).all() for f in ENV_FIELDS),
          f"dense envelope: utilization {tuple(env.utilization.shape)}, "
          "all fields finite")
    t0 = time.perf_counter()
    ref = pt.design_envelope(pt.default_3leg_jacket(device="cpu"), waves_cpu,
                             cases, n_steps=DESIGN_STEPS)
    out["cpu_s"] = time.perf_counter() - t0
    errs = {f: rel(getattr(env, f).cpu(), getattr(ref, f))
            for f in ("max_util_per_case", "member_envelope", "utilization",
                      "total_morison")}
    gov, gov_cpu = int(env.governing_case), int(ref.governing_case)
    # K1's f64 instance at this path's shapes (51 members, 36 phases, 8
    # modes): its end forces through every (case, phase, member)
    # utilization, its totals kernel through total_morison
    check(max(errs.values()) <= DENSE_F64_TOL and gov == gov_cpu,
          f"dense f64 envelope on the card (K1 f64 loads) vs the CPU f64 "
          f"plain run, every case and phase: utilization "
          f"{tuple(env.utilization.shape)} {errs['utilization']:.2e}, "
          f"total_morison {tuple(env.total_morison.shape)} "
          f"{errs['total_morison']:.2e}, max_util_per_case "
          f"{errs['max_util_per_case']:.2e}, member_envelope "
          f"{errs['member_envelope']:.2e} <= {DENSE_F64_TOL:g} of their "
          f"maxima; governing case {gov} == {gov_cpu}")
    # the same batch on an f32 copy of the model: K1's f32 instance at this
    # path's shapes, its totals against the f64 run at K1's f32 limit; the
    # utilization carries the f32 solve and recovery as well
    coarse32 = pt.default_3leg_jacket(dtype=torch.float32, device=dev)
    waves32 = waves_cpu.to(torch.float32, dev)

    def envelope32():
        return pt.design_envelope(coarse32, waves32, cases,
                                  n_steps=DESIGN_STEPS)
    env32, n, _ = counted(hk, envelope32)
    out["launches_f32"] = n["f32_batch"]
    check(same_counts(n, {"f32_batch": 1}), f"design_envelope of the f32 "
          f"model launched {n} (K1's case-batched f32 instance once for the "
          f"{C} cases, no per-case f32 launch)")
    errs32 = {f: rel(getattr(env32, f).cpu(), getattr(ref, f))
              for f in ("max_util_per_case", "member_envelope", "utilization",
                        "total_morison")}
    gov32 = int(env32.governing_case)
    print(f"[design] dense envelope of the f32 model vs the CPU f64 run: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs32.items())
          + f"; governing case {gov32}", flush=True)
    check(errs32["total_morison"] <= DENSE_LOAD_TOL
          and errs32["utilization"] <= DENSE_UTIL32_TOL
          and errs32["max_util_per_case"] <= ENV_CASE_TOL
          and errs32["member_envelope"] <= ENV_MEMBER_TOL and gov32 == gov_cpu,
          f"dense envelope of the f32 model (K1 f32) vs the CPU f64 run: "
          f"total_morison {errs32['total_morison']:.2e} <= "
          f"{DENSE_LOAD_TOL:g}, utilization {errs32['utilization']:.2e} <= "
          f"{DENSE_UTIL32_TOL:g}, max_util_per_case "
          f"{errs32['max_util_per_case']:.2e} <= {ENV_CASE_TOL:g}, "
          f"member_envelope {errs32['member_envelope']:.2e} <= "
          f"{ENV_MEMBER_TOL:g}, governing case {gov32} == {gov_cpu}")
    out["errs32"] = errs32
    out["ms_f32"] = cuda_ms(envelope32, n=5, warmup=1)
    events = device_events(envelope32)
    out["busy_f32_ms"] = sum(t for _, t in events) / 1e3
    out["k1_f32_us"] = sum(kernel_us(events, n) for n in F32_BATCH_KERNELS)
    _, batch = pt.analyze_phase_batch(coarse64, waves.case(gov),
                                      cases.case(gov), n_steps=DESIGN_STEPS,
                                      accel="analytic")
    gov_err = abs(float(env.max_util_per_case[gov])
                  / float(batch.utilization.max()) - 1.0)
    check(gov_err <= GOV_TOL, f"governing case vs analyze_phase_batch "
          f"(analytic): {gov_err:.2e} <= {GOV_TOL:g}")
    out["ms"] = cuda_ms(envelope, n=5, warmup=1)
    out["peak_mib"] = peak_mib(envelope)
    events = device_events(envelope)
    out["ops"], out["busy_ms"] = len(events), sum(t for _, t in events) / 1e3
    out["k1_us"] = sum(kernel_us(events, n) for n in HARM64_KERNELS)
    out["top"] = top_device_ops(events)
    out["errs"], out["gov_err"] = errs, gov_err
    return env, out


def sweep_phase(pt, dev, coarse64, waves_cpu, cases):
    """``design_sweep`` of the 1,000 cases at t_analysis = 0 and
    ``critical_case``: the governing case and 4 seeded random cases
    against a per-case ``analyze``; the time."""
    import numpy as np
    import torch
    from small_fem_solver_tpu_torch.parallel.sweep import (critical_case,
                                                           design_sweep)
    waves = waves_cpu.to(torch.float64, dev)
    C, out = waves.E.shape[0], {}

    def sweep():
        return design_sweep(coarse64, waves, cases, solver="chol",
                            accel="analytic")
    t0 = time.perf_counter()
    res = sweep()
    crit = critical_case(res)
    torch.cuda.synchronize()
    out["first_s"] = time.perf_counter() - t0
    check(tuple(res.U.shape) == (C, coarse64.n_dof)
          and bool(torch.isfinite(res.utilization).all()),
          f"design_sweep: U {tuple(res.U.shape)}, utilization finite")
    gov = int(crit["index"])
    picks = [gov] + [int(i) for i in np.random.default_rng(0).choice(
        C, 4, replace=False)]
    worst = 0.0
    for i in picks:
        one = pt.analyze(coarse64, waves.case(i), cases.case(i),
                         solver="chol", accel="analytic")
        errs = {f: rel(getattr(res, f)[i], getattr(one, f)) for f in (
            "U", "reactions", "F_applied", "F1_local", "F2_local",
            "von_mises", "utilization")}
        worst = max(worst, *errs.values())
        check(max(errs.values()) <= SWEEP_CASE_TOL, f"design_sweep case {i} "
              f"vs analyze: worst {max(errs, key=errs.get)} "
              f"{max(errs.values()):.2e} <= {SWEEP_CASE_TOL:g}")
        if i == gov:
            gov_err = abs(float(crit["max_utilization"])
                          / float(one.utilization.max()) - 1.0)
            check(gov_err <= SWEEP_CASE_TOL, f"critical_case: case {gov}, "
                  f"max utilization {float(crit['max_utilization']):.6f} vs "
                  f"analyze {gov_err:.2e}")
    out["ms"] = cuda_ms(sweep, n=5, warmup=1)
    events = device_events(sweep)
    out["ops"], out["busy_ms"] = len(events), sum(t for _, t in events) / 1e3
    out["worst"], out["gov"] = worst, gov
    out["gov_util"] = float(crit["max_utilization"])
    return out


def resume_phase(pt, dev, coarse64, waves_cpu, cases, env):
    """``design_envelope_resumable`` of the 1,000 cases in chunks of 64 in
    a temporary directory: a bounded call returns None, the resumed call
    equals the one-shot envelope ``env``, a mismatched resume raises."""
    import dataclasses
    import tempfile
    import torch
    waves = waves_cpu.to(torch.float64, dev)
    kw = dict(chunk_size=RESUME_CHUNK, n_steps=DESIGN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        part = pt.design_envelope_resumable(coarse64, waves, cases, tmp,
                                            max_chunks=3, **kw)
        n_files = len([f for f in os.listdir(tmp) if f.startswith("chunk_")])
        check(part is None and n_files == 3, f"max_chunks=3 returned "
              f"{type(part).__name__} with {n_files} chunk files")
        full = pt.design_envelope_resumable(coarse64, waves, cases, tmp, **kw)
        seconds = time.perf_counter() - t0
        errs = {f: rel(getattr(full, f), getattr(env, f).cpu())
                for f in ENV_FIELDS}
        check(max(errs.values()) <= RESUME_TOL
              and torch.equal(full.critical_phase, env.critical_phase.cpu())
              and int(full.governing_case) == int(env.governing_case),
              f"resumed envelope ({-(-cases.Cd.shape[0] // RESUME_CHUNK)} "
              f"chunks) == one design_envelope: worst "
              f"{max(errs, key=errs.get)} {max(errs.values()):.2e} <= "
              f"{RESUME_TOL:g}")
        other = dataclasses.replace(cases, Cd=cases.Cd * 1.1)
        try:
            pt.design_envelope_resumable(coarse64, waves, other, tmp, **kw)
            refused = False
        except ValueError as e:
            refused = "DIFFERENT sweep" in str(e)
        check(refused, "a resume with other cases into the same directory "
              "raises")
    return seconds


def harm64_bound(S: int, M: int, Q: int, N: int, n_nodes: int, C: int = 1,
                 wheeler: bool = False) -> dict:
    """The bound of one launch of K1's case-batched f64 instance: the mode
    sums, 4F FLOP per (case, phase, point, mode) (F = 5, 13 with Wheeler)
    at the FP64 tensor cores' 67 TFLOP/s, plus the epilogue, EPILOGUE_FLOP
    per (case, phase, point) at the 34 TFLOP/s of FP64 outside them,
    against the bytes (F1 / F2 and the totals written once; phase times,
    wave, per-case member coefficients, coords and members read once) at
    3.35 TB/s.  Returns us, by, the GFLOP of both parts and the MB."""
    F = 13 if wheeler else 5
    sums = C * S * M * Q * N * 4 * F
    epi = C * S * M * Q * EPILOGUE_FLOP
    nbytes = (8 * (C * (2 * S * M * 3 + S * 6 + S + 2 * N + 4 + 3 * M)
                   + n_nodes * 3) + 8 * 2 * M)
    t_ops = sums / FP64_TC_FLOP_PER_S + epi / FP64_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(us=max(t_ops, t_bytes) * 1e6,
                by="bytes" if t_bytes >= t_ops else "operations",
                sums_gflop=sums / 1e9, epilogue_gflop=epi / 1e9,
                mb=nbytes / 1e6)


# K1's f64 instance: its records pass, fused pass and totals
HARM64_KERNELS = ("morison_harm64_records_kernel", "morison_harm64_kernel",
                  "morison_harm64_totals_kernel")


def harm64_us(events) -> dict:
    """Device us of one K1 f64 launch by part (records pass, fused pass,
    totals) from profiler events of repeated launches, and their sum."""
    parts = [kernel_median_us(events, n) for n in HARM64_KERNELS]
    return {"records": parts[0], "fused": parts[1], "totals": parts[2],
            "total": sum(parts)}


def build_report_check(hk, what: str, pattern: str, label, counts: tuple,
                       f64) -> dict:
    """What the build says of a family of K1's kernels (``hk.build_report``:
    ptxas -v and cuobjdump -sass of the library): the kernels whose names
    match ``pattern``, each labelled ``label(match)`` ("fused ..." for a
    fused pass); ``counts`` = (fused passes, other kernels) of them in the
    library; every fused pass that ``f64(label)`` picks issues DMMA (its
    mode sums on the FP64 tensor cores), no other issues HMMA (no TF32),
    and no kernel of the family spills.  Returns {instance: registers,
    stack, spill bytes, DMMA, HMMA} and the first f64 fused pass's first
    DMMA's text."""
    import re
    out, first = {}, None
    for name, r in hk.build_report("morison_phase_batch").items():
        m = re.search(pattern, name)
        if m is None:
            continue
        lab = label(m)
        out[lab] = {k: r.get(k) for k in ("registers", "stack",
                                          "spill_stores", "spill_loads",
                                          "DMMA", "HMMA")}
        if lab.startswith("fused") and f64(lab) and first is None:
            first = r.get("first_dmma")
        print(f"[build] {what} {lab}: {out[lab]}", flush=True)
    fused = {k: v for k, v in out.items() if k.startswith("fused")}
    got = (len(fused), len(out) - len(fused))
    check(got == counts, f"{what}: {counts[0]} fused passes and {counts[1]} "
          f"other kernels in the library {got}")
    check(all((v["DMMA"] or 0) > 0 for k, v in fused.items() if f64(k)),
          f"every {what} f64 fused pass issues DMMA (FP64 tensor cores)")
    check(all(v["HMMA"] == 0 for k, v in fused.items() if not f64(k)),
          f"no {what} f32 fused pass issues HMMA (no TF32)")
    check(all(v["spill_stores"] == 0 and v["spill_loads"] == 0
              for v in out.values()), f"no {what} kernel spills (ptxas -v)")
    print(f"[build] {what} f64 first DMMA: {first}", flush=True)
    return {"instances": out, "first_dmma": first}


def harm64_build_report(hk) -> dict:
    """:func:`build_report_check` of K1's f64 harmonic instance: both fused
    passes (with and without Wheeler) issue DMMA; its records pass, fused
    passes and totals do not spill."""
    return build_report_check(
        hk, "K1 f64", r"morison_harm64_(kernel|records_kernel|totals_kernel)"
        r"(?:ILb([01])E)?",
        lambda m: (f"fused wheeler={m[2]}" if m[1] == "kernel"
                   else m[1].split("_")[0]), (2, 2), lambda lab: True)


def k1_f64_phase(pt, hk, dev, coarse64, refined64, wave64, waves_d, dirs_d):
    """K1's case-batched float64 instance against its plain f64 version on
    the same inputs (F1, F2 and the totals at 1e-12 of their maxima; the
    nodal forces too at one case's shapes), with and without Wheeler, at
    the four shapes its paths give it: the dense envelope (the 1,000
    design cases in ONE launch: 36 phases, 51 members, Stokes-5 with 8
    modes, per-case headings, per-(case, member) Cd, per-case Cm and rho),
    the flagship (360 phases, 1,632 members, Fenton N = 18), the harmonic
    response (72 phases) and the transient (1,536); then the flagship and
    transient phase counts at Fenton N = 28 and 32 (without Wheeler a
    block fills an SM's shared memory alone; N = 32 at 360 phases with
    Wheeler too, one B tile).  One launch a call,
    bit-repeatable, and case i of the batch bit-equal to a one-case launch
    of case i.  Each shape's device time (records pass, fused pass,
    totals) against its bound; the build report.  Returns the errors,
    times, bounds, and the flagship and one-case dense operands."""
    import numpy as np
    import torch
    from small_fem_solver_tpu_torch.ops.morison import (
        morison_end_forces, morison_end_forces_batch, morison_phase_batch)
    f64 = torch.float64
    build = harm64_build_report(hk)
    D = refined64.sections.D_outer[refined64.sect_id] / 1000.0

    def flagship(S, per_period=None, wave=wave64):
        ts = (torch.arange(S, dtype=f64, device=dev) * wave.T
              / (per_period or S))
        return (wave, refined64.coords, refined64.conn, D, 38.0, 38.0, 0.7,
                2.0, 1025.0, ts)
    rng, M, C = np.random.default_rng(7), coarse64.n_members, len(dirs_d)
    waves = waves_d.to(f64, dev)
    tens = dict(dtype=f64, device=dev)
    dirs = torch.tensor(dirs_d, **tens)
    dense_b = (waves, coarse64.coords, coarse64.conn,
               coarse64.sections.D_outer[coarse64.sect_id] / 1000.0, dirs,
               dirs, torch.tensor(rng.uniform(0.6, 1.1, (C, M)), **tens),
               torch.tensor(rng.uniform(1.6, 2.1, (C, 1)), **tens),
               torch.full((C,), 1025.0, **tens),
               torch.arange(DESIGN_STEPS, **tens)[None, :]
               * waves.T[:, None] / DESIGN_STEPS)
    # one case at the dense shapes (the f32 instance's check in main)
    stokes = pt.make_wave(14.0, 9.4, 50.0, U_c=1.7, model="stokes", N=5,
                          n_modes=8, dtype=f64, device=dev)
    dense = (stokes, coarse64.coords, coarse64.conn,
             coarse64.sections.D_outer[coarse64.sect_id] / 1000.0, 108.0,
             108.0, torch.tensor(rng.uniform(0.6, 1.1, M), device=dev),
             torch.tensor(rng.uniform(1.6, 2.1, M), device=dev), 1025.0,
             torch.arange(DESIGN_STEPS, dtype=f64, device=dev) * stokes.T
             / DESIGN_STEPS)
    # the most modes the wrappers take (Fenton N = 28, 32): without Wheeler
    # a block of 4 m-tiles fills an SM's shared memory alone
    fenton = {N: pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton",
                              N=N, n_modes=N, dtype=f64, device=dev)
              for N in (28, 32)}
    both, no_wheeler = ("none", "wheeler"), ("none",)
    shapes = {"dense envelope": (dense_b, C, both),
              "flagship": (flagship(N_STEPS), 1, both),
              "harmonic": (flagship(HARMONIC_STEPS), 1, both),
              "transient": (flagship(TRANSIENT_STEPS, 128), 1, both)}
    for N, w in fenton.items():
        shapes[f"flagship N {N}"] = (flagship(N_STEPS, wave=w), 1,
                                     both if N == 32 else no_wheeler)
        shapes[f"transient N {N}"] = (flagship(TRANSIENT_STEPS, 128, w), 1,
                                      no_wheeler)
    names = ("F1", "F2", "total_drag", "total_inertia")
    out = {"abs": 0.0, "rel": 0.0, "args": flagship(N_STEPS),
           "dense": dense, "dense_b": dense_b, "build": build, "shapes": {}}
    for label, (args, Cb, stretchings) in shapes.items():
        wave, coords, conn = args[:3]
        S, Mk, N = args[-1].shape[-1], conn.shape[0], wave.n_modes
        for stretching in stretchings:
            kw = dict(stretching=stretching, n_gauss=N_GAUSS)
            if Cb > 1:
                def call():
                    return hk.morison_end_forces_batch_cuda(*args, **kw)
            else:
                def call():
                    return hk.morison_end_forces_cuda(*args, **kw)
            before = hk.morison_phase_batch_cuda.instance_launches["f64"]
            res = call()
            again = call()
            torch.cuda.synchronize()
            n = hk.morison_phase_batch_cuda.instance_launches["f64"] - before
            if Cb > 1:
                ref = morison_end_forces_batch(*args, **kw)
            else:
                mb = morison_phase_batch(*args, **kw)
                ref = (mb.F1, mb.F2, mb.total_drag, mb.total_inertia)
            errs = {f: rel(a, b) for f, a, b in zip(names, res, ref)}
            tag = f"{label} (C={Cb} S={S} M={Mk} N={N}, {stretching})"
            print(f"[kernel f64] {tag}: max rel err "
                  + " ".join(f"{f}={e:.2e}" for f, e in errs.items()),
                  flush=True)
            check(n == 2 and res[0].dtype == f64
                  and tuple(res[0].shape) == ((Cb,) if Cb > 1 else ())
                  + (S, Mk, 3), f"K1 f64 instance: {n} launches for 2 calls "
                  f"({tag})")
            check(all(torch.isfinite(r).all() for r in res),
                  f"K1 f64 outputs finite ({tag})")
            check(max(errs.values()) <= KERNEL_TOL_F64, f"K1 f64 vs f64 "
                  f"plain ({tag}): {max(errs.values()):.2e} <= "
                  f"{KERNEL_TOL_F64:g}")
            check(all(torch.equal(a, b) for a, b in zip(res, again)),
                  f"K1 f64 bit-repeatable ({tag})")
            if Cb > 1:
                # case i of the batch against a one-case launch of case i
                picks = (0, 517, C - 1)
                for i in picks:
                    one = hk.morison_end_forces_cuda(
                        waves.case(i), *args[1:4], args[4][i], args[5][i],
                        args[6][i], args[7][i, 0], args[8][i], args[9][i],
                        **kw)
                    check(all(torch.equal(a[i], b) for a, b in
                              zip(res, one)), f"K1 f64 batch case {i} "
                          f"bit-equal to its one-case launch ({tag})")
            else:
                nod = hk.morison_phase_batch_cuda(*args, **kw).nodal_forces
                nerr = rel(nod, mb.nodal_forces)
                check(nerr <= KERNEL_TOL_F64, f"K1 f64 nodal forces vs "
                      f"plain ({tag}): {nerr:.2e} <= {KERNEL_TOL_F64:g}")
            out["rel"] = max(out["rel"], max(errs.values()))
            out["abs"] = max(out["abs"], *(float((a - b).abs().max())
                                           for a, b in zip(res[:2], ref[:2])))
            # device time beside the bound (the launches are not counted:
            # the count is read around each path's own run)
            ev = device_events(call, 10 if label == "dense envelope"
                               else SHORT_REPS)
            dev_us = harm64_us(ev)
            bound = harm64_bound(S, Mk, kw["n_gauss"], N, coords.shape[0],
                                 Cb, stretching == "wheeler")
            rec = {"device_us": dev_us, "bound": bound,
                   "share": bound["us"] / dev_us["total"],
                   "ms": cuda_ms(call, n=10), "max_rel_err":
                   max(errs.values())}
            if stretching == "none":
                plain = (morison_end_forces_batch if Cb > 1
                         else morison_end_forces)
                rec["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), n=3,
                                          warmup=1)
            out["shapes"][f"{label}, {stretching}"] = rec
            print(f"[bound] {SMI}: K1 f64 {tag}: {dev_us['total']:.1f} us "
                  f"on the device (records {dev_us['records']:.1f} + fused "
                  f"{dev_us['fused']:.1f} + totals {dev_us['totals']:.1f}); "
                  f"bound {bound['us']:.1f} us by {bound['by']} "
                  f"({bound['sums_gflop']:.2f} GFLOP of mode sums at 67 "
                  f"TFLOP/s, {bound['epilogue_gflop']:.2f} of epilogue at "
                  f"34, {bound['mb']:.1f} MB): {rec['share']:.0%} of the "
                  f"bound; wrapper {rec['ms']:.3f} ms"
                  + (f", plain f64 {rec['plain_ms']:.3f} ms"
                     if "plain_ms" in rec else "")
                  + " (torch.profiler, CUDA events)", flush=True)
    return out


def chain_ritz(dyn, fn):
    """The chain modes' Ritz values [Mc, block] of the last Rayleigh-Ritz
    step of ``fn()``, a Craig-Bampton reduction (``ops.dynamics.
    _chain_modes``: the subspace iteration's block, or the whole interior
    space on its dense path), read from its eigensolver's calls."""
    seen, eigh = [], dyn.eigh_general_small

    def record(A, B):
        lam, Q = eigh(A, B)
        seen.append(lam)
        return lam, Q
    dyn.eigh_general_small = record
    try:
        fn()
    finally:
        dyn.eigh_general_small = eigh
    return seen[-1]


def span_mac_err(a, b, freqs) -> float:
    """The largest 1 - MAC of a mode of ``a`` [n, dof] against the span of
    the modes of ``b`` whose frequencies agree with its own within 1e-6
    (the plain MAC against its counterpart where that mode is simple)."""
    import torch
    worst = 0.0
    for i in range(a.shape[0]):
        Q = torch.linalg.qr(b[(freqs - freqs[i]).abs()
                              <= 1e-6 * freqs[i]].T)[0]
        p = Q.T @ a[i]
        worst = max(worst, 1.0 - float(p @ p / (a[i] @ a[i])))
    return worst


def freq_err(a, b) -> float:
    """The largest relative difference of two frequency vectors."""
    return float(((a.cpu() - b) / b).abs().max())


def counted(hk, fn):
    """(fn(), launch counts, host seconds): every kernel count set to 0
    just before the call and read just after it (the sweep's narrow-form
    count stays on ``hk.chain_sweep_cuda.narrow_launches``, read there
    right after)."""
    import torch
    hk.chain_sweep_cuda.launches = 0
    hk.chain_sweep_cuda.narrow_launches = 0
    hk.morison_phase_batch_cuda.launches = 0
    counts = hk.morison_phase_batch_cuda.instance_launches
    counts.update({k: 0 for k in counts})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return res, {"sweep": hk.chain_sweep_cuda.launches, **counts}, seconds


def same_counts(n: dict, want: dict) -> bool:
    """Launch counts ``n`` (from :func:`counted`) equal ``want``, a kernel
    or instance that ``want`` leaves out counted as 0."""
    return all(v == want.get(k, 0) for k, v in n.items())


def call_record(fn) -> dict:
    """Two more calls of a path: one for its host-clock time and peak
    device memory, one for its device operations, busy time and kernel
    times (torch.profiler, device activity only, which costs less on calls
    of tens of thousands of operations)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t0,
           "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    events = device_events(fn, host=False)
    rec["ops"], rec["busy_ms"] = len(events), sum(t for _, t in events) / 1e3
    rec["sweep_us"] = kernel_us(events, SWEEP_KERNEL)
    # K1's f64 instance: its records pass and its fused pass
    rec["k1_us"] = sum(kernel_us(events, n) for n in HARM64_KERNELS[:2])
    # K1-sea: its records pass and its fused pass
    rec["k1_sea_us"] = (kernel_us(events, "morison_sea_records_kernel")
                        + kernel_us(events, "morison_sea_kernel"))
    rec["top"] = top_device_ops(events, 3)
    return rec


def dynamics_phase(pt, hk, dev, coarse64, refined64, wave64):
    """Structural dynamics of the flagship mesh (9,612 DOF, f64, 1,100 t
    topside), each call against the port's CPU f64 run of the same call,
    with its launch counts read around exactly that call: modal analysis
    (clamped and dry; on springs with added mass), Craig-Bampton against
    the dense modal analysis at n_seg = 8, the harmonic response to the
    flagship storm and its fatigue screen, the 12-period transient against
    the harmonic steady state, and the transient variants (relative drag,
    free decay, ground acceleration).  Returns the records."""
    import dataclasses
    import numpy as np
    import torch
    from small_fem_solver_tpu_torch.ops import dynamics as dyn
    cpu_c = pt.default_3leg_jacket(device="cpu")
    cpu_r = pt.refine_model(cpu_c, N_SEG)
    wave_cpu = wave64.to(torch.float64, "cpu")
    case = pt.LoadCase(**CASE)
    T = float(wave64.T)
    out, launches, rec = {}, {}, {}

    def on_both(label, fn, want):
        """``fn(coarse, refined, wave)`` on the card (counted, timed, its
        peak memory, then profiled once more) and on the CPU; checks the
        counts against ``want``."""
        t0 = time.perf_counter()
        card, n, _ = counted(hk, lambda: fn(coarse64, refined64, wave64))
        check(same_counts(n, want), f"{label}: kernel launches {n} == {want}")
        launches[label] = n
        rec[label] = call_record(lambda: fn(coarse64, refined64, wave64))
        t1 = time.perf_counter()
        cpu = fn(cpu_c, cpu_r, wave_cpu)
        out[label + " cpu_s"] = time.perf_counter() - t1
        print(f"[dynamics] {label}: card calls {t1 - t0:.2f} s, CPU f64 run "
              f"{out[label + ' cpu_s']:.2f} s (host clock)", flush=True)
        return card, cpu

    # ---- modal ----
    modal_kw = dict(n_modes=10, n_chain_modes=CHAIN_MODES,
                    topside_mass_t=TOPSIDE_T)
    modal = {}
    for label, kw in (("modal", {}),
                      ("modal springs + added mass",
                       dict(support_stiffness=SPRINGS, added_mass_Ca=1.0))):
        card, cpu = on_both(label, lambda c, r, w: pt.modal_analysis_condensed(
            c, r, N_SEG, **modal_kw, **kw), {"sweep": 10, "f32": 0, "f64": 0})
        fe = freq_err(card.frequencies_hz, cpu.frequencies_hz)
        me = span_mac_err(card.mode_shapes.cpu(), cpu.mode_shapes,
                          cpu.frequencies_hz)
        print(f"[dynamics] {label} @ {refined64.n_dof} DOF: periods "
              + " ".join(f"{float(p):.5f}" for p in card.periods_s)
              + f" s; vs CPU: frequencies {fe:.2e}, 1 - MAC {me:.2e}",
              flush=True)
        check(card.mode_shapes.shape == (10, refined64.n_dof)
              and bool(torch.isfinite(card.mode_shapes).all()),
              f"{label}: mode shapes {tuple(card.mode_shapes.shape)} finite")
        check(fe <= MODAL_FREQ_TOL and me <= MODAL_MAC_TOL, f"{label} card "
              f"vs CPU: frequencies {fe:.2e} <= {MODAL_FREQ_TOL:g}, 1 - MAC "
              f"{me:.2e} <= {MODAL_MAC_TOL:g}")
        modal[label] = card
        out[label + " errs"] = (fe, me)
    check(bool((modal["modal springs + added mass"].periods_s[:4]
                > modal["modal"].periods_s[:4]).all()),
          "springs and added mass lengthen the first four periods")
    # the exact chain spectrum (the dense Rayleigh-Ritz on each chain's
    # whole interior space, which every count up to it would take)
    n_chain = 6 * (N_SEG - 1)
    exact = chain_ritz(dyn, lambda: dyn._cb_reduce(
        cpu_c, cpu_r, N_SEG, 210000.0, 0.3, None, n_chain))

    # ---- physics: Craig-Bampton vs the dense modal analysis, n_seg = 8 ----
    r8 = pt.refine_model(coarse64, 8)
    dense = pt.modal_analysis(r8, n_modes=12, topside_mass_t=TOPSIDE_T)
    cb8 = pt.modal_analysis_condensed(coarse64, r8, 8, n_modes=12,
                                      topside_mass_t=TOPSIDE_T,
                                      n_chain_modes=16)
    out["cb_dense"] = freq_err(cb8.frequencies_hz, dense.frequencies_hz.cpu())
    out["cb_dense_mass"] = abs(float(cb8.total_mass_t)
                               / float(dense.total_mass_t) - 1.0)
    check(out["cb_dense"] <= CB_DENSE_TOL and out["cb_dense_mass"] <= 1e-9,
          f"Craig-Bampton (16 chain modes) vs dense modal_analysis on the "
          f"card at n_seg = 8 ({r8.n_dof} DOF): frequencies "
          f"{out['cb_dense']:.2e} <= {CB_DENSE_TOL:g}, total mass "
          f"{out['cb_dense_mass']:.1e}")

    # ---- harmonic ----
    def harmonic(c, r, w, n_steps=72, n_harmonics=6, **kw):
        return pt.dynamic_response_condensed(c, r, N_SEG, w, case,
                                             n_harmonics=n_harmonics,
                                             n_steps=n_steps, **kw)
    hc, hp = on_both("dynamic_condensed", harmonic,
                     {"sweep": 10, "f32": 0, "f64": 1})
    errs = {f: rel(getattr(hc, f).cpu(), getattr(hp, f))
            for f in ("U_time", "U_static", "daf", "utilization")}
    check(tuple(hc.U_time.shape) == (72, refined64.n_dof)
          and all(bool(torch.isfinite(getattr(hc, f)).all())
                  for f in ("U_time", "U_static", "utilization")),
          f"harmonic response: U_time {tuple(hc.U_time.shape)} finite")
    check(max(errs["U_time"], errs["U_static"], errs["daf"]) <= HARMONIC_TOL
          and errs["utilization"] <= UTIL_DYN_TOL, "harmonic response card "
          "vs CPU: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {HARMONIC_TOL:g} (utilization {UTIL_DYN_TOL:g})")
    fy = float(case.fy)
    fat = [pt.fatigue_screen(h.utilization * fy, T, 25.0) for h in (hc, hp)]
    ferr = max(rel(getattr(fat[0], f).cpu(), getattr(fat[1], f))
               for f in ("stress_range_mpa", "damage"))
    check(ferr <= UTIL_DYN_TOL, f"fatigue_screen of the harmonic von Mises "
          f"history, card vs CPU: {ferr:.2e} <= {UTIL_DYN_TOL:g}")
    out["harmonic_errs"], out["fatigue_err"] = errs, ferr
    out["daf"] = float(hc.daf)
    out["max_util"] = float(hc.utilization.max())
    out["max_damage"] = float(fat[0].damage.max())
    print(f"[dynamics] harmonic response, flagship storm, 72 steps, 6 "
          f"harmonics: DAF {out['daf']:.6f}, max utilization "
          f"{out['max_util']:.6f}, 25-year damage (D curve) "
          f"{out['max_damage']:.3e}; vs CPU "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    # which chain pairs the retained count splits: tubes bend alike in two
    # planes, so the chain spectrum holds exactly degenerate pairs; the
    # subspace iteration leaves each split by its convergence residue (its
    # Ritz gap), and a count that cuts a pair keeps a rotation of it that
    # roundoff moves by ~1e-16 / Ritz gap.  At each count: the card against
    # the CPU, the chain that carries the largest utilization difference
    # and its gaps, and the CPU run against itself on the jacket moved
    # 1e-11 m (a roundoff-level perturbation)
    moved_c = dataclasses.replace(cpu_c, coords=cpu_c.coords + torch.tensor(
        [1e-11, 0.0, 0.0], dtype=torch.float64))
    moved_r = pt.refine_model(moved_c, N_SEG)
    out["cuts"] = {}
    for m in (10, CHAIN_MODES, 14):
        ritz = chain_ritz(dyn, lambda: dyn._cb_reduce(
            cpu_c, cpu_r, N_SEG, 210000.0, 0.3, None, m))
        gap, egap = ((lam[:, m] - lam[:, m - 1]) / lam[:, m - 1]
                     for lam in (ritz, exact))
        a, b = (hc, hp) if m == CHAIN_MODES else (
            harmonic(c, r, w, n_chain_modes=m)
            for c, r, w in ((coarse64, refined64, wave64),
                            (cpu_c, cpu_r, wave_cpu)))
        moved = harmonic(moved_c, moved_r, wave_cpu, n_chain_modes=m)
        e = {"U_time": rel(a.U_time.cpu(), b.U_time),
             "utilization": rel(a.utilization.cpu(), b.utilization),
             "moved_utilization": rel(moved.utilization, b.utilization)}
        d = ((a.utilization.cpu() - b.utilization).abs().amax(0)
             .reshape(-1, N_SEG).amax(1))                  # per chain
        j = int(d.argmax())
        out["cuts"][m] = dict(e, ritz_gap_min=float(gap.min()),
                              worst_chain=j, worst_ritz_gap=float(gap[j]),
                              exact_gap_max=float(egap.max()))
        print(f"[dynamics] {m} chain modes (Ritz block {ritz.shape[1]}): "
              f"card vs CPU U_time {e['U_time']:.2e}, utilization "
              f"{e['utilization']:.2e}, largest in chain {j} (Ritz gap "
              f"{float(gap[j]):.2e}, exact {float(egap[j]):.2e}); Ritz gaps "
              f"at the cut from {float(gap.min()):.2e} (chain "
              f"{int(gap.argmin())}), exact gaps below 1e-12 in "
              f"{int((egap < 1e-12).sum())} of {gap.shape[0]} chains; CPU "
              f"vs CPU on the moved jacket: utilization "
              f"{e['moved_utilization']:.2e}", flush=True)
        if m != CHAIN_MODES:
            check(max(e["U_time"], e["utilization"]) <= HARMONIC_TOL,
                  f"harmonic response with {m} chain modes, card vs CPU: "
                  f"U_time {e['U_time']:.2e}, utilization "
                  f"{e['utilization']:.2e} <= {HARMONIC_TOL:g}")

    # ---- transient: 12 periods at T/128, ramped over 2 ----
    spp, n_per = 128, 12

    def transient(c, r, w, **kw):
        return pt.transient_response_condensed(c, r, N_SEG, w, case,
                                               dt=T / spp, **kw)
    storm_kw = dict(n_steps=n_per * spp, ramp_periods=2.0)
    tc, tp = on_both("transient", lambda c, r, w: transient(c, r, w,
                                                           **storm_kw),
                     {"sweep": 10, "f32": 0, "f64": 1})
    terr = {f: rel(getattr(tc, f).cpu(), getattr(tp, f))
            for f in ("U_time", "utilization", "tip_displacement_mm")}
    check(max(terr["U_time"], terr["tip_displacement_mm"]) <= TRANSIENT_TOL
          and terr["utilization"] <= UTIL_DYN_TOL, "transient card vs CPU: "
          + ", ".join(f"{k} {v:.2e}" for k, v in terr.items())
          + f" <= {TRANSIENT_TOL:g} (utilization {UTIL_DYN_TOL:g})")
    h128 = harmonic(coarse64, refined64, wave64, n_steps=spp, n_harmonics=8)
    u_last = float(tc.utilization[-spp:].max())
    u_harm = float(h128.utilization.max())
    tip_h = torch.amax(torch.linalg.norm(
        h128.U_time.reshape(spp, -1, 6)[:, :, :3], dim=-1), dim=-1)
    tip_err = float((tc.tip_displacement_mm[-spp:] - tip_h).abs().max()
                    / tip_h.max())
    util_err = abs(u_last / u_harm - 1.0)
    check(util_err <= STEADY_UTIL_TOL and tip_err <= STEADY_TIP_TOL,
          f"transient last period vs harmonic steady state (128 steps): max "
          f"utilization {u_last:.6f} vs {u_harm:.6f} ({util_err:.2e} <= "
          f"{STEADY_UTIL_TOL:g}), tip history {tip_err:.2e} <= "
          f"{STEADY_TIP_TOL:g}")
    out["transient_errs"], out["steady"] = terr, (util_err, tip_err)
    out["steps_per_s"] = storm_kw["n_steps"] / rec["transient"]["s"]

    # ---- transient variants ----
    T1 = float(modal["modal"].periods_s[0])
    shape = modal["modal"].mode_shapes[0]
    u0 = 50.0 * shape / shape.abs().max()
    n_cycles = 6
    ag = np.convolve(np.random.default_rng(11).normal(0.0, 1.0, 512),
                     np.hanning(16) / np.hanning(16).sum(), mode="same")
    variants = (
        ("transient relative drag", dict(n_steps=2 * spp, ramp_periods=1.0,
                                         relative_drag=True,
                                         drag_iterations=2),
         {"sweep": 10, "f32": 0, "f64": 1}),
        ("transient free decay", dict(n_steps=n_cycles * 128 + 1,
                                      zero_loads=True, dt=T1 / 128.0),
         {"sweep": 10, "f32": 0, "f64": 0}),
        ("transient ground accel", dict(n_steps=ag.size, zero_loads=True,
                                        dt=0.01, ground_dir=(1.0, 0.5, 0.0)),
         {"sweep": 10, "f32": 0, "f64": 0}))
    for label, kw, want in variants:
        def run(c, r, w, kw=kw):
            extra = {}
            if "decay" in label:
                extra["u0"] = u0.to(c.device)
            if "ground" in label:
                extra["ground_accel"] = torch.tensor(ag, device=c.device)
            return pt.transient_response_condensed(
                c, r, N_SEG, None if kw.get("zero_loads") else w, case,
                **{"dt": T / spp, **kw, **extra})
        vc, vp = on_both(label, run, want)
        verr = rel(vc.U_time.cpu(), vp.U_time)
        check(bool(torch.isfinite(vc.U_time).all()) and verr <= TRANSIENT_TOL,
              f"{label} card vs CPU: U_time {verr:.2e} <= {TRANSIENT_TOL:g}")
        out[label + " err"] = verr
        if "decay" in label:
            tip = vc.tip_displacement_mm.cpu().numpy()
            pk = np.where((tip[1:-1] > tip[:-2]) & (tip[1:-1] > tip[2:]))[0] + 1
            peaks = tip[pk][::2][:n_cycles]
            delta = np.log(peaks[:-1] / peaks[1:])
            zeta = float((delta / np.sqrt(4 * np.pi**2 + delta**2)).mean())
            T_meas = float(2 * kw["dt"] * np.diff(pk).mean())
            T_d = T1 / np.sqrt(1 - 0.02**2)
            out["decay"] = (zeta, T_meas, T_d)
            check(pk.size >= 2 * n_cycles - 2
                  and abs(zeta / 0.02 - 1) <= DECAY_ZETA_RTOL
                  and abs(T_meas / T_d - 1) <= DECAY_PERIOD_RTOL,
                  f"free decay from mode 1: damping ratio {zeta:.5f} vs "
                  f"0.02, period {T_meas:.5f} vs {T_d:.5f} s "
                  f"({pk.size} peaks)")
    out["launches"], out["rec"] = launches, rec
    out["modal_freqs"] = modal["modal"].frequencies_hz.cpu()
    return out


def modal_large_phase(pt, hk, coarse64, freqs_9612):
    """``modal_analysis_condensed`` at n_seg = 327 (99,882 DOF, f64): 10
    sweep launches at depth 326, the first 8 frequencies within 2e-3 of
    the 9,612-DOF ones (mesh convergence); time and peak memory."""
    import torch
    big = pt.refine_model(coarse64, N_SEG_LARGE)

    def modal():
        return pt.modal_analysis_condensed(coarse64, big, N_SEG_LARGE,
                                           n_modes=8,
                                           n_chain_modes=CHAIN_MODES,
                                           topside_mass_t=TOPSIDE_T)
    res, n, _ = counted(hk, modal)
    narrow = hk.chain_sweep_cuda.narrow_launches
    check(same_counts(n, {"sweep": 10}) and narrow == 10, f"99,882-DOF "
          f"modal: kernel launches {n}, {narrow} of the sweeps in its narrow "
          "form (the chain-mode iteration, B = 18)")
    err = freq_err(res.frequencies_hz, freqs_9612[:8])
    check(res.mode_shapes.shape == (8, big.n_dof)
          and bool(torch.isfinite(res.mode_shapes).all())
          and err <= MESH_FREQ_TOL,
          f"99,882-DOF modal: first 8 frequencies within {err:.2e} <= "
          f"{MESH_FREQ_TOL:g} of 9,612 DOF")
    rec = call_record(modal)
    rec.update(launches=n, narrow=narrow, err=err,
               periods=[float(p) for p in res.periods_s])
    return rec


def sea_fields(spread: bool, wheeler: bool) -> int:
    """Kinematic fields of K1-sea's mode sums: eta, u, w, du/dt, dw/dt (+ v,
    dv/dt for a spread sea) and, with Wheeler, their d/dz and d^2/dz^2 rows
    (all but eta's)."""
    return (7 if spread else 5) + ((12 if spread else 8) if wheeler else 0)


def sea_bound(itemsize: int, S: int, M: int, Q: int, N: int, n_nodes: int,
              spread: bool, wheeler: bool) -> dict:
    """The bound of one K1-sea launch, the least time over the two forms
    of its mode sums: the matrix product (4F FLOP per (phase, point,
    mode)) and the angle difference (6 + 2F: cos / sin of the angle
    difference, then one FMA per field), F = ``sea_fields``, plus the
    epilogue.  FP32 at 67 TFLOP/s; FP64 the better of the angle form at
    34 and the matrix form at 67 (the FP64 tensor cores), the epilogue
    at 34.  Bytes: F1 / F2 and the totals written once; times, phase
    table, per-mode arrays, coords and member arrays read once.  Returns
    us, by, form, both forms' GFLOP, the epilogue's and the MB."""
    F = sea_fields(spread, wheeler)
    items = S * M * Q * N
    matrix, angle = items * 4 * F, items * (6 + 2 * F)
    epi = S * M * Q * EPILOGUE_FLOP
    nbytes = itemsize * (2 * S * M * 3 + S * 6 + S + 2 * S * N + 6 * N
                         + n_nodes * 3 + 3 * M) + 8 * 2 * M
    if itemsize == 4:
        forms = {"matrix": (matrix + epi) / FP32_FLOP_PER_S,
                 "angle": (angle + epi) / FP32_FLOP_PER_S}
    else:
        forms = {"matrix": matrix / FP64_TC_FLOP_PER_S
                 + epi / FP64_FLOP_PER_S,
                 "angle": (angle + epi) / FP64_FLOP_PER_S}
    form = min(forms, key=forms.get)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(us=max(t_bytes, forms[form]) * 1e6,
                by="bytes" if t_bytes >= forms[form] else "operations",
                form=form, matrix_gflop=matrix / 1e9,
                angle_gflop=angle / 1e9, epilogue_gflop=epi / 1e9,
                mb=nbytes / 1e6)


def sea_mode_sums_ms(sea, ts, P: int, F: int, dtype) -> float:
    """The yardstick of K1-sea's mode sums alone: one ``torch.matmul`` of
    the phase table [S, 2N] by a coefficient matrix [2N, P F] (random,
    from a seeded generator), SGEMM without TF32 or DGEMM; ms, CUDA
    events.  The port never calls it."""
    import torch
    from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
    dev = ts.device
    table = hk.sea_phase_table(sea, ts.to(dtype))
    gen = torch.Generator(device=dev).manual_seed(0)
    coeffs = torch.randn(2 * sea.n_modes, P * F, generator=gen, device=dev,
                         dtype=dtype)
    out = torch.empty(ts.shape[0], P * F, device=dev, dtype=dtype)
    ms = cuda_ms(lambda: torch.matmul(table, coeffs, out=out), n=5,
                 warmup=1)
    del table, coeffs, out
    torch.cuda.empty_cache()
    return ms


def sea_build_report(hk) -> dict:
    """:func:`build_report_check` of K1-sea's kernels: every f64 fused pass
    issues DMMA, no f32 one HMMA, none of them spills."""
    def label(m):
        return (("fused" if m[1] == "kernel" else "records") + " "
                + {"f": "f32", "d": "f64"}[m[2]] + "".join(
                    f" {f}={b}" for f, b in zip(
                        ("wheeler", "spread") if m[4] else ("spread",),
                        m.groups()[2:]) if b is not None))
    return build_report_check(
        hk, "K1-sea", r"morison_sea_(kernel|records_kernel)I([fd])Lb([01])"
        r"(?:ELb([01]))?", label, (8, 4), lambda lab: "f64" in lab)


def k1_sea_phase(pt, hk, dev, coarse64, refined64):
    """K1's general-mode (random sea) instance with per-member Cd / Cm: f32
    against the plain version in f64 on the same f32-rounded inputs (1e-5
    of the largest value, off the surface band) and f64 against f64
    (1e-12), one launch a call on its instance's counter, bit-repeatable.
    Shapes on the flagship mesh: N = 64 (the sea scan's: 2,048 samples,
    Wheeler), 48 (a power-law current), 37 (N off the 16-mode chunk;
    spread, Wheeler, S = 1,023 off the phase tile) and 256 (spread, S =
    515); on the coarse jacket (51 members, fewer member tiles than a grid
    row) Q = 7 (two members a tile; spread, Wheeler, N = 37, S = 515);
    on the flagship mesh again Q = 8 (two members fill a tile; Wheeler)
    and Q = 16 (one member fills it; spread, Wheeler), N = 37, S = 515.
    Then the sea scan's shapes timed: the wrapper (CUDA events), the plain
    versions, the kernel's device time (torch.profiler) beside its bound
    and the mode sums alone as one ``torch.matmul``.  Returns the
    records."""
    import numpy as np
    import torch
    from small_fem_solver_tpu_torch.ops.spectrum import morison_sea_end_forces
    f32, f64 = torch.float32, torch.float64
    fields = ("F1", "F2", "total_drag", "total_inertia")
    out = {"rel": {}, "abs": {}, "cases": [], "build": sea_build_report(hk)}
    shapes = (("sea scan shapes, Wheeler", refined64, 15, SEA_N, SEA_STEPS,
               None, "wheeler", None),
              ("power-law current", refined64, 15, 48, SEA_STEPS, None,
               "none", 1.0 / 7.0),
              ("spread, Wheeler, N=37, S=1023", refined64, 15, 37, 1023,
               SPREADING_S, "wheeler", None),
              ("spread, N=256, S=515", refined64, 15, 256, 515, SPREADING_S,
               "none", None),
              ("coarse jacket, Q=7, spread, Wheeler", coarse64, 7, 37, 515,
               SPREADING_S, "wheeler", None),
              ("Q=8, Wheeler, N=37, S=515", refined64, 8, 37, 515, None,
               "wheeler", None),
              ("Q=16, spread, Wheeler, N=37, S=515", refined64, 16, 37, 515,
               SPREADING_S, "wheeler", None))
    for label, model, Q, N, S, spread, st, alpha in shapes:
        M = model.n_members
        rng = np.random.default_rng(17)
        D = model.sections.D_outer[model.sect_id] / 1000.0
        Cd = torch.tensor(rng.uniform(0.6, 1.1, M), device=dev)
        Cm = torch.tensor(rng.uniform(1.6, 2.1, M), device=dev)
        sea = pt.make_random_sea(SEA_HS, SEA_TP, SEA_D, n_components=N,
                                 seed=0, U_c=SEA_UC, spreading_s=spread,
                                 device=dev)
        ts = torch.arange(S, dtype=f64, device=dev) * SEA_TP / 10.0
        kw = dict(n_gauss=Q, current_alpha=alpha, stretching=st)
        for dtype, key, tol in ((f32, "sea_f32", KERNEL_TOL),
                                (f64, "sea_f64", KERNEL_TOL_F64)):
            ops = hk.cast_operands(dtype, dev, sea, model.coords, D,
                                   38.0, 38.0, Cd, Cm, 1025.0, ts)
            ref_ops = hk.cast_operands(f64, dev, *ops)
            before = hk.morison_phase_batch_cuda.instance_launches[key]
            res = hk.morison_sea_batch_cuda(ops[0], ops[1], model.conn,
                                            *ops[2:], **kw)
            again = hk.morison_sea_batch_cuda(ops[0], ops[1], model.conn,
                                              *ops[2:], **kw)
            torch.cuda.synchronize()
            n = hk.morison_phase_batch_cuda.instance_launches[key] - before
            ref = dict(zip(fields, morison_sea_end_forces(
                ref_ops[0], ref_ops[1], model.conn, *ref_ops[2:], **kw)))
            held = ""
            if dtype == f32:
                # f32 against f64: the (sample, member) pairs with a point
                # within hk.SURFACE_BAND of the surface are held out (counted;
                # their error printed), the totals of their samples too
                near = hk.surface_band(ref_ops[0], ref_ops[1], model.conn,
                                       ref_ops[3], ref_ops[-1], n_gauss=Q)
                keep_sm = ~near[..., None]
                keep_s = ~near.any(dim=1)[:, None]
                mask = {"F1": keep_sm, "F2": keep_sm, "total_drag": keep_s,
                        "total_inertia": keep_s}
                errs = {f: float(((getattr(res, f).double() - ref[f])
                                  * mask[f]).abs().max()
                                 / ref[f].abs().max()) for f in fields}
                band_err = max(rel(getattr(res, f), ref[f]) for f in fields)
                held = (f"; {int(near.sum())} of {near.numel()} (sample, "
                        f"member) pairs within {hk.SURFACE_BAND:g} m of the "
                        f"surface held out ({int((~keep_s).sum())} samples "
                        f"for the totals), largest error with them "
                        f"{band_err:.2e}")
            else:
                keep_sm = torch.ones(1, dtype=torch.bool, device=dev)
                errs = {f: rel(getattr(res, f), ref[f]) for f in fields}
            print(f"[kernel sea] {key} {label}: S={S} M={M} Q={Q} N={N} max "
                  "rel err " + " ".join(f"{f}={e:.2e}"
                                        for f, e in errs.items())
                  + held, flush=True)
            check(n == 2 and res.F1.dtype == dtype
                  and all(torch.isfinite(getattr(res, f)).all()
                          for f in fields),
                  f"K1 {key} launched once a call ({n} for 2), outputs "
                  f"finite ({label})")
            check(max(errs.values()) <= tol, f"K1 {key} vs f64 plain "
                  f"({label}): {max(errs.values()):.2e} <= {tol:g}")
            check(all(torch.equal(getattr(res, f), getattr(again, f))
                      for f in fields + ("nodal_forces",)),
                  f"K1 {key} bit-repeatable ({label})")
            out["rel"][key] = max(out["rel"].get(key, 0.0),
                                  max(errs.values()))
            out["abs"][key] = max(out["abs"].get(key, 0.0), *(
                float(((getattr(res, f).double() - ref[f]) * keep_sm)
                      .abs().max()) for f in ("F1", "F2")))
            del ref
        out["cases"].append(label)
    # the sea scan's shapes: wrapper, plain, device time, bound, mode sums
    M = refined64.n_members
    rng = np.random.default_rng(17)
    D = refined64.sections.D_outer[refined64.sect_id] / 1000.0
    Cd = torch.tensor(rng.uniform(0.6, 1.1, M), device=dev)
    Cm = torch.tensor(rng.uniform(1.6, 2.1, M), device=dev)
    sea = pt.make_random_sea(SEA_HS, SEA_TP, SEA_D, n_components=SEA_N,
                             seed=0, U_c=SEA_UC, device=dev)
    ts = torch.arange(SEA_STEPS, dtype=f64, device=dev) * SEA_TP / 10.0
    for dtype, key in ((f32, "sea_f32"), (f64, "sea_f64")):
        ops = hk.cast_operands(dtype, dev, sea, refined64.coords, D, 38.0,
                               38.0, Cd, Cm, 1025.0, ts)
        args = (ops[0], ops[1], refined64.conn, *ops[2:])
        k_ops = hk.sea_kernel_operands(*args, n_gauss=15, current_alpha=None)
        ms = cuda_ms(lambda: hk.morison_sea_end_forces_cuda(
            *args, stretching="wheeler"), n=10)
        plain_ms = cuda_ms(lambda: morison_sea_end_forces(
            *args, stretching="wheeler"), n=3, warmup=1)
        raw_ms = cuda_ms(lambda: hk.launch_morison_sea(k_ops, True), n=10)
        ev = device_events(lambda: hk.launch_morison_sea(k_ops, True),
                           SHORT_REPS // 5)
        rec_us = kernel_median_us(ev, "morison_sea_records_kernel")
        pass_us = kernel_median_us(ev, "morison_sea_kernel")
        tot_us = kernel_median_us(ev, "morison_totals_kernel")
        us = rec_us + pass_us + tot_us
        b = sea_bound(ops[1].element_size(), SEA_STEPS, M, 15, SEA_N,
                      refined64.n_nodes, False, True)
        lib_ms = sea_mode_sums_ms(sea, ts, M * 15, sea_fields(False, True),
                                  dtype)
        out[key] = dict(ms=ms, plain_ms=plain_ms, device_us=us,
                        launch_ms=raw_ms, bound_us=b["us"], bound_by=b["by"],
                        bound_form=b["form"], library_ms=lib_ms)
        print(f"[bound] {SMI}: K1 {key} at the sea scan's shapes (S="
              f"{SEA_STEPS}, M={M}, N={SEA_N}, Wheeler) {us:.1f} us on the "
              f"device (median launch: records {rec_us:.1f} + pass "
              f"{pass_us:.1f} + totals "
              f"{tot_us:.1f}; the launch alone {raw_ms:.3f} ms, CUDA "
              f"events); bound {b['us']:.1f} us by {b['by']} ({b['form']} "
              f"form; mode sums {b['matrix_gflop']:.1f} GFLOP as a matrix "
              f"product, {b['angle_gflop']:.1f} as angle differences, + "
              f"{b['epilogue_gflop']:.1f} epilogue; {b['mb']:.1f} MB): "
              f"{b['us'] / us:.0%} of the bound; wrapper {ms:.3f} ms vs "
              f"plain {plain_ms:.3f} ms; mode sums alone as one "
              f"torch.matmul [{SEA_STEPS}, {2 * SEA_N}] @ [{2 * SEA_N}, "
              f"{M * 15 * sea_fields(False, True)}] {lib_ms:.3f} ms "
              "(torch.profiler, CUDA events)", flush=True)
    return out


def scan_equilibrium(pt, s, dev) -> float:
    """Largest |sum of reactions + applied loads| over the largest applied
    load, every step of a condensed scan of the flagship case (topside
    shear along the wave heading, axial load, custom self-weight, Morison
    totals)."""
    import torch
    f64 = torch.float64
    tm = s.total_morison.double()
    th = torch.deg2rad(torch.tensor(90.0 - CASE["wave_dir_deg"], dtype=f64,
                                    device=dev))
    shear = CASE["F_shear_kN"] * 1e3
    weight = CASE["custom_sw_tonnes"] * 1e3 * pt.G_GRAV
    applied = torch.stack([shear * torch.cos(th) + tm[:, 0],
                           shear * torch.sin(th) + tm[:, 1],
                           -CASE["F_axial_kN"] * 1e3 - weight + tm[:, 2]],
                          dim=1)
    R = s.reactions.double().sum(dim=1)[:, :3]
    return float((R + applied).abs().max() / applied.abs().max())


def tie_err(mean, rows, scf=1.0) -> float:
    """Distance of each member's mean stress ``mean`` [..., M] to the
    nearest mean of its governing circumferential points in the transfer
    ``rows`` (the argmax of the 8 variances; points whose variances tie
    to 1e-9, opposite points of a member whose axial stress has no
    variance, may each govern, so roundoff picks one), over the largest
    such mean."""
    import torch
    sc, ss = rows.stress_cos.double().cpu(), rows.stress_sin.double().cpu()
    m0 = 0.5 * torch.sum((sc * scf)**2 + (ss * scf)**2, dim=0)
    gov = m0 >= m0.amax(dim=-1, keepdim=True) * (1.0 - TIED)
    cand = torch.where(gov, rows.stress_mean.double().cpu() * scf, torch.nan)
    d = (mean.double().cpu()[..., None] - cand).abs().nan_to_num(torch.inf)
    return float(d.amin(dim=-1).max() / cand.nan_to_num(0.0).abs().max())


def sea_phase(pt, hk, dev, coarse64, refined64, prep32, prep64, cpu,
              per_scan):
    """The random-sea scan (``sea_scan_prepared``) of the flagship mesh:
    JONSWAP Hs 6.5 m, Tp 9.4 s, 64 components, U_c 1 m/s, Wheeler, 2,048
    samples at Tp / 10 (the half hour of the JAX package's example), on
    the f32 handle and on the f64 one, each with its launch counts read
    around exactly that call (one K1-sea launch, the scan's sweeps);
    f32 against f64; equilibrium; the f64 scan at 256 samples against the
    port's CPU f64 run of the same call (1e-9); the spread sea (s = 4, 256
    samples) likewise; the spectral fatigue screen of the f64 history;
    each call's time, device operations, busy time and peak memory."""
    import torch
    f32, f64 = torch.float32, torch.float64
    case = pt.LoadCase(**CASE)
    ts = torch.arange(SEA_STEPS, dtype=f64) * SEA_TP / 10.0
    out, rec = {"launches": {}}, {}

    def sea(dtype, device, spread=None):
        return pt.make_random_sea(SEA_HS, SEA_TP, SEA_D, n_components=SEA_N,
                                  seed=0, U_c=SEA_UC, spreading_s=spread,
                                  dtype=dtype, device=device)

    def scan(prep, s, n=SEA_STEPS):
        return pt.sea_scan_prepared(prep, s, case, ts[:n],
                                    stretching="wheeler")
    runs = {}
    for label, prep, dtype, key in (("sea scan f32", prep32, f32, "sea_f32"),
                                    ("sea scan f64", prep64, f64, "sea_f64")):
        s = sea(dtype, dev)
        res, n, first = counted(hk, lambda: scan(prep, s))
        out["launches"][label] = n
        check(same_counts(n, {"sweep": per_scan, key: 1}), f"{label}: "
              f"kernel launches {n} (one {key} launch, {per_scan} sweeps)")
        check(tuple(res.U.shape) == (SEA_STEPS, refined64.n_dof)
              and all(bool(torch.isfinite(getattr(res, f)).all())
                      for f in ("U", "von_mises", "reactions",
                                "total_morison")),
              f"{label}: U {tuple(res.U.shape)}, all fields finite")
        rec[label] = call_record(lambda: scan(prep, s))
        rec[label]["first_s"] = first
        runs[label] = res
    s32, s64 = runs["sea scan f32"], runs["sea scan f64"]
    # the samples at which a Gauss point lies within hk.SURFACE_BAND of the
    # f64 surface: there f32 rounding can flip the point wet / dry (a jump
    # of its whole share), and each sample's solve is its own
    near = hk.surface_band(sea(f64, dev), refined64.coords, refined64.conn,
                           CASE["wave_dir_deg"],
                           ts.to(f64).to(dev)).any(dim=1)
    keep = ~near

    def f32_errs(k):
        return {"U": rel(s32.U[k], s64.U[k]),
                "utilization": rel(s32.utilization[k], s64.utilization[k]),
                "max utilization": abs(float(s32.utilization[k].max())
                                       / float(s64.utilization[k].max())
                                       - 1.0),
                "total_morison": rel(s32.total_morison[k],
                                     s64.total_morison[k])}
    errs, errs_off = f32_errs(slice(None)), f32_errs(keep)
    out["f32_errs"], out["f32_errs_off_band"] = errs, errs_off
    out["band_samples"] = int(near.sum())
    print(f"[sea] f32 scan vs f64 scan ({SEA_STEPS} samples): "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f"; the {int(keep.sum())} samples with no Gauss point within "
          f"{hk.SURFACE_BAND:g} m of the surface: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs_off.items())
          + f"; max utilization {float(s64.utilization.max()):.6f} at "
          f"t = {float(s64.ts[s64.critical_index]):.2f} s", flush=True)
    check(errs_off["U"] <= U_TOL and errs_off["utilization"] <= UTIL_TOL
          and errs_off["max utilization"] <= MAX_UTIL_TOL
          and errs_off["total_morison"] <= SEA_F32_TOTAL_TOL,
          f"f32 sea scan vs f64 off the surface band: U "
          f"{errs_off['U']:.2e} <= {U_TOL:g}, utilization "
          f"{errs_off['utilization']:.2e} <= {UTIL_TOL:g}, its maximum "
          f"{errs_off['max utilization']:.2e} <= {MAX_UTIL_TOL:g}, Morison "
          f"totals {errs_off['total_morison']:.2e} <= "
          f"{SEA_F32_TOTAL_TOL:g}")
    check(errs["U"] <= SEA_F32_U_TOL
          and errs["utilization"] <= SEA_F32_UTIL_TOL
          and errs["max utilization"] <= MAX_UTIL_TOL,
          f"f32 sea scan vs f64, every sample: U {errs['U']:.2e} <= "
          f"{SEA_F32_U_TOL:g}, utilization {errs['utilization']:.2e} <= "
          f"{SEA_F32_UTIL_TOL:g}, its maximum {errs['max utilization']:.2e} "
          f"<= {MAX_UTIL_TOL:g}")
    eq32, eq64 = scan_equilibrium(pt, s32, dev), scan_equilibrium(pt, s64,
                                                                  dev)
    out["equilibrium"] = (eq32, eq64)
    check(eq32 < EQ_TOL_F32 and eq64 < EQ_TOL_F64, f"sea scan equilibrium: "
          f"f32 {eq32:.2e} < {EQ_TOL_F32:g}, f64 {eq64:.2e} < {EQ_TOL_F64:g}")

    # the card against the port's CPU f64 run of the same call
    out["cpu"] = {}
    for label, spread in (("sea scan", None), ("spread sea scan",
                                               SPREADING_S)):
        s_card = sea(f64, dev, spread)
        if spread is not None:
            res, n, _ = counted(hk, lambda: scan(prep32, sea(f32, dev,
                                                             spread),
                                                 SPREAD_STEPS))
            out["launches"]["spread sea scan f32"] = n
            check(same_counts(n, {"sweep": per_scan, "sea_f32": 1}),
                  f"spread sea scan f32: kernel launches {n}")
            rec["spread sea scan f32"] = call_record(
                lambda: scan(prep32, sea(f32, dev, spread), SPREAD_STEPS))
        card = scan(prep64, s_card, SEA_CHECK_STEPS)
        t0 = time.perf_counter()
        ref = scan(cpu["prep"], sea(f64, "cpu", spread), SEA_CHECK_STEPS)
        cpu_s = time.perf_counter() - t0
        e = {f: rel(getattr(card, f).cpu(), getattr(ref, f))
             for f in ("U", "von_mises", "reactions", "total_morison")}
        out["cpu"][label] = e
        print(f"[sea] {label} f64, {SEA_CHECK_STEPS} samples, card vs CPU "
              f"(CPU run {cpu_s:.2f} s): "
              + ", ".join(f"{k} {v:.2e}" for k, v in e.items()), flush=True)
        check(max(e.values()) <= SEA_TOL, f"{label} card vs CPU f64: "
              f"{max(e.values()):.2e} <= {SEA_TOL:g}")

    # the spectral fatigue screen of the f64 history (host numpy)
    t0 = time.perf_counter()
    scr = pt.spectral_fatigue_screen(s64.von_mises, SEA_TP / 10.0, 25.0)
    out["screen_s"] = time.perf_counter() - t0
    out["counter"] = "native" if pt.native.available() else "Python"
    out["max_damage"] = (float(scr.damage_rainflow.max()),
                         float(scr.damage_rayleigh.max()))
    check(bool(torch.isfinite(scr.damage_rainflow).all())
          and bool((scr.damage_rainflow >= 0).all())
          and out["max_damage"][0] > 0,
          f"spectral fatigue screen of the f64 history: 25-year damage "
          f"rainflow {out['max_damage'][0]:.3e}, Rayleigh "
          f"{out['max_damage'][1]:.3e} ({out['counter']} rainflow counter, "
          f"{out['screen_s']:.2f} s)")
    out["rec"] = rec
    return out


def freq_phase(pt, hk, dev, coarse64, refined64, prep64, cpu, per_scan):
    """The frequency domain at 9,612 DOF in f64: ``spectral_response_
    prepared`` (64 components: 129 transfer rows in one condensed solve)
    and ``spectral_response_dynamic`` (12 chain modes; the Craig-Bampton
    reduction and modal basis built in the counted call), each with its
    launch counts read around exactly that call; the quasi-static response
    at refine 8 against the port's CPU f64 run (1e-9), the dynamic one at
    9,612 DOF against it at phase 15's limits for 12 chain modes (U rows 1e-9,
    stresses 1e-7); mean and MPM stresses against one of the tied
    governing points (:func:`tie_err`).  Returns the records."""
    import torch
    from small_fem_solver_tpu_torch import api
    f64 = torch.float64
    case = pt.LoadCase(**CASE)
    out, rec = {"launches": {}}, {}

    def sea(device):
        return pt.make_random_sea(SEA_HS, SEA_TP, SEA_D, n_components=SEA_N,
                                  seed=0, U_c=SEA_UC, device=device)
    s_card = sea(dev)
    fd, n, _ = counted(hk, lambda: pt.spectral_response_prepared(
        prep64, s_card, case))
    out["launches"]["spectral_response"] = n
    check(same_counts(n, {"sweep": per_scan}), f"spectral_response_prepared: "
          f"kernel launches {n} (one {2 * SEA_N + 1}-row condensed solve)")
    rec["spectral response"] = call_record(
        lambda: pt.spectral_response_prepared(prep64, s_card, case))

    def cold_dynamic(c, r, s, prep):
        api._CB_CACHE.clear()
        api._MODAL_CACHE.clear()
        return pt.spectral_response_dynamic(c, r, N_SEG, s, case,
                                            n_chain_modes=CHAIN_MODES,
                                            prep=prep)
    dyn, n, _ = counted(hk, lambda: cold_dynamic(coarse64, refined64, s_card,
                                                 prep64))
    out["launches"]["spectral_response_dynamic"] = n
    check(same_counts(n, {"sweep": 10 + per_scan}), f"spectral_response_"
          f"dynamic: kernel launches {n} (10 chain-mode sweeps, then the "
          "static transfer's)")
    rec["spectral response dynamic"] = call_record(
        lambda: cold_dynamic(coarse64, refined64, s_card, prep64))
    for label, r in (("quasi-static", fd), ("dynamic", dyn)):
        check(all(bool(torch.isfinite(getattr(r, f)).all())
                  for f in ("sigma_stress", "damage_wl", "mpm_utilization")),
              f"spectral response ({label}) finite")
    out["daf_sigma"] = float(dyn.sigma_stress.max() / fd.sigma_stress.max())
    print(f"[freq] {refined64.n_dof} DOF: max stress std quasi-static "
          f"{float(fd.sigma_stress.max()):.4f} MPa, dynamic "
          f"{float(dyn.sigma_stress.max()):.4f} MPa; max MPM utilization "
          f"{float(fd.mpm_utilization.max()):.6f} / "
          f"{float(dyn.mpm_utilization.max()):.6f}; 1-year W-L damage "
          f"{float(fd.damage_wl.max()):.3e} / "
          f"{float(dyn.damage_wl.max()):.3e}",
          flush=True)

    # quasi-static at refine 8, card vs CPU
    invariant = ("sigma_stress", "nu0_hz", "bandwidth_alpha2", "damage_nb",
                 "damage_wl", "sigma_disp_mm", "mpm_disp_mm",
                 "sigma_base_shear_N", "sigma_otm_Nm", "mpm_otm_Nm")
    fd8 = pt.spectral_response_prepared(cpu["prep8_card"], s_card, case)
    s_cpu = sea("cpu")
    ref8 = pt.spectral_response_prepared(cpu["prep8"], s_cpu, case)
    rows8 = pt.spectral_transfer_prepared(cpu["prep8"], s_cpu, case)
    e = {f: rel(getattr(fd8, f).cpu(), getattr(ref8, f)) for f in invariant}
    e["mean_stress (tied points)"] = tie_err(fd8.mean_stress, rows8)
    e["mpm_stress - |mean|"] = rel(
        (fd8.mpm_stress - fd8.mean_stress.abs()).cpu(),
        ref8.mpm_stress - ref8.mean_stress.abs())
    out["fd8_errs"] = e
    print("[freq] spectral_response_prepared at refine 8, card vs CPU: "
          + ", ".join(f"{k} {v:.2e}" for k, v in e.items()), flush=True)
    check(max(e.values()) <= FD_TOL, f"spectral response at refine 8 card "
          f"vs CPU f64: {max(e.values()):.2e} <= {FD_TOL:g}")

    # dynamic at 9,612 DOF, card vs CPU
    t0 = time.perf_counter()
    ref = cold_dynamic(cpu["coarse"], cpu["refined"], s_cpu, cpu["prep"])
    rows = pt.spectral_transfer_dynamic(
        cpu["coarse"], cpu["refined"], N_SEG, s_cpu, case,
        n_chain_modes=CHAIN_MODES, prep=cpu["prep"])
    cpu_s = time.perf_counter() - t0
    e_u = {f: rel(getattr(dyn, f).cpu(), getattr(ref, f))
           for f in ("sigma_disp_mm", "mpm_disp_mm", "sigma_base_shear_N",
                     "sigma_otm_Nm")}
    e_s = {f: rel(getattr(dyn, f).cpu(), getattr(ref, f))
           for f in ("sigma_stress", "nu0_hz", "damage_nb", "damage_wl")}
    e_s["mean_stress (tied points)"] = tie_err(dyn.mean_stress, rows)
    out["dyn_errs"] = (e_u, e_s)
    print(f"[freq] spectral_response_dynamic at {refined64.n_dof} DOF, card "
          f"vs CPU (CPU runs {cpu_s:.2f} s): "
          + ", ".join(f"{k} {v:.2e}" for k, v in {**e_u, **e_s}.items()),
          flush=True)
    check(max(e_u.values()) <= HARMONIC_TOL
          and max(e_s.values()) <= UTIL_DYN_TOL,
          f"spectral_response_dynamic card vs CPU f64: displacement and "
          f"force rows {max(e_u.values()):.2e} <= {HARMONIC_TOL:g}, stresses "
          f"{max(e_s.values()):.2e} <= {UTIL_DYN_TOL:g} (12 chain modes)")
    out["rec"] = rec
    return out


def scatter_phase(pt, hk, dev, coarse64, refined64, prep64, cpu, per_scan):
    """Scatter fatigue: the JAX bench's frequency-domain diagram
    (``bench.py:266-317``: refine 8, f32 handle, its 10 and 40 states, 32
    components, d = 50 m, 25 years), ms per state and the marginal ms per
    state; the dynamic diagram of the 10 states at 9,612 DOF in f64 and
    ``long_term_extremes`` on it; the quasi-static diagram of 3 states at
    refine 8 in f64 against the port's CPU run (damages 1e-9, means and
    MPM to a tied governing point); the time-domain ``scatter_fatigue`` at
    9,612 DOF (48 components, 1,024 steps, Wheeler) over 4 of the bench's
    states; launch counts around each call.  Returns the records."""
    import torch
    from small_fem_solver_tpu_torch import api
    f32 = torch.float32
    case = pt.LoadCase(**CASE)
    out, rec = {"launches": {}}, {}
    c32 = pt.default_3leg_jacket(dtype=f32, device=dev)
    r32 = pt.refine_model(c32, 8)
    prep8 = pt.prepare_condensed(c32, r32, 8, solve_dtype=f32)

    def bench(ss):
        return pt.scatter_fatigue_spectral(prep8, case, ss, SEA_D, 25.0,
                                           n_components=32)
    one, n1, _ = counted(hk, lambda: bench(SCATTER_STATES[:1]))
    r10, n10, _ = counted(hk, lambda: bench(SCATTER_STATES))
    out["launches"]["scatter bench (10 states)"] = n10
    check(same_counts(n10, {"sweep": 10 * n1["sweep"]}) and n1["sweep"] > 0,
          f"bench scatter: kernel launches {n10} for 10 states ({n1} for "
          "one)")
    check(bool(torch.isfinite(r10.damage_wl).all())
          and float(r10.damage_wl.max()) > 0, "bench scatter damages finite")
    bench(SCATTER_STATES40)
    best10 = best40 = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        bench(SCATTER_STATES)
        torch.cuda.synchronize()
        best10 = min(best10, time.perf_counter() - t0)
        t0 = time.perf_counter()
        bench(SCATTER_STATES40)
        torch.cuda.synchronize()
        best40 = min(best40, time.perf_counter() - t0)
    out["bench"] = dict(
        ms_per_state=best10 / len(SCATTER_STATES) * 1e3,
        marginal_ms_per_state=(best40 - best10)
        / (len(SCATTER_STATES40) - len(SCATTER_STATES)) * 1e3,
        best10_s=best10, best40_s=best40, n_dof=r32.n_dof,
        max_damage_wl=float(r10.damage_wl.max()))
    rec["scatter bench (10 states)"] = call_record(
        lambda: bench(SCATTER_STATES))
    print(f"[scatter] {SMI}: spectral scatter fatigue (bench.py config): "
          f"{len(SCATTER_STATES)} states x {2 * 32 + 1} transfer rows @ "
          f"{r32.n_dof} DOF f32 = {out['bench']['ms_per_state']:.2f} ms/state "
          f"(marginal {out['bench']['marginal_ms_per_state']:.2f} ms/state "
          f"from the 40-state climate; best of 3, host clock); max 25-y W-L "
          f"damage {out['bench']['max_damage_wl']:.3e}", flush=True)

    # the dynamic diagram at 9,612 DOF in f64, then the long-term extremes
    def dynamic_scatter():
        api._CB_CACHE.clear()
        api._MODAL_CACHE.clear()
        return pt.scatter_fatigue_spectral(
            prep64, case, SCATTER_STATES, SEA_D, 25.0, n_components=32,
            dynamic=True, n_chain_modes=CHAIN_MODES)
    rdyn, n, _ = counted(hk, dynamic_scatter)
    out["launches"]["scatter dynamic (10 states)"] = n
    check(same_counts(n, {"sweep": 10 + 10 * per_scan}), f"dynamic scatter: "
          f"kernel launches {n} (10 chain-mode sweeps, then {per_scan} a "
          "state)")
    rec["scatter dynamic (10 states)"] = call_record(dynamic_scatter)
    t0 = time.perf_counter()
    lt = pt.long_term_extremes(rdyn, return_years=(1.0, 100.0))
    out["extremes_s"] = time.perf_counter() - t0
    out["extremes"] = [float(v) for v in lt.utilization.max(axis=1)]
    check(bool(torch.isfinite(rdyn.damage_wl).all())
          and all(v > 0 for v in out["extremes"])
          and out["extremes"][1] >= out["extremes"][0],
          f"dynamic scatter finite; long-term 1 / 100-year utilization "
          f"{out['extremes'][0]:.6f} <= {out['extremes'][1]:.6f}")
    out["dyn_damage"] = (float(rdyn.damage_wl.max()),
                         float(rdyn.mpm_utilization.max()))
    print(f"[scatter] dynamic diagram at {refined64.n_dof} DOF f64: max 25-y "
          f"W-L damage {out['dyn_damage'][0]:.3e}, max MPM utilization "
          f"{out['dyn_damage'][1]:.6f}; 1 / 100-year utilization "
          + " / ".join(f"{v:.6f}" for v in out["extremes"]), flush=True)

    # quasi-static diagram of 3 states at refine 8 in f64, card vs CPU
    states3 = SCATTER_STATES[:3]
    kw = dict(n_components=32)
    card = pt.scatter_fatigue_spectral(cpu["prep8_card"], case, states3,
                                       SEA_D, 25.0, **kw)
    ref = pt.scatter_fatigue_spectral(cpu["prep8"], case, states3, SEA_D,
                                      25.0, **kw)
    e = {f: rel(torch.as_tensor(getattr(card, f)),
                torch.as_tensor(getattr(ref, f)))
         for f in ("damage_nb", "damage_wl", "per_state_wl",
                   "per_state_sigma", "per_state_nu0")}
    mean_e = 0.0
    for i, row in enumerate(states3):
        s = pt.make_random_sea(row[0], row[1], SEA_D, n_components=32,
                               seed=i, device="cpu")
        rows = pt.spectral_transfer_prepared(
            cpu["prep8"], s, pt.LoadCase(**{**CASE, "wave_dir_deg": row[3],
                                            "current_dir_deg": row[3]}))
        mean_e = max(mean_e, tie_err(torch.as_tensor(
            card.per_state_mean[i]), rows))
    e["per_state_mean (tied points)"] = mean_e
    # MPM utilization: each state's |mean| + sigma sqrt(2 ln(nu0 T)) over
    # fy, the largest over the states (the card's means, the CPU's sigma
    # and nu0)
    g = torch.sqrt(2.0 * torch.log(torch.clamp(
        torch.as_tensor(ref.per_state_nu0) * 3.0 * 3600.0, min=1.0 + 1e-9)))
    mpm = ((torch.as_tensor(card.per_state_mean).abs()
            + torch.as_tensor(ref.per_state_sigma) * g) / float(case.fy))
    e["mpm_utilization"] = rel(card.mpm_utilization.cpu(),
                               mpm.amax(dim=0))
    out["cpu_errs"] = e
    print("[scatter] quasi-static diagram, 3 states at refine 8 f64, card vs "
          "CPU: " + ", ".join(f"{k} {v:.2e}" for k, v in e.items()),
          flush=True)
    check(max(e.values()) <= FD_TOL, f"scatter at refine 8 card vs CPU f64: "
          f"{max(e.values()):.2e} <= {FD_TOL:g}")

    # the time-domain diagram at 9,612 DOF
    states4 = SCATTER_STATES[:TD_STATES]

    def time_domain():
        return pt.scatter_fatigue(prep64, case, states4, SEA_D, 25.0)
    td, n, first = counted(hk, time_domain)
    out["launches"]["scatter time domain (4 states)"] = n
    check(same_counts(n, {"sweep": TD_STATES * per_scan,
                          "sea_f64": TD_STATES}),
          f"time-domain scatter: kernel launches {n} (one K1-sea launch a "
          "state)")
    rec["scatter time domain (4 states)"] = call_record(time_domain)
    rec["scatter time domain (4 states)"]["first_s"] = first
    out["td_damage"] = (float(td.damage_rainflow.max()),
                        float(td.damage_rayleigh.max()))
    check(bool(torch.isfinite(td.damage_rainflow).all())
          and out["td_damage"][0] > 0
          and td.per_state_rainflow.shape == (TD_STATES, refined64.n_members),
          f"time-domain scatter: max 25-y damage rainflow "
          f"{out['td_damage'][0]:.3e}, Rayleigh {out['td_damage'][1]:.3e} "
          f"({'native' if pt.native.available() else 'Python'} rainflow "
          "counter)")
    out["rec"] = rec
    return out


def sea_transient_phase(pt, hk, dev, coarse64, refined64, cpu):
    """``transient_response_condensed`` driven by the random sea (64
    components, dt 0.1 s, 1,024 steps ramped over one Tp, 12 chain
    modes, f64) and its relative-drag variant (256 steps, 2 passes), each
    with its launch counts read around exactly that call (one K1-sea
    launch, 10 sweeps) and against the port's CPU f64 run of the same call
    (U 1e-9, utilization 1e-7: phase 15's limits at 12 chain modes).  Returns
    the records."""
    import torch
    case = pt.LoadCase(**CASE)
    out, rec = {"launches": {}}, {}

    def run(c, r, device, **kw):
        s = pt.make_random_sea(SEA_HS, SEA_TP, SEA_D, n_components=SEA_N,
                               seed=0, U_c=SEA_UC, device=device)
        return pt.transient_response_condensed(
            c, r, N_SEG, s, case, dt=0.1, ramp_periods=1.0, **kw)
    for label, kw in (("sea transient", dict(n_steps=SEA_TRANSIENT_STEPS)),
                      ("sea transient relative drag",
                       dict(n_steps=256, relative_drag=True,
                            drag_iterations=2))):
        card, n, first = counted(hk, lambda: run(coarse64, refined64, dev,
                                                 **kw))
        out["launches"][label] = n
        check(same_counts(n, {"sweep": 10, "sea_f64": 1}),
              f"{label}: kernel launches {n}")
        rec[label] = call_record(lambda: run(coarse64, refined64, dev, **kw))
        rec[label]["first_s"] = first
        t0 = time.perf_counter()
        ref = run(cpu["coarse"], cpu["refined"], "cpu", **kw)
        cpu_s = time.perf_counter() - t0
        e = {f: rel(getattr(card, f).cpu(), getattr(ref, f))
             for f in ("U_time", "utilization", "tip_displacement_mm")}
        out[label] = e
        print(f"[sea transient] {label} ({kw['n_steps']} steps): max tip "
              f"{float(card.tip_displacement_mm.max()):.3f} mm, max "
              f"utilization {float(card.utilization.max()):.6f}; card vs CPU "
              f"(CPU run {cpu_s:.2f} s): "
              + ", ".join(f"{k} {v:.2e}" for k, v in e.items()), flush=True)
        check(bool(torch.isfinite(card.U_time).all())
              and max(e["U_time"], e["tip_displacement_mm"]) <= TRANSIENT_TOL
              and e["utilization"] <= UTIL_DYN_TOL,
              f"{label} card vs CPU f64: U {e['U_time']:.2e}, tip "
              f"{e['tip_displacement_mm']:.2e} <= {TRANSIENT_TOL:g}, "
              f"utilization {e['utilization']:.2e} <= {UTIL_DYN_TOL:g}")
    out["steps_per_s"] = SEA_TRANSIENT_STEPS / rec["sea transient"]["s"]
    out["rec"] = rec
    return out


def bit_equal(a, b) -> bool:
    """Bit equality of two result trees (tensors, arrays, NamedTuples)."""
    import numpy as np
    import torch
    if a is None or b is None:
        return a is b
    if isinstance(a, torch.Tensor):
        return (a.shape == b.shape and a.dtype == b.dtype
                and bool(torch.equal(a, b.to(a.device))))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bit_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def tree_rel(a, b) -> float:
    """The largest ``rel`` over the tensor fields of two NamedTuples."""
    import torch
    return max(rel(x.double(), y.double()) for x, y in zip(a, b)
               if isinstance(x, torch.Tensor) and x.is_floating_point())


def k1_f32_bound(S: int, M: int, Q: int, N: int, n_nodes: int):
    """(bound us, by, bytes, FLOPs) of one launch of K1's f32 instance:
    its outputs (end forces, totals) written once and its inputs (phases,
    wave modes, nodes, per-member data) read once; the mode sums ([S, 2N]
    phase factors times [2N, M Q] spatial records for five fields) and the
    elementwise epilogue at the FP32 rate."""
    nbytes = 4 * (2 * S * M * 3 + S * 6 + S + 2 * N + 4 + n_nodes * 3
                  + M) + 8 * 2 * M
    flops = S * M * Q * (2 * 2 * N * 5 + EPILOGUE_FLOP)
    return (*bound_us(nbytes, flops), nbytes, flops)

def k1_f32_batch_bound(C: int, S: int, M: int, Q: int, N: int,
                       n_nodes: int):
    """(bound us, by, bytes, FLOPs) of one launch of K1's case-batched f32
    instance: :func:`k1_f32_bound`'s function for C cases (the FLOPs, the
    outputs and the per-case inputs C times, the nodes and members once)."""
    nbytes = 4 * (C * (2 * S * M * 3 + S * 6 + S + 2 * N + 4 + 3 * M)
                  + n_nodes * 3) + 8 * 2 * M
    flops = C * S * M * Q * (2 * 2 * N * 5 + EPILOGUE_FLOP)
    return (*bound_us(nbytes, flops), nbytes, flops)


def k1_f32_batch_phase(pt, hk, dev, dense_b, n_nodes: int) -> dict:
    """K1's case-batched f32 instance at the dense envelope's shapes (the
    1,000 design cases in ONE launch: 36 phases, 51 members, Stokes-5 with
    8 modes, per-case headings, per-(case, member) Cd, per-case Cm), with
    and without Wheeler, against the plain version in f64 on the same
    (f32-rounded) inputs (1e-5 of each output's maximum; the plain version
    100 cases at a time): one ``f32_batch`` launch a call, bit-repeatable,
    blocks of cases launched alone (one case, a mid-batch block, the last
    case) bit-equal to the whole batch's; the build report of its
    instances (no spill, no HMMA); its device time (fused pass + totals)
    beside its bound, the wrapper's time and the plain f32 version's."""
    import torch
    from small_fem_solver_tpu_torch.ops.morison import (
        morison_end_forces_batch)
    f32, f64 = torch.float32, torch.float64
    build = build_report_check(
        hk, "K1 f32 batch", r"morison_f32_batch_(kernel|totals_kernel)"
        r"(?:ILi(\d+)ELb([01])E)?",
        lambda m: (f"fused NMAX={m[2]} wheeler={m[3]}" if m[1] == "kernel"
                   else "totals"), (16, 1), lambda lab: False)
    a32 = (*hk.cast_operands(f32, dev, *dense_b[:2]), dense_b[2],
           *hk.cast_operands(f32, dev, *dense_b[3:]))
    a64 = (*hk.cast_operands(f64, dev, *a32[:2]), a32[2],
           *hk.cast_operands(f64, dev, *a32[3:]))
    C, S = a32[-1].shape
    M, N = a32[2].shape[0], a32[0].n_modes

    def cases(args, lo, hi):
        return (args[0].case(slice(lo, hi)), *args[1:4],
                *(x[lo:hi] if torch.is_tensor(x) and x.ndim
                  and x.shape[0] == C else x for x in args[4:]))
    names = ("F1", "F2", "total_drag", "total_inertia")
    out = {"abs": 0.0, "rel": 0.0, "build": build, "shapes": {}}
    for stretching in ("none", "wheeler"):
        kw = dict(stretching=stretching, n_gauss=N_GAUSS)

        def call():
            return hk.morison_end_forces_batch_cuda(*a32, **kw)
        before = hk.launch_counts()
        res = call()
        again = call()
        torch.cuda.synchronize()
        n = {k: v - before[k] for k, v in hk.launch_counts().items()}
        ref = [torch.cat(x) for x in zip(*(
            morison_end_forces_batch(*cases(a64, c0, min(C, c0 + 100)), **kw)
            for c0 in range(0, C, 100)))]
        errs = {f: rel(a, b) for f, a, b in zip(names, res, ref)}
        tag = f"C={C} S={S} M={M} N={N}, {stretching}"
        print(f"[kernel f32 batch] {tag}: max rel err "
              + " ".join(f"{f}={e:.2e}" for f, e in errs.items()),
              flush=True)
        check(n["f32_batch"] == n["k1"] == 2 and n["f32"] == 0
              and res[0].dtype == f32
              and tuple(res[0].shape) == (C, S, M, 3), f"K1 f32 batch "
              f"instance: {n['f32_batch']} launches for 2 calls, no per-case "
              f"f32 launch ({tag})")
        check(all(torch.isfinite(r).all() for r in res),
              f"K1 f32 batch outputs finite ({tag})")
        check(max(errs.values()) <= KERNEL_TOL, f"K1 f32 batch vs f64 plain "
              f"({tag}): {max(errs.values()):.2e} <= {KERNEL_TOL:g}")
        check(all(torch.equal(a, b) for a, b in zip(res, again)),
              f"K1 f32 batch bit-repeatable ({tag})")
        for lo, hi in ((0, 1), (517, 531), (C - 1, C)):
            blk = hk.morison_end_forces_batch_cuda(*cases(a32, lo, hi), **kw)
            check(all(torch.equal(a[lo:hi], b) for a, b in zip(res, blk)),
                  f"K1 f32 batch: cases {lo}-{hi - 1} launched alone "
                  f"bit-equal to the whole batch's ({tag})")
        out["rel"] = max(out["rel"], max(errs.values()))
        out["abs"] = max(out["abs"], *(float((a.double() - b).abs().max())
                                       for a, b in zip(res[:2], ref[:2])))
        ev = device_events(call, 10)
        us = {k: kernel_median_us(ev, k) for k in F32_BATCH_KERNELS}
        bound = k1_f32_batch_bound(C, S, M, N_GAUSS, N, n_nodes)
        rec = {"device_us": us, "total_us": sum(us.values()),
               "bound_us": bound[0], "bound_by": bound[1],
               "gflop": bound[3] / 1e9, "mb": bound[2] / 1e6,
               "ms": cuda_ms(call, n=10), "max_rel_err": max(errs.values())}
        rec["share"] = bound[0] / rec["total_us"]
        if stretching == "none":
            rec["plain_ms"] = cuda_ms(
                lambda: morison_end_forces_batch(*a32, **kw), n=3, warmup=1)
        out["shapes"][stretching] = rec
        print(f"[bound] {SMI}: K1 f32 batch {tag}: "
              f"{us[F32_BATCH_KERNELS[0]]:.1f} + "
              f"{us[F32_BATCH_KERNELS[1]]:.1f} us on the device (fused + "
              f"totals); bound {bound[0]:.1f} us by {bound[1]} "
              f"({bound[3] / 1e9:.2f} GFLOP at 67 TFLOP/s, "
              f"{bound[2] / 1e6:.1f} MB): {rec['share']:.1%} of the bound; "
              f"wrapper {rec['ms']:.3f} ms"
              + (f", plain f32 {rec['plain_ms']:.3f} ms"
                 if "plain_ms" in rec else "")
              + " (torch.profiler, CUDA events)", flush=True)
    return out


def pointwise_bound(itemsize: int, S: int, M: int, Q: int, N: int,
                    n_nodes: int):
    """(bound us, by, bytes, FLOPs) of one launch of the pointwise Morison
    kernel (the slam scan's options: exact acceleration, no stretching,
    slamming): its outputs (end forces, totals) written once and its
    inputs (phases, wave modes, nodes, members) read once; per (phase,
    point) ``POINTWISE_MODE_FLOP`` a mode (the harmonics by angle
    addition, the surface, its rise, u, w, du, dw) and
    ``POINTWISE_POINT_FLOP`` (its sincos, the forces, the slam term, the
    lever-rule sums) at the FP32 (FP64) rate of the instance."""
    nbytes = (itemsize * (2 * S * M * 3 + S * 6 + S + 2 * N + 4
                          + n_nodes * 3 + M) + 8 * 2 * M)
    flops = S * M * Q * (POINTWISE_MODE_FLOP * N + POINTWISE_POINT_FLOP)
    return (*bound_us(nbytes, flops, FP32_FLOP_PER_S if itemsize == 4
                      else FP64_FLOP_PER_S), nbytes, flops)


def pointwise_phase(pt, hk, dev, prep32) -> dict:
    """The pointwise Morison kernel at the slam scan's shapes (S 360, the
    9,612-DOF mesh's 1,632 members of the f32 handle ``prep32``, Q 15,
    Fenton N 18; exact acceleration, slamming Cs 5.15; scalars as 0-d
    tensors): its build (no tensor-core instruction), both instances
    against the plain version in f64 on the same f32-rounded operands (f32
    at ``KERNEL_TOL`` of the largest value off the pairs with a point
    within ``SURFACE_BAND`` of a jump, f64 at ``F64_LOADS_TOL``), one
    launch a call, bit-repeatable; each instance's device time (kernel +
    totals) beside its bound, the wrapper's time and the plain version's;
    then the slam scan itself (``phase_scan_prepared``, pointwise, on
    ``prep32``) with the launch counters reset to 0 before it: one
    pointwise launch, no K1 launch, and its time."""
    import re
    import torch
    from small_fem_solver_tpu_torch.ops.morison import (
        morison_pointwise_end_forces)
    f32, f64 = torch.float32, torch.float64
    refined32 = prep32.refined
    out = {"build": {}, "instances": {}}
    for name, r in hk.build_report("morison_pointwise").items():
        m = re.search(r"pointwise_loads_(kernel|totals_kernel)I([fd])"
                      r"(?:Lb([01])ELb([01])E)?", name)
        if m is None:
            continue
        lab = f"{m[1]} {'f32' if m[2] == 'f' else 'f64'}" + (
            f" fd={m[3]} wheeler={m[4]}" if m[3] else "")
        out["build"][lab] = {k: r.get(k) for k in (
            "registers", "stack", "spill_stores", "spill_loads", "DMMA",
            "HMMA")}
        print(f"[build] pointwise {lab}: {out['build'][lab]}", flush=True)
    check(len(out["build"]) == 10, f"pointwise library: 8 kernel instances "
          f"and 2 totals passes ({len(out['build'])})")
    check(all(v["DMMA"] == 0 and v["HMMA"] == 0
              for v in out["build"].values()),
          "no pointwise kernel issues a tensor-core instruction")
    S, M, N = N_STEPS, refined32.n_members, 18
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=N,
                        dtype=f32, device=dev)
    D = refined32.sections.D_outer[refined32.sect_id] / 1000.0
    ts = torch.arange(S, dtype=f32, device=dev) * wave.T / S

    def args(dtype):
        nums = tuple(torch.tensor(v, dtype=dtype, device=dev)
                     for v in (38.0, 38.0, 0.7, 2.0, 1025.0))
        return (wave.to(dtype, dev), refined32.coords.to(dtype),
                refined32.conn, D.to(dtype), *nums, ts.to(dtype))
    kw = dict(n_gauss=N_GAUSS, accel="analytic", stretching="none",
              slam_cs=5.15)
    ref = morison_pointwise_end_forces(*args(f64), **kw)
    far = ~hk.pointwise_band(wave, refined32.coords, refined32.conn, D,
                             38.0, ts, slam=True)
    names = ("F1", "F2", "total_drag", "total_inertia")
    for dtype, tol in ((f32, KERNEL_TOL), (f64, F64_LOADS_TOL)):
        a = args(dtype)
        tag = f"{str(dtype)[6:]} S={S} M={M} Q={N_GAUSS} N={N}"

        def call():
            return hk.morison_pointwise_end_forces_cuda(*a, **kw)
        hk.launch_counts(reset=True)
        res, again = call(), call()
        torch.cuda.synchronize()
        n = hk.launch_counts()
        errs = {}
        for f, x, y in zip(names, res, ref):
            if dtype == f32:
                keep = far if x.dim() == 3 else far.all(dim=1)
                x, y = x[keep], y[keep]
            errs[f] = rel(x, y)
        print(f"[pointwise] {tag}: max rel err " + " ".join(
            f"{f}={e:.2e}" for f, e in errs.items())
            + f" ({float(far.float().mean()):.1%} of the pairs off the "
            f"jumps)", flush=True)
        check(n["pointwise"] == 2 and n["k1"] == 0, f"pointwise kernel: "
              f"{n['pointwise']} launches for 2 calls, no K1 launch ({tag})")
        check(max(errs.values()) <= tol, f"pointwise kernel vs f64 plain "
              f"({tag}): {max(errs.values()):.2e} <= {tol:g}")
        check(all(torch.equal(x, y) for x, y in zip(res, again)),
              f"pointwise kernel bit-repeatable ({tag})")
        ev = device_events(call, 10)
        us = {k: kernel_median_us(ev, k) for k in (
            "pointwise_loads_kernel", "pointwise_loads_totals_kernel")}
        bound = pointwise_bound(a[1].element_size(), S, M, N_GAUSS, N,
                                refined32.n_nodes)
        rec = {"device_us": us, "total_us": sum(us.values()),
               "bound_us": bound[0], "bound_by": bound[1],
               "gflop": bound[3] / 1e9, "mb": bound[2] / 1e6,
               "ms": cuda_ms(call, n=10), "max_rel_err": max(errs.values()),
               "plain_ms": cuda_ms(lambda: morison_pointwise_end_forces(
                   *a, **kw), n=3, warmup=1)}
        rec["share"] = bound[0] / rec["total_us"]
        out["instances"][str(dtype)[6:]] = rec
        print(f"[bound] {SMI}: pointwise {tag}: "
              f"{us['pointwise_loads_kernel']:.1f} + "
              f"{us['pointwise_loads_totals_kernel']:.1f} us on the device "
              f"(kernel + totals); bound {bound[0]:.1f} us by {bound[1]} "
              f"({bound[3] / 1e9:.2f} GFLOP, {bound[2] / 1e6:.1f} MB): "
              f"{rec['share']:.1%} of the bound; wrapper {rec['ms']:.3f} ms, "
              f"plain {str(dtype)[6:]} {rec['plain_ms']:.3f} ms "
              f"(torch.profiler, CUDA events)", flush=True)

    # the slam scan on the main path, its launches read from a reset
    case = pt.LoadCase(**CASE, slam_cs=5.15)

    def scan():
        return pt.phase_scan_prepared(prep32, wave, case, S,
                                      kinematics="pointwise")
    scan()
    hk.launch_counts(reset=True)
    scan()
    torch.cuda.synchronize()
    n = hk.launch_counts()
    out["scan_launches"] = {k: n[k] for k in ("pointwise", "k1", "sweep")}
    check(n["pointwise"] == 1 and n["k1"] == 0, f"slam scan (f32, {S} "
          f"phases, Cs 5.15): {n['pointwise']} pointwise launch, "
          f"{n['k1']} K1 launches")
    out["scan_ms"] = cuda_ms(scan, n=10)
    print(f"[pointwise] {SMI}: slam scan {S} phases at {refined32.n_dof} "
          f"DOF (f32): launches {out['scan_launches']}, "
          f"{out['scan_ms']:.3f} ms a call (CUDA events)", flush=True)
    return out


def narrow_sweep_phase(pt, hk, dev, coarse64, refined64, large) -> dict:
    """The sweep kernel's narrow form on its paths' own operands: the
    99,882-DOF nested level 1 (B 1, 108 levels, 153 chains: the first
    sweep of ``analyze_prepared``) and the first sweep of the
    Craig-Bampton chain-mode iteration at 9,612 and 99,882 DOF (B 18, 31
    and 326 levels, 51 chains).  Each in f64 (the paths' dtype) against the
    plain sweep (1e-12); in f64 and on an f32 copy bit-equal column by
    column to a wide launch of 40 columns holding its own; bit-repeatable;
    its device time (warm, and with a cold L2 for level 1) beside
    ``sweep_bound`` and the dependent-step floor: 2 n_int steps x the
    latency of one step, measured here as the slope of the chain-mode
    sweep's device time between its two depths."""
    import torch
    from small_fem_solver_tpu_torch.ops import condense as condense_mod
    from small_fem_solver_tpu_torch.ops.condense import (ChainFactor,
                                                         chain_sweep_plain)
    f32, f64 = torch.float32, torch.float64

    def modal(refined, n_seg):
        return lambda: pt.modal_analysis_condensed(
            coarse64, refined, n_seg, n_modes=8, n_chain_modes=CHAIN_MODES,
            topside_mass_t=TOPSIDE_T)
    ops = {"99,882 DOF nested level 1": large["sweeps"][0],
           f"chain modes, n_int={N_SEG - 1}": first_sweep(
               condense_mod, hk, modal(refined64, N_SEG)),
           f"chain modes, n_int={N_SEG_LARGE - 1}": first_sweep(
               condense_mod, hk, modal(large["refined"], N_SEG_LARGE))}
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    out = {"abs": 0.0, "shapes": {}}
    for label, (fac, gs, split) in ops.items():
        g = gs.reshape(*gs.shape[:-3], -1, 6) if split else gs
        (n_int, C), B = fac.Cprime.shape[:2], hk.sweep_operand(gs, split)[1]
        tag = f"{label} (B={B}, n_int={n_int}, chains={C})"
        check(hk.sweep_narrow_rhs(B, n_int, 8) > 0 and fac.Dinv.dtype == f64,
              f"{tag}: f64, the narrow form "
              f"({hk.sweep_narrow_rhs(B, n_int, 8)} right-hand sides a warp)")
        ref = chain_sweep_plain(fac, g)
        got = hk.chain_sweep_cuda(fac, gs, split)
        again = hk.chain_sweep_cuda(fac, gs, split)
        err = max(rel(a, b) for a, b in zip(got, ref))
        # an f32 copy (these paths run in f64; the f32 narrow form is held
        # against the plain sweep on the flagship's f32 factors in phase 4)
        fac32 = ChainFactor(*(t.to(f32).contiguous() for t in fac))
        gs32 = gs.to(f32)
        got32 = hk.chain_sweep_cuda(fac32, gs32, split)
        torch.cuda.synchronize()
        check(err <= SWEEP_TOL_F64, f"narrow sweep {tag} vs the plain "
              f"sweep: f64 {err:.2e} <= {SWEEP_TOL_F64:g}")
        check(narrow_equals_wide(hk, fac, gs, split, got, 40)
              and narrow_equals_wide(hk, fac32, gs32, split, got32, 40),
              f"narrow sweep {tag}: bit-equal to the first {B} columns of a "
              "wide launch of 40, f64 and f32")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"narrow sweep bit-repeatable ({tag})")
        out["abs"] = max(out["abs"], *(float((a - b).abs().max())
                                       for a, b in zip(got, ref)))

        def call():
            return hk.chain_sweep_cuda(fac, gs, split)
        rec = {"B": B, "n_int": n_int, "chains": C, "max_rel_err": err,
               "device_us": kernel_us(device_events(call, SHORT_REPS),
                                      "chain_sweep_narrow"),
               "device_us_f32": kernel_us(device_events(
                   lambda: hk.chain_sweep_cuda(fac32, gs32, split),
                   SHORT_REPS), "chain_sweep_narrow"),
               "ms": cuda_ms(call),
               "plain_ms": cuda_ms(lambda: chain_sweep_plain(fac, g), n=5)}
        if B == 1:
            rec["device_us_cold"] = kernel_us(device_events(
                lambda: (l2_flush.zero_(), call()), SHORT_REPS),
                "chain_sweep_narrow")
        rec["bound_us"], rec["bound_by"], rec["bytes"] = sweep_bound(
            8, B, n_int, C)
        out["shapes"][label] = rec
    del l2_flush
    d31, d326 = (out["shapes"][f"chain modes, n_int={n}"]
                 for n in (N_SEG - 1, N_SEG_LARGE - 1))
    out["step_us"] = ((d326["device_us"] - d31["device_us"])
                      / (2 * (d326["n_int"] - d31["n_int"])))
    for label, rec in out["shapes"].items():
        rec["floor_us"] = 2 * rec["n_int"] * out["step_us"]
        print(f"[bound] {SMI}: narrow sweep f64 {label} (B={rec['B']}, "
              f"n_int={rec['n_int']}, chains={rec['chains']}): "
              f"{rec['device_us']:.2f} us on the device"
              + (f" ({rec['device_us_cold']:.2f} us with a cold L2)"
                 if "device_us_cold" in rec else "")
              + f", f32 {rec['device_us_f32']:.2f} us; bytes bound "
              f"{rec['bound_us']:.2f} us by {rec['bound_by']} "
              f"({rec['bytes'] / 1e6:.2f} MB): "
              f"{rec['bound_us'] / rec['device_us']:.1%}; dependent-step "
              f"floor {rec['floor_us']:.2f} us (2 x {rec['n_int']} steps x "
              f"{out['step_us'] * 1e3:.1f} ns, the chain-mode slope): "
              f"{rec['floor_us'] / rec['device_us']:.0%}; wrapper "
              f"{rec['ms']:.4f} ms, plain loop {rec['plain_ms']:.4f} ms "
              "(torch.profiler, CUDA events)", flush=True)
    return out


def host_us(fn, n: int = 300) -> float:
    """Host microseconds a call of ``fn`` (``n`` calls enqueued back to
    back after a warm-up, then one synchronisation)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


FR_BUFFER_VARS = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")
PROBE_HISTORY = 10000   # collectives between the probe's first two readings


def collective_host_probe() -> None:
    """Host microseconds a call of the distributed PCG's collectives (the
    99,882-DOF solution's ``all_gather_cat``, an ``ordered_sum`` of 3
    dots) in a single-rank NCCL group of this process, printed as one
    JSON line: fresh, after ``PROBE_HISTORY`` more collectives, and after
    a torch.profiler session (the smoke's own process has made ~12,000
    collectives and many profiler sessions when it reads them).
    :func:`collective_host_us` runs it in fresh processes, since c10d's
    flight recorder reads its buffer size once a process."""
    import tempfile
    import torch
    import torch.distributed as dist
    from small_fem_solver_tpu_torch.parallel import comm
    from small_fem_solver_tpu_torch.parallel import multihost as mh
    store = tempfile.mkdtemp(prefix="chip_smoke_probe_")
    mh.init_multihost(f"file://{store}/store", world_size=1, rank=0)
    try:
        mesh = mh.global_case_mesh("dof")
        x = torch.ones(N_DOF_LARGE, dtype=torch.float64,
                       device=torch.device("cuda", 0))
        dots = x[:3].clone()

        def read():
            return {"all_gather_cat": host_us(
                        lambda: comm.all_gather_cat(x, mesh, [x.numel()])),
                    "ordered_sum": host_us(
                        lambda: comm.ordered_sum(dots, mesh))}
        out = {"fresh": read()}
        for _ in range(PROBE_HISTORY):
            comm.ordered_sum(dots, mesh)
        torch.cuda.synchronize()
        out[f"after {PROBE_HISTORY} more"] = read()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            comm.ordered_sum(dots, mesh)
            torch.cuda.synchronize()
        out["after a profiler session"] = read()
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def collective_host_us() -> dict:
    """:func:`collective_host_probe` in two fresh processes, one after the
    other: c10d's flight recorder at PyTorch's default buffer size
    (``TORCH_FR_BUFFER_SIZE`` unset) and off (0)."""
    out = {}
    for label, size in (("flight recorder default", None),
                        ("flight recorder off", "0")):
        env = {k: v for k, v in os.environ.items()
               if k not in FR_BUFFER_VARS}
        if size is not None:
            env[FR_BUFFER_VARS[0]] = size
        p = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.collective_host_probe()"],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=300)
        check(p.returncode == 0, f"collective host probe ({label}) ran "
              f"(exit code {p.returncode})"
              + (f": {p.stderr[-2000:]}" if p.returncode else ""))
        out[label] = json.loads(p.stdout.strip().splitlines()[-1])
    return out


def pcg_per_iteration(pt, solve, iters=(PCG_PROFILE_ITERS,
                                        2 * PCG_PROFILE_ITERS)):
    """(device operations, busy us) an iteration of ``solve(n)``, a solve
    of exactly n iterations: the difference of two profiled solves of
    ``iters`` iterations, so the set-up (loads, assembly, coarse space)
    drops out."""
    import warnings
    rows = []
    for n in iters:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # stopped before tol
            ev = device_events(lambda: solve(n), host=False)
        rows.append((len(ev), sum(t for _, t in ev)))
    d = iters[1] - iters[0]
    return (rows[1][0] - rows[0][0]) / d, (rows[1][1] - rows[0][1]) / d


def k1_slice_check(pt, hk, dev, coarse64, waves_cpu, cases) -> dict:
    """K1's case-batched f64 instance on the second half of the 1,000-case
    batch (the block of rank 1 of 2; its first case is 500) at the dense
    envelope's shapes: against the plain version on the same inputs, and
    bit for bit against the same cases of the whole batch's launch."""
    import torch
    from small_fem_solver_tpu_torch.ops.morison import (
        morison_end_forces_batch)
    f64 = torch.float64
    waves = waves_cpu.to(f64, dev)
    C = waves.E.shape[0]
    lo = C // 2
    dirs = torch.as_tensor(cases.wave_dir_deg, dtype=f64, device=dev)
    ts = (torch.arange(DESIGN_STEPS, dtype=f64, device=dev)[None, :]
          * waves.T[:, None] / DESIGN_STEPS)
    D = coarse64.sections.D_outer[coarse64.sect_id] / 1000.0

    def args(sl):
        return (waves.case(sl), coarse64.coords, coarse64.conn, D, dirs[sl],
                dirs[sl], 0.7, 2.0, 1025.0, ts[sl])
    whole = hk.morison_end_forces_batch_cuda(*args(slice(0, C)))
    before = hk.morison_phase_batch_cuda.instance_launches["f64"]
    block = hk.morison_end_forces_batch_cuda(*args(slice(lo, C)))
    torch.cuda.synchronize()
    n = hk.morison_phase_batch_cuda.instance_launches["f64"] - before
    plain = morison_end_forces_batch(*args(slice(lo, C)))
    err = max(rel(a, b) for a, b in zip(block, plain))
    bits = all(torch.equal(a[lo:], b) for a, b in zip(whole, block))
    check(n == 1 and err <= 1e-12 and bits,
          f"K1 f64 on cases {lo}-{C - 1} of the {C}-case batch (one launch, "
          f"{n}): vs plain {err:.2e} <= 1e-12, bit-equal to the whole "
          f"batch's launch: {bits}")
    return {"err": err, "bits": bits}


def dist_one_rank_phase(pt, hk, dev, flag, design, large, pcgl):
    """The sharded paths in a single-rank NCCL group of this process
    (``parallel.multihost.init_multihost``, a 1-D DeviceMesh): the
    flagship condensed envelope (10 Fenton cases x 360 phases, f32, fused)
    bit-equal to the unsharded call with the same K1 and sweep launches;
    the 1,000-case f64 dense envelope in one K1 launch, bit-equal; the
    sweep and the frequency-domain scatter's states, bit-equal;
    ``analyze(solver="pcg", mesh=)`` at 99,882 DOF, the bench's call and
    the condensed loads' call: iterations within 1% of the single-device
    solve's, the utilization of the second within 1e-8 of
    ``analyze_condensed``, a second run bit-equal, the collectives, wall
    and busy time an iteration.  The group is destroyed at the end."""
    import tempfile
    import torch
    import torch.distributed as dist
    from small_fem_solver_tpu_torch.parallel import comm
    from small_fem_solver_tpu_torch.parallel import multihost as mh
    f32, f64 = torch.float32, torch.float64
    out = {"launches": {}, "pcg": {}}
    store = tempfile.mkdtemp(prefix="chip_smoke_group_")
    check(mh.init_multihost(f"file://{store}/store", world_size=1, rank=0)
          and dist.get_backend() == "nccl",
          "single-rank NCCL group initialised (init_multihost)")
    try:
        cases_mesh = mh.global_case_mesh("cases")
        dof_mesh = mh.global_case_mesh("dof")
        check(cases_mesh.size() == 1 and cases_mesh.device_type == "cuda",
              f"1-D CUDA DeviceMesh of {cases_mesh.size()} rank")

        env, n, s = counted(hk, lambda: pt.design_envelope_condensed(
            flag["coarse32"], flag["refined32"], N_SEG, flag["waves32"],
            flag["cases"], n_steps=N_STEPS, solve_dtype=f32,
            kinematics="fused", mesh=cases_mesh))
        out["launches"]["envelope"] = n
        want = flag["launches"]
        k1 = sum(v for k, v in n.items() if k != "sweep")
        check(bit_equal(tuple(env), tuple(flag["env"]))
              and k1 == want["morison_phase_batch"]
              and n["sweep"] == want["chain_sweep"],
              f"sharded flagship envelope (1 rank): bit-equal to the "
              f"unsharded call, launches K1 {k1} / sweep {n['sweep']} "
              f"== {want['morison_phase_batch']} / {want['chain_sweep']}")
        out["envelope_s"] = s

        waves_d = design["waves"].to(f64, dev)
        envd, n, s = counted(hk, lambda: pt.design_envelope(
            design["coarse64"], waves_d, design["cases"],
            n_steps=DESIGN_STEPS, mesh=cases_mesh))
        out["launches"]["dense_envelope"] = n
        check(same_counts(n, {"f64": 1})
              and bit_equal(tuple(envd), tuple(design["env"])),
              f"sharded 1,000-case dense envelope (1 rank): launches {n} "
              "(K1 f64 once), bit-equal to the unsharded call")

        def sweep(mesh):
            return pt.parallel.sweep.design_sweep(
                design["coarse64"], waves_d, design["cases"], mesh=mesh)
        sw, n, _ = counted(hk, lambda: sweep(cases_mesh))
        out["launches"]["sweep"] = n
        check(bit_equal(tuple(sw), tuple(sweep(None))),
              "sharded design_sweep (1 rank, 1,000 cases) bit-equal to "
              "the unsharded call")

        c32 = pt.default_3leg_jacket(dtype=f32, device=dev)
        prep8 = pt.prepare_condensed(c32, pt.refine_model(c32, 8), 8,
                                     solve_dtype=f32)

        def scatter(mesh):
            return pt.scatter_fatigue_spectral(
                prep8, pt.LoadCase(**CASE), SCATTER_STATES, SEA_D, 25.0,
                n_components=32, mesh=mesh)
        sc, n, _ = counted(hk, lambda: scatter(cases_mesh))
        out["launches"]["scatter"] = n
        check(bit_equal(tuple(sc), tuple(scatter(None))),
              f"sharded scatter (1 rank, {len(SCATTER_STATES)} states) "
              f"bit-equal to the unsharded call (launches {n})")

        refined, case, wave, cond = (large["refined"], large["case"],
                                     large["wave"], large["condensed"])
        for label, accel in (("bench (accel fd)", "fd"),
                             ("accel analytic", "analytic")):
            def solve(maxiter=3000, chunk=200):
                return pt.analyze(refined, wave, case, solver="pcg",
                                  accel=accel, pcg_precond="two_level",
                                  pcg_tol=1e-8, pcg_maxiter=maxiter,
                                  pcg_chunk=chunk, mesh=dof_mesh)
            comm.stats(reset=True)
            res, wall, ms = timed_call(solve)
            st = comm.stats(reset=True)
            again, wall2, ms2 = timed_call(solve)
            it = int(res.solver_iters)
            single = pcgl["runs"][(label, 1e-8)]["iters"]
            util = rel(res.utilization, cond.utilization)
            resid = true_residual(refined, res.U, res.F_applied)
            tag = f"distributed PCG (1 rank) at {refined.n_dof} DOF, {label}"
            check(abs(it / single - 1.0) <= 0.01
                  and abs(it / 1354 - 1.0) <= 0.01,
                  f"{tag}: {it} iterations within 1% of the single-device "
                  f"solve's {single} and of 1,354")
            check(float(res.solver_residual) <= 1e-8
                  and resid <= PCG_TRUE_RESID_LIMIT,
                  f"{tag}: solver's residual {float(res.solver_residual):.3e}"
                  f" <= 1e-8, recomputed {resid:.3e} <= "
                  f"{PCG_TRUE_RESID_LIMIT:g}")
            if accel == "analytic":
                check(util <= PCG_LARGE_UTIL_TOL_MATCHED,
                      f"{tag}: utilization vs analyze_condensed {util:.3e} "
                      f"<= {PCG_LARGE_UTIL_TOL_MATCHED:g}")
            check(int(again.solver_iters) == it
                  and torch.equal(again.U, res.U),
                  f"{tag}: a second run bit-equal")
            # chunks of 200 run whole: the iterations past the stop are
            # frozen on the device but still launched
            steps = -(-it // 200) * 200
            out["pcg"][label] = {
                "iters": it, "single": single, "util": util, "resid": resid,
                "wall_s": (wall, wall2), "ms": (ms, ms2),
                "collectives": st["collectives"], "steps": steps,
                "per_iter": st["collectives"] / steps,
                "host_bytes": st["host_bytes"]}
            print(f"[dist 1 rank] {tag}: {it} iterations (single device "
                  f"{single}); {st['collectives']} collectives in "
                  f"{steps} iteration steps ({st['collectives'] / steps:.3f}"
                  " a step), "
                  f"{st['host_bytes']} bytes through the host; utilization "
                  f"vs condensed {util:.3e}; wall {wall:.3f} / {wall2:.3f} "
                  f"s, CUDA events {ms:.1f} / {ms2:.1f} ms", flush=True)
        # one chunk of exactly n iterations (no frozen ones)
        ops, busy = pcg_per_iteration(pt, lambda n: solve(n, n))
        out["pcg_ops"], out["pcg_busy_us"] = ops, busy
        x = large["condensed"].U.contiguous()
        dots = x[:3].clone()
        out["host_us"] = {
            f"all_gather_cat of x ({x.numel() * 8 / 1e6:.1f} MB)":
                host_us(lambda: comm.all_gather_cat(x, dof_mesh,
                                                    [x.numel()])),
            "ordered_sum of 3 dots": host_us(
                lambda: comm.ordered_sum(dots, dof_mesh)),
            "an elementwise op (x + 1)": host_us(lambda: x + 1.0)}
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), "process group destroyed")
    out["host_us_fr"] = collective_host_us()
    return out


def dist_two_rank_phase(pt, hk, dev, flag, design, refined64):
    """Two ranks of one gloo group on the one card
    (``parallel.multihost.spawn_ranks``; NCCL refuses two ranks on one
    GPU, so the collectives stage CUDA tensors through the host): the
    flagship condensed envelope (5 cases a rank) bit-equal to the
    unsharded call, the 1,000-case f64 dense envelope (500 cases a rank:
    rank 1's K1 f64 launch starts at case 500) against the unsharded call
    at 1e-12, ``analyze(solver="pcg", mesh=)`` at 9,612 DOF against the
    Cholesky solve, and the design tier's pushover rose (8 of its 16
    headings a rank; checked in :func:`pushover_phase`); both ranks'
    results bit-equal, and each rank's launch counts.  No scaling is claimed: both ranks share the card."""
    import torch
    from small_fem_solver_tpu_torch.ops import hopper_kernels
    from small_fem_solver_tpu_torch.parallel import comm
    from small_fem_solver_tpu_torch.parallel import multihost as mh
    f32 = torch.float32
    cpu = mh.to_device
    cases = mh.RankMesh("cases")
    # the storm of phase 23 (tests/test_pcg_precond.py) and its Cholesky
    pwave = pt.make_wave(9.5, 9.4, 50.0, U_c=1.2, model="stokes", N=5,
                         device=dev)
    chol = pt.analyze(refined64, pwave, pt.LoadCase(**CASE), solver="chol",
                      accel="analytic")
    counts = (hopper_kernels.launch_counts, (), {"reset": True})
    stats = (comm.stats, (), {"reset": True})
    calls = {
        "reset": counts, "reset_stats": stats,
        "envelope": (pt.design_envelope_condensed, (
            cpu(flag["coarse32"], "cpu"), cpu(flag["refined32"], "cpu"),
            N_SEG, cpu(flag["waves32"], "cpu"), flag["cases"]),
            dict(n_steps=N_STEPS, solve_dtype=f32, kinematics="fused",
                 mesh=cases)),
        "envelope_counts": counts, "envelope_stats": stats,
        "dense": (pt.design_envelope, (
            cpu(design["coarse64"], "cpu"), design["waves"],
            design["cases"]), dict(n_steps=DESIGN_STEPS, mesh=cases)),
        "dense_counts": counts, "dense_stats": stats,
        "pcg": (pt.analyze, (cpu(refined64, "cpu"), cpu(pwave, "cpu"),
                             pt.LoadCase(**CASE)),
                dict(solver="pcg", accel="analytic",
                     pcg_precond="two_level", pcg_tol=PCG_TOL,
                     pcg_maxiter=20000, mesh=mh.RankMesh("dof"))),
        "pcg_counts": counts, "pcg_stats": stats,
        # the design tier's pushover rose, 8 headings a rank
        "rose": (pt.pushover_rose, (*storm_inputs(pt, "cpu"),
                                    list(ROSE_HEADINGS)),
                 dict(PUSH_KW, mesh=mh.RankMesh("headings"))),
        "rose_counts": counts, "rose_stats": stats,
    }
    kslice = k1_slice_check(pt, hk, dev, design["coarse64"], design["waves"],
                            design["cases"])
    t0 = time.perf_counter()
    ranks = mh.spawn_ranks(2, list(calls.values()), backend="gloo",
                           device="cuda", timeout=600)
    wall = time.perf_counter() - t0
    r0, r1 = (dict(zip(calls, r)) for r in ranks)
    check(all(bit_equal(tuple(r0[k]) if hasattr(r0[k], "_fields")
                        else r0[k], tuple(r1[k]) if hasattr(r1[k], "_fields")
                        else r1[k])
              for k in ("envelope", "dense", "pcg", "rose")),
          "two ranks on the card: both ranks' results bit-equal")
    env = r0["envelope"]
    check(bit_equal(tuple(env), tuple(mh.to_device(flag["env"], "cpu"))),
          "sharded flagship envelope (2 ranks, 5 cases each) bit-equal to "
          "the unsharded call")
    dense_err = tree_rel(r0["dense"], mh.to_device(design["env"], "cpu"))
    dense_bits = bit_equal(tuple(r0["dense"]),
                           tuple(mh.to_device(design["env"], "cpu")))
    check(dense_err <= 1e-12, f"sharded dense envelope (2 ranks, 500 cases "
          f"each; K1 f64 on cases 500-999 in rank 1) vs the unsharded "
          f"call: {dense_err:.2e} <= 1e-12 (bit-equal: {dense_bits})")
    pcg = r0["pcg"]
    util = rel(pcg.utilization, chol.utilization.cpu())
    check(float(pcg.solver_residual) <= PCG_TOL and util <= PCG_UTIL_RTOL,
          f"distributed PCG (2 ranks) at {refined64.n_dof} DOF: "
          f"{int(pcg.solver_iters)} iterations, residual "
          f"{float(pcg.solver_residual):.2e}, utilization vs Cholesky "
          f"{util:.2e} <= {PCG_UTIL_RTOL:g}")
    out = {"wall_s": wall, "dense_err": dense_err, "dense_bits": dense_bits,
           "k1_slice": kslice,
           "pcg_iters": int(pcg.solver_iters), "pcg_util": util,
           "rose": r0["rose"],
           "launches": {k: [r[f"{k}_counts"] for r in (r0, r1)]
                        for k in ("envelope", "dense", "pcg", "rose")},
           "stats": {k: [r[f"{k}_stats"] for r in (r0, r1)]
                     for k in ("envelope", "dense", "pcg", "rose")}}
    # each rank's block: half the flagship's cases, so half the unsharded
    # call's K1 f32 and sweep launches (10 / 40), and 500 dense cases in
    # one K1 f64 launch; the PCG launches neither kernel
    k1, sw = (flag["launches"][k] // 2
              for k in ("morison_phase_batch", "chain_sweep"))
    want = {"envelope": {"k1": k1, "f32": k1, "sweep": sw},
            "dense": {"k1": 1, "f64": 1}, "pcg": {}, "rose": {}}
    for k, w in want.items():
        for r, n in enumerate(out["launches"][k]):
            check(same_counts(n, w),
                  f"two ranks: rank {r} launched {n} on the {k} path "
                  f"(want {w})")
    print(f"[dist 2 ranks] one card, gloo: spawn + all calls {wall:.1f} s "
          f"wall; launches by rank {out['launches']}; collectives and "
          f"host-staged bytes by rank {out['stats']}; PCG 9,612 DOF "
          f"{out['pcg_iters']} iterations", flush=True)
    return out


def pdelta_phase(pt, hk, dev, coarse64, refined64, wave64, large):
    """Second-order analysis and buckling on the card in f64:
    ``analyze_pdelta`` at 126 DOF against the CPU run (1e-9);
    ``analyze_pdelta_condensed`` at 9,612 DOF against the dense
    ``analyze_pdelta`` on the same mesh (1e-9) and at 99,882 DOF, the
    sweep launches of each round, the sweep kernel against its plain
    version on a round's factor; ``buckling_analysis`` at 126 DOF against
    the CPU (1e-9) and ``buckling_analysis_condensed`` at 9,612 DOF
    against the dense factors (1% on the lowest, 12 chain modes)."""
    import torch
    from small_fem_solver_tpu_torch import api
    from small_fem_solver_tpu_torch.ops import buckling
    from small_fem_solver_tpu_torch.ops.condense import (chain_sweep_plain,
                                                         factor_chains)
    case = pt.LoadCase(**CASE, t_analysis=0.34)
    out = {}
    c_cpu = pt.default_3leg_jacket(device="cpu")
    w_cpu = wave64.to(torch.float64, "cpu")
    pd, _, s = counted(hk, lambda: pt.analyze_pdelta(coarse64, wave64, case))
    pd_cpu = pt.analyze_pdelta(c_cpu, w_cpu, case)
    err = max(rel(getattr(pd, f).cpu(), getattr(pd_cpu, f))
              for f in ("U", "reactions", "utilization",
                        "pdelta_amplification"))
    amp = float(pd.pdelta_amplification)
    check(err <= 1e-9 and 1.0 < amp < 1.15,
          f"analyze_pdelta at {coarse64.n_dof} DOF vs the CPU: {err:.2e} <= "
          f"1e-9; pdelta_amplification {amp:.6f}")
    lin = pt.analyze(coarse64, wave64, case)
    b = buckling.buckling_analysis(coarse64, lin)
    b_cpu = buckling.buckling_analysis(c_cpu, pt.analyze(c_cpu, w_cpu, case))
    berr = rel(b.load_factor.cpu(), b_cpu.load_factor)
    lam = float(b.load_factor[0])
    check(berr <= 1e-9 and 20.0 < lam < 26.0,
          f"buckling_analysis at {coarse64.n_dof} DOF: lambda_cr {lam:.4f} "
          f"(CPU {float(b_cpu.load_factor[0]):.4f}, {berr:.2e} <= 1e-9)")
    out.update(amp=amp, lam=lam, pdelta_ms=s * 1e3)

    cond, n, s = counted(hk, lambda: pt.analyze_pdelta_condensed(
        coarse64, refined64, N_SEG, wave64, case))
    rounds = 4          # the first-order solve and n_iter = 3 rounds
    check(n["sweep"] >= rounds and n["sweep"] % rounds == 0
          and bool(torch.isfinite(cond.U).all()),
          f"analyze_pdelta_condensed at {refined64.n_dof} DOF: {n['sweep']} "
          f"sweep launches ({n['sweep'] // rounds} a round), finite")
    dense = pt.analyze_pdelta(refined64, wave64, case, accel="analytic")
    derr = max(rel(getattr(cond, f), getattr(dense, f))
               for f in ("U", "utilization", "pdelta_amplification"))
    check(derr <= 1e-9, f"analyze_pdelta_condensed vs dense analyze_pdelta "
          f"at {refined64.n_dof} DOF: {derr:.2e} <= 1e-9")
    out.update(cond_launches=n, cond_ms=s * 1e3, cond_err=derr,
               cond_amp=float(cond.pdelta_amplification))
    # the sweep kernel on a P-delta round's factor (Kg - K_G(N))
    Kg = api.prepare_condensed(coarse64, refined64, N_SEG,
                               chain_solver="thomas").Kg
    N = buckling.member_axial_forces(cond)
    fac = factor_chains(Kg - buckling.element_geometric_stiffness(
        refined64.coords, refined64.conn, N), N_SEG)
    g = api._global_to_chain(cond.F_applied[None], coarse64, N_SEG)[1]
    kern = hk.chain_sweep_cuda(fac, g.contiguous())
    plain = chain_sweep_plain(fac, g)
    serr = max(rel(a, b_) for a, b_ in zip(kern, plain))
    check(serr <= 1e-12, f"chain-sweep kernel vs plain on a P-delta round's "
          f"factor (f64, B=1, n_int={N_SEG - 1}): {serr:.2e} <= 1e-12")
    out["sweep_err"] = serr

    big = large["refined"]
    condl, n, s = counted(hk, lambda: pt.analyze_pdelta_condensed(
        coarse64, big, N_SEG_LARGE, large["wave"], large["case"]))
    ampl = float(condl.pdelta_amplification)
    check(bool(torch.isfinite(condl.U).all()) and 1.0 < ampl < 1.15
          and n["sweep"] % rounds == 0 and n["sweep"] >= rounds,
          f"analyze_pdelta_condensed at {big.n_dof} DOF: amplification "
          f"{ampl:.6f}, {n['sweep']} sweep launches ({n['sweep'] // rounds} "
          f"a round), {s:.2f} s")
    out.update(large_launches=n, large_s=s, large_amp=ampl)

    res = pt.analyze_condensed(coarse64, refined64, N_SEG, wave64, case)
    bc, _, s = counted(hk, lambda: buckling.buckling_analysis_condensed(
        coarse64, refined64, N_SEG, res, n_modes=3,
        n_chain_modes=CHAIN_MODES))
    t0 = time.perf_counter()
    bd = buckling.buckling_analysis(refined64, res, n_modes=3)
    dense_s = time.perf_counter() - t0
    cerr = abs(float(bc.load_factor[0]) / float(bd.load_factor[0]) - 1.0)
    check(cerr <= 0.01, f"buckling_analysis_condensed ({CHAIN_MODES} chain "
          f"modes) vs dense at {refined64.n_dof} DOF: lambda_cr "
          f"{float(bc.load_factor[0]):.4f} vs {float(bd.load_factor[0]):.4f}"
          f", {cerr:.2e} <= 0.01")
    out.update(buck_cond_s=s, buck_dense_s=dense_s, buck_err=cerr,
               lam_9612=float(bd.load_factor[0]))
    print(f"[pdelta] 126 DOF amplification {amp:.6f}, lambda_cr {lam:.4f}; "
          f"9,612 DOF condensed vs dense {derr:.2e}, amplification "
          f"{out['cond_amp']:.6f}; 99,882 DOF amplification {ampl:.6f}; "
          f"buckling 9,612 DOF condensed {float(bc.load_factor[0]):.4f} vs "
          f"dense {float(bd.load_factor[0]):.4f}", flush=True)
    return out


# ---- the design tier: foundation, seismic, collapse and code checks ----

# the storm of tests/test_soil.py:183-188 (Airy) and the CLI's built-in
# soil profile and pile (small_fem_solver_tpu/cli.py:1469-1474)
AIRY = (17.038, 9.4, 50.0, 1.7)
SOIL = [dict(kind="clay", z_top=0.0, z_bot=8.0, su_kPa=40.0,
             gamma_kN_m3=8.0, eps50=0.02),
        dict(kind="sand", z_top=8.0, z_bot=100.0, phi_deg=35.0,
             gamma_kN_m3=10.0)]
PILE = dict(D_mm=2134.0, t_mm=50.0, L_m=60.0)      # n_elem 64 (default)
SOIL_TOL = 1e-10      # springs, card vs CPU
SSI_TOL = 1e-9        # analyze_ssi on those springs, card vs CPU
NEWTON_RESID = 1e-8   # Newton residuals of the head solves
SEISMIC = dict(pga_g=0.2, ground="C", topside_mass_t=TOPSIDE_T,
               directions=((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                           (0.0, 0.0, 1.0)))
SEISMIC_TOL = 1e-9    # spectra card vs CPU (CQC; SRSS on the CPU's shapes)
PUSH_KW = dict(lambda_max=6.0, n_lambda=25, n_iter=120)  # cli.py:1772-1777
# past first yield: lambda to 18 (tests/test_pushover.py's jacket range)
PUSH_YIELD_KW = dict(PUSH_KW, lambda_max=18.0)
ROSE_HEADINGS = tuple(22.5 * i for i in range(16))
PUSH_TOL = 1e-9       # pushover curves card vs CPU
REMOVAL_TOL = 1e-10   # removal-screen utilizations card vs CPU
CHECK_TOL = 1e-12     # code checks and combinations card vs CPU


def nrel(a, b) -> float:
    """:func:`rel` of two arrays or tensors (host copies, f64)."""
    import numpy as np
    a = np.asarray(a.cpu() if hasattr(a, "cpu") else a, np.float64)
    b = np.asarray(b.cpu() if hasattr(b, "cpu") else b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def storm_inputs(pt, device):
    """(default jacket f64, Airy storm wave, storm case at t = 0.34 s) on
    ``device``."""
    return (pt.default_3leg_jacket(device=device),
            pt.airy_wave(*AIRY, device=device),
            pt.LoadCase(**CASE, t_analysis=0.34))


def phase_record(fn) -> dict:
    """:func:`call_record` of a phase's main call, as one line's text."""
    rec = call_record(fn)
    k1 = rec["k1_us"]
    rec["text"] = (f"{rec['s'] * 1e3:.1f} ms host clock (one synchronised "
                   f"call), {rec['ops']} device operations, device busy "
                   f"{rec['busy_ms']:.3f} ms, peak device memory "
                   f"{rec['peak_mib']:.0f} MiB"
                   + (f", K1 f64 {k1:.1f} us a launch (records + fused)"
                      if k1 == k1 else "")
                   + f"; most time: {rec['top']}")
    return rec


def equilibrium(res) -> float:
    """|sum of reactions + sum of applied forces| / |applied| (the three
    force components)."""
    F = res.F_applied.reshape(-1, 6)[:, :3].sum(0)
    return float((res.total_reaction[:3] + F).abs().max() / F.abs().max())


def soil_phase(pt, hk, dev, coarse64, refined64, large):
    """Pile springs to SSI on the card (f64): the clamped storm analysis,
    ``soil_support_stiffness`` from its reactions (9 Newton solves of the
    64-element pile on the card; each support's heads against the spring
    rows and their Newton residuals below 1e-8), the springs against a
    CPU run (1e-10), then ``analyze_ssi`` at 126 DOF (against the CPU,
    equilibrium) and ``analyze_condensed(..., support_stiffness=)`` at
    9,612 and 99,882 DOF (equilibrium, the sweep launches)."""
    import numpy as np
    from small_fem_solver_tpu_torch.ops import soil as soil_mod
    soil = [pt.SoilLayer(**lay) for lay in SOIL]
    pile = pt.Pile(**PILE)
    model, wave, case = storm_inputs(pt, dev)
    out = {}
    clamped = pt.analyze(model, wave, case, solver="chol")
    springs, n, s = counted(hk, lambda: pt.soil_support_stiffness(
        model, soil, pile, reactions=clamped.reactions))
    check(same_counts(n, {}), f"soil springs launch no kernel: {n}")
    out["springs_s"] = s
    c_cpu, w_cpu, _ = storm_inputs(pt, "cpu")
    springs_cpu = pt.soil_support_stiffness(
        c_cpu, soil, pile,
        reactions=pt.analyze(c_cpu, w_cpu, case, solver="chol").reactions)
    err = nrel(springs, springs_cpu)
    R = clamped.reactions.cpu().numpy()
    heads = [soil_mod.pile_head_stiffness(
        pile, soil, H_kN=max(np.hypot(r[0], r[1]) / 1e3, 10.0),
        V_kN=max(abs(r[2]) / 1e3, 100.0),
        M_kNm=(lambda m: m if m > 1.0 else 0.0)(np.hypot(r[3], r[4]) / 1e6),
        device=dev) for r in R]
    resid = max(float(h.residuals.max()) for h in heads)
    rows = np.stack([h.support_stiffness for h in heads])
    check(err <= SOIL_TOL and resid <= NEWTON_RESID
          and np.array_equal(rows, springs),
          f"soil_support_stiffness on the card vs the CPU: {err:.2e} <= "
          f"{SOIL_TOL:g}; Newton residuals <= {resid:.1e} (<= "
          f"{NEWTON_RESID:g}); rows = the heads' springs")
    out.update(springs=springs, err=err, resid=resid,
               kz_over_ky=float(springs[0, 2] / springs[0, 0]))

    ssi = pt.analyze_ssi(model, wave, case, springs)
    ssi_cpu = pt.analyze_ssi(c_cpu, w_cpu, case, springs_cpu)
    serr = max(rel(getattr(ssi, f).cpu(), getattr(ssi_cpu, f))
               for f in ("U", "reactions", "utilization"))
    eq = equilibrium(ssi)
    check(serr <= SSI_TOL and eq <= 1e-9 and float(
        ssi.max_displacement_mm) > float(clamped.max_displacement_mm),
          f"analyze_ssi at {model.n_dof} DOF on the pile springs: vs CPU "
          f"{serr:.2e} <= {SSI_TOL:g}, equilibrium {eq:.2e} <= 1e-9, max "
          f"displacement {float(ssi.max_displacement_mm):.2f} mm > clamped "
          f"{float(clamped.max_displacement_mm):.2f} mm")
    out.update(ssi_err=serr, ssi_eq=eq)
    for label, fine, n_seg in (("9612", refined64, N_SEG),
                               ("99882", large["refined"], N_SEG_LARGE)):
        res, n, s = counted(hk, lambda: pt.analyze_condensed(
            model, fine, n_seg, wave, case, support_stiffness=springs))
        eq = equilibrium(res)
        check(n["sweep"] >= 2 and same_counts(n, {"sweep": n["sweep"]})
              and eq <= 1e-9 and bool(res.U.isfinite().all()),
              f"analyze_condensed on the pile springs at {fine.n_dof} DOF: "
              f"{n['sweep']} sweep launches, equilibrium {eq:.2e} <= 1e-9, "
              f"max utilization {float(res.utilization.max()):.6f}")
        out[f"condensed_{label}"] = dict(launches=n, s=s, eq=eq,
                                         umax=float(res.utilization.max()))
    r = R[0]   # support 0's head: 3 of the 9 Newton solves
    out["rec"] = phase_record(lambda: soil_mod.pile_head_stiffness(
        pile, soil, H_kN=max(np.hypot(r[0], r[1]) / 1e3, 10.0),
        V_kN=max(abs(r[2]) / 1e3, 100.0), device=dev))
    return out


def cluster_sums(freqs, values):
    """``values`` [n_dirs, n_modes] summed over each cluster of modes
    whose frequencies agree to 1e-4 (the jacket's near-degenerate pairs
    are split by 1e-7 to 3e-6, its distinct modes by >= 3%; inside a pair
    the basis is the eigensolver's choice, the pair's sum is not)."""
    import numpy as np
    f = np.asarray(freqs.cpu(), np.float64)
    v = np.asarray(values.cpu(), np.float64)
    cuts = np.flatnonzero(np.abs(np.diff(f)) > 1e-4 * np.abs(f[1:])) + 1
    return np.stack([p.sum(axis=-1) for p in np.split(v, cuts, axis=-1)],
                    axis=-1)


def spectrum_errs(card, cpu) -> dict:
    """Card against CPU of one spectrum run: periods, the CQC demands,
    and the effective masses summed over frequency clusters."""
    errs = {f: rel(getattr(card, f).cpu(), getattr(cpu, f))
            for f in ("periods_s", "U_peak", "F1_local", "F2_local",
                      "utilization", "base_shear_kN")}
    errs["effective_mass_clusters"] = nrel(
        cluster_sums(cpu.frequencies_hz, card.effective_mass_t),
        cluster_sums(cpu.frequencies_hz, cpu.effective_mass_t))
    return errs


def seismic_phase(pt, hk, dev, coarse64, refined64, large, mlarge):
    """Response spectra on the card (f64, EC8 ground C, 0.2 g, three
    directions, 1,100 t topside): ``response_spectrum`` at 126 DOF with
    CQC against the CPU (1e-9) and SRSS / 100-40-40 on the CPU run's
    shapes (1e-9); ``response_spectrum_condensed`` at 9,612 DOF (10 sweep
    launches) against the CPU: at 14 chain modes periods, CQC demands and
    clustered effective masses at 1e-9, at 12 chain modes (a cut that
    splits degenerate chain-mode pairs) the periods at 1e-9 and
    the rest reported; at 99,882 DOF its first 8 periods against
    ``modal_analysis_condensed``'s."""
    import math
    import torch
    from small_fem_solver_tpu_torch.ops import seismic as seismic_mod
    from small_fem_solver_tpu_torch.ops.dynamics import _build_km
    demands = ("U_peak", "F1_local", "F2_local", "utilization",
               "base_shear_kN")
    out = {}
    c_cpu = pt.default_3leg_jacket(device="cpu")
    dense, n, s = counted(hk, lambda: pt.response_spectrum(coarse64,
                                                           **SEISMIC))
    errs = spectrum_errs(dense, pt.response_spectrum(c_cpu, **SEISMIC))
    err = max(errs.values())
    check(err <= SEISMIC_TOL and same_counts(n, {}),
          f"response_spectrum (CQC) at {coarse64.n_dof} DOF vs the CPU: "
          f"{err:.2e} <= {SEISMIC_TOL:g}; launches {n}")
    _, _, _, (K_local, T, _) = _build_km(coarse64, 210000.0, 0.3, TOPSIDE_T)
    rules = {}
    for comb, rule in (("srss", "srss"), ("cqc", "100-40-40"),
                       ("srss", "100-40-40")):
        cpu = pt.response_spectrum(c_cpu, combination=comb, dir_rule=rule,
                                   **SEISMIC)
        card = seismic_mod._spectrum_core(
            coarse64.conn, coarse64.sections, coarse64.sect_id,
            (2.0 * math.pi * cpu.frequencies_hz).to(dev),
            cpu.mode_shapes.to(dev), cpu.participation.to(dev), K_local, T,
            SEISMIC["pga_g"], "C", 0.05, cpu.directions, None, True, comb,
            rule, 355.0, torch.float64)
        rules[f"{comb}/{rule}"] = max(rel(getattr(card, f).cpu(),
                                          getattr(cpu, f)) for f in demands)
    check(max(rules.values()) <= SEISMIC_TOL,
          f"SRSS and 100-40-40 on the card, on the CPU run's shapes: "
          f"{rules}")
    out.update(dense_err=err, rules=rules, dense_s=s)

    def condensed(m=CHAIN_MODES):
        return pt.response_spectrum_condensed(
            coarse64, refined64, N_SEG, n_chain_modes=m, **SEISMIC)
    cond, n, s = counted(hk, condensed)
    check(same_counts(n, {"sweep": 10}), f"response_spectrum_condensed at "
          f"{refined64.n_dof} DOF: launches {n}")
    r_cpu = pt.refine_model(c_cpu, N_SEG)
    cut = {}
    for m in (CHAIN_MODES, CHAIN_MODES + 2):
        cut[m] = spectrum_errs(
            cond if m == CHAIN_MODES else condensed(m),
            pt.response_spectrum_condensed(c_cpu, r_cpu, N_SEG,
                                           n_chain_modes=m, **SEISMIC))
    held = max(cut[CHAIN_MODES + 2].values())
    check(held <= SEISMIC_TOL
          and cut[CHAIN_MODES]["periods_s"] <= SEISMIC_TOL,
          f"response_spectrum_condensed (CQC) at {refined64.n_dof} DOF vs "
          f"the CPU: {CHAIN_MODES + 2} chain modes {held:.2e} <= "
          f"{SEISMIC_TOL:g} ("
          + ", ".join(f"{k} {v:.1e}" for k, v in cut[CHAIN_MODES + 2].items())
          + f"); {CHAIN_MODES} chain modes periods "
          f"{cut[CHAIN_MODES]['periods_s']:.2e} <= {SEISMIC_TOL:g}, the "
          "rest (not held: the cut splits degenerate chain-mode pairs) "
          + ", ".join(f"{k} {v:.1e}" for k, v in cut[CHAIN_MODES].items()))
    out.update(cond_errs=cut, cond_launches=n, cond_s=s,
               cond_umax=float(cond.utilization.max()),
               base_shear=[float(v) for v in cond.base_shear_kN])
    big, n, s = counted(hk, lambda: pt.response_spectrum_condensed(
        coarse64, large["refined"], N_SEG_LARGE, n_chain_modes=CHAIN_MODES,
        **SEISMIC))
    perr = nrel(big.periods_s[:8], mlarge["periods"])
    check(perr <= SEISMIC_TOL and same_counts(n, {"sweep": 10})
          and bool(big.U_peak.isfinite().all()),
          f"response_spectrum_condensed at {large['refined'].n_dof} DOF: "
          f"first 8 periods vs modal_analysis_condensed's {perr:.2e} <= "
          f"{SEISMIC_TOL:g}; launches {n}")
    out.update(large_launches=n, large_s=s, large_perr=perr,
               large_umax=float(big.utilization.max()))
    out["rec"] = phase_record(condensed)
    return out


def pushover_phase(pt, hk, dev, d2):
    """Pushover and its rose on the card (f64, the CLI's defaults: lambda
    to 6 in 25 steps, 120 secant iterations): ``pushover`` against the
    CPU (RSR, first yield, converged and yielded counts equal; curves
    1e-9), there and past first yield (lambda to 18); ``pushover_rose`` at 16 headings (400 states a batched
    iteration) against the CPU at 4 of them, in a single-rank NCCL group
    (bit-equal to mesh=None), and in two gloo ranks (run in the two-rank
    phase's spawn; RSR and first yield equal, curves 1e-9)."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from small_fem_solver_tpu_torch.parallel import multihost as mh
    model, wave, case = storm_inputs(pt, dev)
    c_cpu, w_cpu, _ = storm_inputs(pt, "cpu")
    out = {}

    def same_curve(a, b, what):
        exact = (float(a.rsr) == float(b.rsr)
                 and float(a.first_yield_lambda) == float(b.first_yield_lambda)
                 and bit_equal(a.converged.cpu(), b.converged.cpu())
                 and bit_equal(a.n_yielded.cpu(), b.n_yielded.cpu()))
        err = max(rel(getattr(a, f).cpu(), getattr(b, f).cpu())
                  for f in ("max_displacement_mm", "max_util", "axial_N"))
        check(exact and err <= PUSH_TOL,
              f"{what}: RSR {float(a.rsr):g} (vs {float(b.rsr):g}), first "
              f"yield {float(a.first_yield_lambda):g} (vs "
              f"{float(b.first_yield_lambda):g}), flags equal {exact}, "
              f"curves {err:.2e} <= {PUSH_TOL:g}")
        return err

    one, n, s = counted(hk, lambda: pt.pushover(model, wave, case,
                                                **PUSH_KW))
    check(same_counts(n, {}), f"pushover launches no kernel: {n}")
    out["single_err"] = same_curve(one, pt.pushover(c_cpu, w_cpu, case,
                                                    **PUSH_KW),
                                   "pushover card vs CPU")
    out.update(single_s=s, rsr=float(one.rsr),
               first_yield=float(one.first_yield_lambda),
               n_yielded=int(one.n_yielded.max()))
    far = pt.pushover(model, wave, case, **PUSH_YIELD_KW)
    out["yield_err"] = same_curve(far, pt.pushover(c_cpu, w_cpu, case,
                                                   **PUSH_YIELD_KW),
                                  "pushover to lambda 18 card vs CPU")
    out.update(yield_rsr=float(far.rsr),
               yield_first=float(far.first_yield_lambda),
               yield_n=int(far.n_yielded.max()))

    def rose(mesh=None):
        return pt.pushover_rose(model, wave, case, list(ROSE_HEADINGS),
                                mesh=mesh, **PUSH_KW)
    (hs, rsr, fy, per), n, s = counted(hk, rose)
    out.update(rose_s=s, rose_rsr=rsr.tolist(), rose_fy=fy.tolist())
    sub = list(range(0, 16, 4))
    _, rsr_c, fy_c, per_c = pt.pushover_rose(
        c_cpu, w_cpu, case, [ROSE_HEADINGS[i] for i in sub], **PUSH_KW)
    out["rose_err"] = max(same_curve(per[i], per_c[k],
                                     f"rose heading {ROSE_HEADINGS[i]:g} "
                                     f"card vs CPU")
                          for k, i in enumerate(sub))
    store = tempfile.mkdtemp(prefix="chip_smoke_rose_")
    check(mh.init_multihost(f"file://{store}/store", world_size=1, rank=0)
          and dist.get_backend() == "nccl",
          "single-rank NCCL group for the rose")
    try:
        mesh = mh.global_case_mesh("headings")
        _, rsr1, fy1, curve = rose(mesh)
    finally:
        dist.destroy_process_group()
    mine = tuple(torch.stack([getattr(r, f) for r in per])
                 for f in ("converged", "max_displacement_mm", "n_yielded",
                           "max_util", "axial_N"))
    check(bit_equal(curve, mine) and np.array_equal(rsr1, rsr)
          and np.array_equal(fy1, fy),
          "pushover_rose with a one-rank NCCL mesh bit-equal to mesh=None")
    h2, rsr2, fy2, curve2 = d2["rose"]
    err2 = max(rel(a.double(), b.cpu().double())
               for a, b in zip(curve2[1:], mine[1:]) if a.is_floating_point())
    check(np.array_equal(rsr2, rsr) and np.array_equal(fy2, fy)
          and bit_equal(curve2[0], mine[0].cpu())
          and bit_equal(curve2[2], mine[2].cpu()) and err2 <= PUSH_TOL,
          f"pushover_rose in two gloo ranks (8 headings each) vs mesh=None: "
          f"RSR and first yield equal, curves {err2:.2e} <= {PUSH_TOL:g}")
    out["two_rank_err"] = err2
    out["rec"] = phase_record(rose)
    return out


def removal_phase(pt, hk, dev):
    """``member_removal_screen`` on the card: all 51 removals of the storm
    jacket in one batched factorization and solve, against the CPU
    (stable, critical and governing member equal; utilizations and
    displacements 1e-10)."""
    import torch
    model, wave, case = storm_inputs(pt, dev)
    c_cpu, w_cpu, _ = storm_inputs(pt, "cpu")
    scr, n, s = counted(hk, lambda: pt.member_removal_screen(model, wave,
                                                             case))
    ref = pt.member_removal_screen(c_cpu, w_cpu, case)
    flags = all(bit_equal(getattr(scr, f).cpu(), getattr(ref, f))
                for f in ("stable", "critical", "governing_member"))
    live = ref.stable
    err = max(rel(getattr(scr, f).cpu()[live], getattr(ref, f)[live])
              for f in ("max_util", "max_displacement_mm"))
    err = max(err, rel(scr.intact_util.cpu(), ref.intact_util))
    check(flags and err <= REMOVAL_TOL and same_counts(n, {}),
          f"member_removal_screen ({model.n_members} removals) card vs CPU: "
          f"flags equal {flags}, utilizations {err:.2e} <= {REMOVAL_TOL:g}; "
          f"{int(scr.critical.sum())} critical, {int((~scr.stable).sum())} "
          f"unstable, worst damaged utilization "
          f"{float(scr.max_util.max()):.4f} (intact "
          f"{float(scr.intact_util):.4f})")
    return {"err": err, "s": s, "critical": int(scr.critical.sum()),
            "worst": float(scr.max_util.max()),
            "intact": float(scr.intact_util),
            "rec": phase_record(lambda: pt.member_removal_screen(
                model, wave, case))}


def checks_phase(pt, hk, dev):
    """The code checks on the storm analysis on the card against the CPU
    (1e-12; labels, flags and indices equal): API RP 2A and ISO 19902
    member checks, the API joint check ('auto' load-path classes), the
    VIV screen, the air gap under the Airy storm and its Stokes-5 wave,
    and ``combo_envelope`` of three load cases (the storm, the topside
    alone, the environment at a second heading)."""
    import dataclasses
    import numpy as np
    import torch

    def run(device):
        model, wave, case = storm_inputs(pt, device)
        stokes = pt.make_wave(*AIRY[:3], U_c=AIRY[3], model="stokes", N=5,
                              device=device)
        storm = pt.analyze(model, wave, case, solver="chol")
        acts = {"E": storm,
                "G": pt.analyze(model, wave, pt.LoadCase(
                    F_axial_kN=25100.0, sw_mode="none"), solver="chol"),
                "E2": pt.analyze(model, wave, dataclasses.replace(
                    case, wave_dir_deg=128.0, current_dir_deg=128.0,
                    custom_sw_tonnes=0.0), solver="chol")}
        combos = {"iso_extreme": {"G": 1.1, "E": 1.35},
                  "iso_operating": {"G": 1.3, "E": 0.9, "E2": 0.9},
                  "wsd": {"G": 1.0, "E": 1.0, "E2": 1.0}}
        combined, env = pt.combo_envelope(model, acts, combos)
        return {"api": pt.member_code_check(model, storm),
                "iso": pt.iso_member_check(model, storm),
                "joint": pt.joint_code_check(model, storm,
                                             joint_class="auto"),
                "viv": pt.viv_screen(model, AIRY[3], AIRY[2],
                                     current_alpha=1.0 / 7.0),
                "airgap_airy": pt.air_gap_check(model, wave, 38.0),
                "airgap_stokes5": pt.air_gap_check(model, stokes, 38.0),
                "combo": tuple(combined["iso_extreme"][:7]),
                "envelope": (env["member_envelope"],
                             env["governing_combo"], env["governing"])}

    card, n, s = counted(hk, lambda: run(dev))
    cpu = run("cpu")
    errs = {}
    for k, v in card.items():
        e = 0.0
        for a, b in zip(v, cpu[k]):
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                e = max(e, nrel(a, b))
            elif isinstance(a, torch.Tensor):
                check(bit_equal(a.cpu(), b), f"{k}: integer or flag field "
                      "equal on the card and the CPU")
            elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
                e = max(e, nrel(a, b))
            elif isinstance(a, np.ndarray):
                check(np.array_equal(a, b), f"{k}: labels and indices "
                      "equal")
            elif isinstance(a, float):
                e = max(e, abs(a - b) / max(abs(b), 1e-300))
            else:
                check(a == b, f"{k}: {a} == {b}")
        errs[k] = e
    check(max(errs.values()) <= CHECK_TOL and same_counts(n, {}),
          f"code checks and combinations card vs CPU: "
          + ", ".join(f"{k} {e:.1e}" for k, e in errs.items())
          + f" <= {CHECK_TOL:g}; launches {n}")
    uc = {k: float(card[k].uc.max()) for k in ("api", "iso", "joint")}
    return {"errs": errs, "s": s, "uc": uc,
            "airgap": {k: float(card[k].air_gap_m)
                       for k in ("airgap_airy", "airgap_stokes5")},
            "viv_flags": int((card["viv"].flags != "ok").sum()),
            "governing_combo": card["envelope"][2],
            "rec": phase_record(lambda: run(dev))}


# ---- the long-term tier (reliability, design, model I/O and reports) ----
RELI = dict(d=50.0, U_c=1.7, wave_model="airy", n_steps=12)
RELI_THRESHOLD = 0.3  # member reliability (tests/test_reliability.py:246-282)
IS_SAMPLES = 1000     # importance sampling (the CLI's --monte-carlo 1000)
RELI_TOL = 1e-8       # beta and design storms, card vs CPU
IS_TOL = 1e-10        # importance-sampling pf and cov, card vs CPU
K1_PLAIN_TOL = 1e-12  # K1 f64 vs its plain version at a batch of the path
SENS_TOL = 1e-10      # section sensitivities, card vs CPU (126, 9,612 DOF)
FD_STEPS = (1e-3, 1e-2)  # central-difference steps h and 10h [mm]
FD_RTOL = 1e-6        # ... vs central differences at 126 DOF (JAX's rtol)
# ... at 9,612 DOF, at h and 10h: the smallest component (d util / d D_leg,
# 6.8e-6 /mm) is roundoff-bound, d * u / (h |g|) with the forward's relative
# roundoff d <= 1e-12 (card vs CPU 1.1e-12), u = 0.245: 3.6e-5 at h and
# 3.6e-6 at 10h, plus the t_brace truncation 1.1e-7 (h^2) at 10h
FD_RTOL_9612 = (4e-5, 4e-6)
SIZING_ITERS = 80     # optimize_sections (the CLI's --n-iter 80)
SIZING_TOL = 1e-8     # optimized thicknesses, card vs CPU
TEXT_TOL = 1e-9       # report numbers, card vs CPU


def climate_states():
    """(Hs, Tp) of the synthetic climate of tests/test_reliability.py: Hs ~
    Weibull(1.5, 2.5), ln Tp | Hs ~ N(ln(5.5 + 1.4 sqrt Hs), 0.12), 30,000
    states (seed 3) scaled to storm waves (2 Hs, Tp + 2)."""
    import numpy as np
    rng = np.random.default_rng(3)
    hs = 2.5 * rng.weibull(1.5, size=30_000)
    tp = np.exp(np.log(5.5 + 1.4 * np.sqrt(hs))
                + 0.12 * rng.standard_normal(hs.size))
    return 2.0 * hs, tp + 2.0


def reliability_climate(pt):
    """:func:`climate_states` fitted (8 bins, 3 h states)."""
    return pt.fit_joint_hs_tp(*climate_states(), n_bins=8, state_hours=3.0)


def k1_batch_check(hk, model, hs, tp):
    """K1's case-batched f64 instance against its plain version (1e-12) on
    the operands of the reliability closures' envelope for the sea states
    (hs, tp): their clipped Airy waves, 12 phases, the storm's heading."""
    import torch
    from small_fem_solver_tpu_torch.ops import reliability as rel_mod
    from small_fem_solver_tpu_torch.ops.morison import (
        morison_end_forces_batch)
    h, t = rel_mod._breaking_clip(hs, tp, RELI["d"], 0.05, 0.75 * RELI["d"])
    waves = rel_mod._batch_waves(model, h, t, RELI["d"], RELI["U_c"],
                                 RELI["wave_model"], 5)
    C, S = waves.E.shape[0], RELI["n_steps"]
    ts = (torch.arange(S, dtype=model.dtype, device=model.device)[None, :]
          * waves.T[:, None] / S)
    dirs = torch.full((C,), 38.0, dtype=model.dtype, device=model.device)
    D = model.sections.D_outer[model.sect_id] / 1000.0
    args = (waves, model.coords, model.conn, D, dirs, dirs, 0.7, 2.0,
            1025.0, ts)
    out = hk.morison_end_forces_batch_cuda(*args)
    err = max(rel(a, b) for a, b in zip(out, morison_end_forces_batch(*args)))
    return err, C


def reliability_phase(pt, hk, dev):
    """Long-term reliability on the card (f64, the default jacket, the
    storm case, Airy design waves, 12 phases; the climate of
    :func:`reliability_climate`): ``member_reliability`` on
    ``member_utilization_response_batch`` at threshold 0.3 (one launch of
    K1's f64 instance per envelope, = ``n_envelopes``; K1 against its plain
    version at the first batch's operands, 1e-12; flags and the envelope
    count equal to a CPU run, beta and design storms 1e-8), the
    importance-sampling check of the governing member's design point
    through ``utilization_response_batch`` at 1,000 samples (one launch;
    pf and cov against the CPU on the same samples, 1e-10), and the scalar
    FORM ``environmental_reliability`` on ``utilization_response``
    (pointwise ``analyze_phase_batch``: no launch; evaluations and beta
    against the CPU)."""
    import numpy as np
    joint = reliability_climate(pt)
    case = pt.LoadCase(**CASE)
    model = pt.default_3leg_jacket(device=dev)
    cpu = pt.default_3leg_jacket(device="cpu")
    out = {}

    first = []
    resp = pt.member_utilization_response_batch(model, case, **RELI)

    def recording(hs, tp):
        if not first:
            first.append((np.array(hs), np.array(tp)))
        return resp(hs, tp)
    with f64_shapes(hk) as shapes:
        mr, n, s = counted(hk, lambda: pt.member_reliability(
            recording, joint, RELI_THRESHOLD))
    out["f64_bounds"] = shape_bounds(shapes)
    check(same_counts(n, {"f64": mr.n_envelopes}),
          f"member_reliability: K1 f64 launches {n['f64']} == n_envelopes "
          f"{mr.n_envelopes} (one a batch), no other launch: {n}")
    err, C = k1_batch_check(hk, model, *first[0])
    check(err <= K1_PLAIN_TOL, f"K1 f64 at member_reliability's first batch "
          f"({C} sea states x {RELI['n_steps']} phases) vs plain {err:.2e} "
          f"<= {K1_PLAIN_TOL:g}")
    t0 = time.perf_counter()
    ref = pt.member_reliability(pt.member_utilization_response_batch(
        cpu, case, **RELI), joint, RELI_THRESHOLD)
    out["cpu_s"] = time.perf_counter() - t0
    flags = (np.array_equal(mr.reachable, ref.reachable)
             and np.array_equal(mr.converged, ref.converged)
             and mr.n_envelopes == ref.n_envelopes)
    r = ref.reachable
    berr = max(float(np.abs(getattr(mr, f)[r] / getattr(ref, f)[r]
                            - 1.0).max())
               for f in ("beta", "hs_star", "tp_star"))
    check(flags and berr <= RELI_TOL and r.any() and (~r).any(),
          f"member_reliability card vs CPU: reachable ({int(r.sum())} of "
          f"{r.size}), converged and n_envelopes ({mr.n_envelopes}) equal "
          f"{flags}; beta and design storms {berr:.2e} <= {RELI_TOL:g}")
    gov = int(np.argmin(np.where(r, mr.beta, np.inf)))
    launches = {"member_reliability": n}
    out.update(launches=launches, s=s, n_envelopes=mr.n_envelopes,
               reachable=int(r.sum()), err=berr, k1_err=err,
               beta_min=float(mr.beta[gov]), governing=gov,
               p_lower=mr.system.p_lower, p_upper=mr.system.p_upper,
               hs_star=float(mr.hs_star[gov]),
               tp_star=float(mr.tp_star[gov]))
    out["rec"] = phase_record(lambda: pt.member_reliability(
        resp, joint, RELI_THRESHOLD))

    # importance sampling at the governing member's design point
    u_star = mr.beta[gov] * mr.alpha[gov]
    res = pt.FormResult(beta=float(mr.beta[gov]), pf=float(mr.pf[gov]),
                        u_star=u_star, x_star=u_star, alpha=mr.alpha[gov],
                        g_star=0.0, n_iter=0, n_evals=0, converged=True)
    g_card = pt.hs_tp_limit_state_batch(pt.utilization_response_batch(
        model, case, **RELI), joint, RELI_THRESHOLD)
    (pf, cov), n, s = counted(hk, lambda: pt.importance_sample_batch(
        g_card, res, n_samples=IS_SAMPLES, seed=0))
    check(same_counts(n, {"f64": 1}), f"importance_sample_batch at "
          f"{IS_SAMPLES} samples: one K1 f64 launch: {n}")
    pf_c, cov_c = pt.importance_sample_batch(pt.hs_tp_limit_state_batch(
        pt.utilization_response_batch(cpu, case, **RELI), joint,
        RELI_THRESHOLD), res, n_samples=IS_SAMPLES, seed=0)
    ierr = max(abs(pf / pf_c - 1.0), abs(cov / cov_c - 1.0))
    check(pf_c > 0.0 and ierr <= IS_TOL,
          f"importance_sample_batch card vs CPU (same samples): pf {pf:.6e} "
          f"(CPU {pf_c:.6e}), cov {cov:.4f}; {ierr:.2e} <= {IS_TOL:g}; "
          f"FORM pf of that member {float(mr.pf[gov]):.6e}")
    launches["importance_sample_1000"] = n
    out.update(is_s=s, pf=pf, cov=cov, is_err=ierr)
    out["is_rec"] = phase_record(lambda: pt.importance_sample_batch(
        g_card, res, n_samples=IS_SAMPLES, seed=0))
    # the batch's K1 launch: S 12 phases, the 51 members' 15 Gauss points,
    # one Airy mode, 1,000 cases
    out["is_bound"] = harm64_bound(RELI["n_steps"], model.n_members,
                                   N_GAUSS, 1, model.n_nodes, IS_SAMPLES)

    # scalar FORM through the pointwise phase batch
    response = pt.utilization_response(model, case, **RELI)
    r1, r100 = (response(*map(float, pt.rosenblatt_hs_tp(
        joint, pt.return_period_beta(joint, y), 0.0))) for y in (1.0, 100.0))
    thr = 0.5 * (r1 + r100)
    er, n, s = counted(hk, lambda: pt.environmental_reliability(
        response, joint, thr, max_iter=25))
    ec = pt.environmental_reliability(pt.utilization_response(
        cpu, case, **RELI), joint, thr, max_iter=25)
    same = (er.form.converged and ec.form.converged
            and (er.form.n_iter, er.form.n_evals) == (ec.form.n_iter,
                                                      ec.form.n_evals))
    eerr = max(abs(er.form.beta / ec.form.beta - 1.0),
               abs(er.hs_star / ec.hs_star - 1.0),
               abs(er.tp_star / ec.tp_star - 1.0))
    check(same_counts(n, {}) and same and eerr <= RELI_TOL,
          f"environmental_reliability (threshold {thr:.4f}): no launch {n}; "
          f"converged, {er.form.n_iter} iterations and {er.form.n_evals} "
          f"evaluations as on the CPU {same}; beta {er.form.beta:.6f}, "
          f"design storm Hs {er.hs_star:.3f} m Tp {er.tp_star:.3f} s vs CPU "
          f"{eerr:.2e} <= {RELI_TOL:g}")
    launches["environmental_reliability"] = n
    out.update(form_s=s, form_evals=er.form.n_evals, form_iter=er.form.n_iter,
               form_beta=er.form.beta, form_err=eerr,
               form_ms_per_eval=s * 1e3 / er.form.n_evals)
    return out


def design_phase(pt, hk, dev, refined64):
    """Differentiable design on the card (f64, the Stokes-5 storm at t =
    0.34 s of tests/test_design.py): ``section_sensitivities`` at 126 DOF
    and at 9,612 DOF (the backward of a dense f64 Cholesky on the card),
    each against the CPU f64 (1e-10) and against central differences at
    h = 1e-3 mm and 10h (1e-6 at 126 DOF; at 9,612 DOF the roundoff and
    truncation bounds of ``FD_RTOL_9612``); ``optimize_sections`` to target
    0.5 in 80 iterations against the CPU (thicknesses 1e-8), with its time
    an iteration and peak memory.  No kernel: the dense pointwise path."""
    import dataclasses
    import numpy as np
    import torch

    def inputs(device):
        return (pt.default_3leg_jacket(device=device),
                pt.make_wave(*AIRY[:3], U_c=AIRY[3], model="stokes", N=5,
                             device=device),
                pt.LoadCase(**CASE, t_analysis=0.34))
    model, wave, case = inputs(dev)
    cm, cw, cc = inputs("cpu")
    out = {"launches": {}}

    def central(m, h):
        p0 = torch.stack([m.sections.D_outer, m.sections.t],
                         dim=-1).reshape(-1)

        def util(p):
            mm = dataclasses.replace(m, sections=pt.tube_sections(
                p[0::2], p[1::2], 7850.0, device=m.device))
            return float(pt.analyze(mm, wave, case, solver="chol",
                                    accel="analytic").utilization.max())
        fd = []
        for i in range(p0.numel()):
            e = torch.zeros_like(p0)
            e[i] = h
            fd.append((util(p0 + e) - util(p0 - e)) / (2.0 * h))
        return np.array(fd)

    for key, m, cpu_m, tols in (
            ("", model, cm, (FD_RTOL, FD_RTOL)),
            ("big_", refined64, pt.refine_model(cm, N_SEG), FD_RTOL_9612)):
        sens, n, s = counted(hk, lambda m=m: pt.section_sensitivities(
            m, wave, case))
        ref = pt.section_sensitivities(cpu_m, cw, cc)
        serr = max(rel(getattr(sens, f).cpu(), getattr(ref, f))
                   for f in ("dutil", "dmass_t", "util_max", "mass_t"))
        uerr = rel(sens.util_max.cpu(), ref.util_max)
        g = sens.dutil.cpu().numpy()
        fderr = [float(np.abs(g / central(m, h) - 1.0).max())
                 for h in FD_STEPS]
        check(same_counts(n, {}) and serr <= SENS_TOL
              and all(e <= t for e, t in zip(fderr, tols))
              and bool(sens.dutil.isfinite().all()),
              f"section_sensitivities at {m.n_dof} DOF: no launch {n}; card "
              f"vs CPU {serr:.2e} <= {SENS_TOL:g} (util_max {uerr:.2e}); "
              f"vs central differences "
              + ", ".join(f"h {h:g} mm {e:.2e} <= {t:g}"
                          for h, e, t in zip(FD_STEPS, fderr, tols))
              + "; d(util)/d(D, t) (1/mm) "
              + " ".join(f"{v:.6e}" for v in g.tolist()))
        out["launches"][f"section_sensitivities_{m.n_dof}"] = n
        out.update({f"{key}s": s, f"{key}err": serr,
                    f"{key}fd_err": fderr, f"{key}dutil": g.tolist(),
                    f"{key}rec": phase_record(
                        lambda m=m: pt.section_sensitivities(m, wave,
                                                             case))})

    opt, n, s = counted(hk, lambda: pt.optimize_sections(
        model, wave, case, target_util=0.5, n_iter=SIZING_ITERS))
    copt = pt.optimize_sections(cm, cw, cc, target_util=0.5,
                                n_iter=SIZING_ITERS)
    oerr = max(rel(opt.t.cpu(), copt.t),
               float(np.abs(opt.history / copt.history - 1.0).max()))
    check(same_counts(n, {}) and oerr <= SIZING_TOL
          and 0.4 < float(opt.util_max) < 0.6,
          f"optimize_sections (target 0.5, {SIZING_ITERS} iterations): no "
          f"launch {n}; thicknesses {opt.t.tolist()} mm, utilization "
          f"{float(opt.util_max):.4f}, mass {float(opt.mass_t):.1f} t; card "
          f"vs CPU (thicknesses, history) {oerr:.2e} <= {SIZING_TOL:g}")
    out["launches"]["optimize_sections"] = n
    out.update(opt_s=s, opt_err=oerr, t=opt.t.tolist(),
               opt_util=float(opt.util_max), opt_mass=float(opt.mass_t))
    out["opt_rec"] = phase_record(lambda: pt.optimize_sections(
        model, wave, case, target_util=0.5, n_iter=4))
    return out


def io_phase(pt, hk, dev):
    """Model I/O and reports on the card's results: the model written to
    JSON and loaded onto the card, the storm analysis's member-force table,
    CSV and text reports (``render_report`` with the phase scan,
    ``render_code_checks``) against the CPU's (labels equal, numbers
    1e-9), ``validate_sections``; the package and these modules leave
    matplotlib unimported (the plots need it; this host may lack it)."""
    import csv
    import re
    import tempfile
    import numpy as np
    import torch
    from small_fem_solver_tpu_torch.utils import io as tio
    from small_fem_solver_tpu_torch.utils import report as treport
    number = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")
    check("matplotlib" not in sys.modules, "the package, utils.io and "
          "utils.report import no matplotlib")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    _, wave_c, case = storm_inputs(pt, "cpu")
    cpu_model = pt.default_3leg_jacket(device="cpu")
    tio.save_model(f"{tmp}/jacket.json", cpu_model, params={"H": AIRY[0]})
    model, params = tio.load_model(f"{tmp}/jacket.json")
    check(model.device.type == "cuda" and params == {"H": AIRY[0]}
          and bool(torch.equal(model.coords.cpu(), cpu_model.coords)),
          "load_model without device: the model on the card, bit-equal "
          "coordinates, parameters kept")
    wave = pt.airy_wave(*AIRY, device=dev)
    texts, tables = {}, {}
    for label, m, w in (("card", model, wave), ("cpu", cpu_model, wave_c)):
        res = pt.analyze(m, w, case, solver="chol")
        D_m = m.sections.D_outer[m.sect_id] / 1000.0
        scan = pt.phase_scan(w, m.coords, m.conn, D_m, 38.0, 38.0, 0.7, 2.0,
                             1025.0, n_steps=36)
        texts[label] = (treport.render_report(m, w, case, res,
                                              phase_scan=scan)
                        + treport.render_code_checks(m, res))
        tio.export_csv(f"{tmp}/{label}.csv", m, res)
        with open(f"{tmp}/{label}.csv") as f:
            tables[label] = list(csv.reader(f))
    a, b = texts["card"], texts["cpu"]
    same = number.sub("#", a) == number.sub("#", b)
    nums = [(float(x), float(y)) for x, y in zip(number.findall(a),
                                                 number.findall(b))]
    terr = max(abs(x - y) / max(abs(y), 1e-300) for x, y in nums)
    ca, cb = tables["card"], tables["cpu"]
    xa = np.array([r[4:] for r in ca[1:]], float)
    xb = np.array([r[4:] for r in cb[1:]], float)
    cerr = float((np.abs(xa - xb).max(axis=0)
                  / np.abs(xb).max(axis=0).clip(1e-300)).max())
    check(same and terr <= TEXT_TOL and ca[0] == tio.CSV_COLUMNS
          and [r[:4] for r in ca] == [r[:4] for r in cb] and cerr <= TEXT_TOL,
          f"reports and CSV of the card's analysis vs the CPU's: text equal "
          f"{same}, {len(nums)} numbers {terr:.2e}, CSV {cerr:.2e} <= "
          f"{TEXT_TOL:g}")
    msgs = pt.validate_sections(pt.tube_sections([2000.0, 800.0],
                                                 [75.0, 90.0], device=dev))
    check(len(msgs) == 1 and "D/t" in msgs[0],
          f"validate_sections on the card: {msgs}")
    shutil.rmtree(tmp, ignore_errors=True)
    return {"numbers": len(nums), "err": terr,
            "matplotlib": _has_module("matplotlib")}


# the CLI phase: every subcommand of small_fem_solver_tpu_torch.cli at its
# defaults on the card (a climate file where one is required; the scatter
# routes of fatigue on CLI_STATES)
CLI_STATES = "[[4.0, 8.0, 0.5], [8.0, 9.4, 0.1], [6.0, 9.0, 0.2, 120.0]]"
CLI_FLAGSHIP_TOL = 1e-9   # refined (f64) vs the script's own f64 scan
CLI_GOLDEN_TOL = 1e-8     # run --wave-model airy --json-out vs the golden
CLI_GUI_TOL = 1e-12       # gui.run_analysis_core vs the CLI's run JSON
CLI_CPU_WORKERS = 3       # processes of the CPU references (spawn)
# K1's launches by instance of the condensed invocations: an f64 model's
# default (fused) scan and envelope launch the f64 instance
CLI_K1 = {"refined": {"f64": 1}, "refined_f32": {"f32": 1},
          "envelope": {"f64": 8}}
CLI_CPU_THREADS = 2       # torch threads in each


def cli_invocations(out: str, clim: str) -> list:
    """(label, argv, compared with --device cpu) of the CLI phase: all 23
    subcommands at the CLI's defaults, the second forms the phase needs,
    and the 126-DOF invocations compared with their CPU runs.  ``out`` is
    the directory of the output files."""
    return [
        ("run", ["run"], True),
        ("run_airy_scan", ["run", "--phase-scan", "--wave-model", "airy",
                           "--json-out", f"{out}/run.json"], True),
        ("save_default", ["save-default", f"{out}/jacket.json"], True),
        ("sweep", ["sweep"], True),
        ("refined", ["refined"], False),
        ("refined_f32", ["refined", "--f32"], False),
        ("envelope", ["envelope"], False),
        ("modes", ["modes"], True),
        ("dynamic", ["dynamic"], True),
        ("transient", ["transient"], False),
        ("transient_spectrum", ["transient", "--spectrum", "jonswap"], False),
        ("buckling", ["buckling"], True),
        ("pdelta", ["pdelta"], True),
        ("pushover", ["pushover"], True),
        ("pushover_rose", ["pushover", "--rose", "16"], True),
        ("robustness", ["robustness"], True),
        ("code_check", ["code-check"], True),
        ("joint_check", ["joint-check"], True),
        ("viv", ["viv"], True),
        ("air_gap", ["air-gap"], True),
        ("pile", ["pile"], True),
        ("pile_analysis", ["pile", "--from-analysis", "--analyze"], True),
        ("seismic", ["seismic"], True),
        ("fatigue", ["fatigue"], True),
        ("fatigue_spectrum", ["fatigue", "--spectrum", "jonswap"], True),
        ("fatigue_scatter", ["fatigue", "--scatter", CLI_STATES], False),
        ("fatigue_freq_domain", ["fatigue", "--scatter", CLI_STATES,
                                 "--freq-domain", "--dynamic"], False),
        ("spectral", ["spectral"], False),
        ("spectral_dynamic", ["spectral", "--dynamic"], False),
        ("contour", ["contour", "--scatter", clim, "--envelope"], True),
        ("contour_spectral", ["contour", "--scatter", clim, "--spectral"],
         False),
        ("reliability", ["reliability", "--scatter", clim], True),
        # a threshold the climate reaches, on the reliability phase's Airy
        # design waves, so FORM converges and the check runs
        ("reliability_mc", ["reliability", "--scatter", clim,
                            "--wave-model", "airy", "--threshold",
                            str(RELI_THRESHOLD), "--monte-carlo",
                            str(IS_SAMPLES)], True),
        ("optimize", ["optimize"], True),
    ]


def cli_cpu_stdout(argv) -> str:
    """stdout of the port's CLI with ``--device cpu`` (a worker of the CLI
    phase's process pool)."""
    import contextlib
    import io
    import torch
    torch.set_num_threads(CLI_CPU_THREADS)
    from small_fem_solver_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        cli.main([*argv, "--device", "cpu"])
    return buf.getvalue()


def cli_card_stdout(argv) -> tuple:
    """(stdout, stderr) of the port's CLI in this process, on the card (no
    ``--device``)."""
    import contextlib
    import io
    from small_fem_solver_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(list(argv))
    return out.getvalue(), err.getvalue()


class spy:
    """Replace ``module.name`` by a wrapper that records each call's
    arguments and result, for the duration of a ``with`` block."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapped(*a, **k):
            res = fn(*a, **k)
            self.calls.append((a, k, res))
            return res
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class f64_shapes(spy):
    """The shapes (C, S, M, Q, N, n_nodes, wheeler) of every launch call of
    K1's case-batched f64 instance inside the block, as a list; ``args``
    keeps each call's operands (kernel operands, wheeler) to time it
    again."""

    def __init__(self, hk):
        super().__init__(hk, "launch_morison_batch64")

    def __enter__(self):
        super().__enter__()
        return self.calls

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.args = [a for a, _, _ in self.calls]
        self.calls[:] = [(k["C"], k["ts"].shape[1], k["conn"].shape[0],
                          len(k["s"]), k["E"].shape[1], k["coords"].shape[0],
                          bool(wheeler))
                         for (k, wheeler), _, _ in self.calls]


def shape_bounds(shapes) -> dict:
    """``harm64_bound`` of each distinct K1 f64 launch shape, keyed by its
    text, with the number of launch calls of that shape."""
    out = {}
    for C, S, M, Q, N, n_nodes, wheeler in shapes:
        key = (f"C={C}, S={S}, M={M}, Q={Q}, N={N}"
               + (", Wheeler" if wheeler else ""))
        b = out.setdefault(key, dict(harm64_bound(S, M, Q, N, n_nodes, C,
                                                  wheeler), calls=0))
        b["calls"] += 1
    return out


def cli_library_counts(pt, hk, dev, label):
    """(result, launch counts) of :func:`cli_library_call`."""
    import torch
    call = cli_library_call(pt, dev, label)
    hk.launch_counts(reset=True)
    res = call()
    torch.cuda.synchronize()
    return res, hk.launch_counts()


def cli_library_call(pt, dev, label):
    """The script's own library call with the arguments of a CLI
    invocation: the flagship scan of ``refined`` (f64 or f32) at the CLI's
    defaults, or the FORM and the 1,000-sample importance check of
    ``reliability --monte-carlo``."""
    import torch
    dtype = torch.float32 if label == "refined_f32" else torch.float64
    case = pt.LoadCase(**CASE, wind_dir_deg=38.0)
    coarse = pt.default_3leg_jacket(dtype=dtype, device=dev)
    if label.startswith("refined"):
        refined = pt.refine_model(coarse, N_SEG)
        wave = pt.make_wave(*AIRY[:3], U_c=AIRY[3], model="auto", N=10,
                            dtype=dtype, device=dev)

        def call():
            return pt.phase_scan_condensed(coarse, refined, N_SEG, wave, case,
                                           n_steps=N_STEPS, accel="fd",
                                           solve_dtype=dtype)
    else:
        joint = reliability_climate(pt)
        kw = dict(d=AIRY[2], U_c=AIRY[3], wave_model="airy", N=10,
                  n_steps=12)

        def call():
            rel = pt.environmental_reliability(
                pt.utilization_response(coarse, case, **kw), joint,
                RELI_THRESHOLD, max_iter=30)
            return pt.importance_sample_batch(pt.hs_tp_limit_state_batch(
                pt.utilization_response_batch(coarse, case, **kw), joint,
                RELI_THRESHOLD), rel.form, n_samples=IS_SAMPLES)
    return call


def cli_phase(pt, hk, dev):
    """Every subcommand of the port's CLI on the card, in this process
    through ``cli.main(argv)`` with stdout captured, at the CLI's defaults
    (:func:`cli_invocations`): each exits cleanly; K1's and the sweep's
    launches read around exactly that call (``hk.launch_counts``), and for
    ``refined`` (f64 and f32) and ``reliability --monte-carlo`` equal to the
    script's own library call with the same arguments
    (:func:`cli_library_counts`); the f64 ``refined``'s critical
    utilization within 1e-9 of that call's, the f32 one's within
    MAX_UTIL_TOL; the importance check's pf and cov equal to it; the
    126-DOF invocations' stdout equal to the same argv with ``--device
    cpu`` (``tests/cli_text.py``: numbers within one unit of their last
    digit; the CPU runs in a pool of spawned processes while the card
    runs); ``run --wave-model airy --json-out`` against the default golden
    at 1e-8; ``python -m small_fem_solver_tpu_torch.cli`` once as a
    subprocess, its JSON equal to the in-process one; the shapes of K1's
    f64 launches with their ``harm64_bound``; each invocation's host wall
    time."""
    import concurrent.futures
    import contextlib
    import functools
    import multiprocessing
    import tempfile
    import numpy as np
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from cli_text import text_diff
    from small_fem_solver_tpu_torch import api
    from small_fem_solver_tpu_torch.ops import reliability as rel_mod
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    card_dir, cpu_dir = f"{tmp}/card", f"{tmp}/cpu"
    os.makedirs(card_dir)
    os.makedirs(cpu_dir)
    clim = f"{tmp}/climate.json"
    with open(clim, "w") as f:
        json.dump(np.stack(climate_states(), axis=1).tolist(), f)
    inv = cli_invocations(card_dir, clim)
    out = {"launches": {}, "wall_s": {}, "cpu_diff": {}, "f64_shapes": {},
           "f64_times": {}}
    f64_args = {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(CLI_CPU_WORKERS,
                                                mp_context=ctx) as pool:
        cpu = {label: pool.submit(cli_cpu_stdout, [a.replace(card_dir,
                                                             cpu_dir)
                                                   for a in argv])
               for label, argv, compare in inv if compare}
        texts = {}
        for label, argv, _ in inv:
            watch = {"refined": spy(api, "phase_scan_condensed"),
                     "refined_f32": spy(api, "phase_scan_condensed"),
                     "reliability_mc": spy(rel_mod,
                                           "importance_sample_batch")
                     }.get(label, contextlib.nullcontext())
            hk.launch_counts(reset=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            spy64 = f64_shapes(hk)
            with watch, spy64 as shapes:
                texts[label], err = cli_card_stdout(argv)
            torch.cuda.synchronize()
            out["wall_s"][label] = time.perf_counter() - t0
            n = hk.launch_counts()
            out["launches"][label] = n
            if shapes:
                out["f64_shapes"][label] = shape_bounds(shapes)
                f64_args[label] = (shapes[0], spy64.args[0])
            check(bool(texts[label]), f"cli {' '.join(argv)}: exits cleanly "
                  f"with output ({len(texts[label].splitlines())} lines)")
            print(f"[cli] {label}: {out['wall_s'][label]:.2f} s wall; K1 "
                  f"{n['k1']} (f32 {n['f32']}, f64 {n['f64']}, sea "
                  f"{n['sea_f32'] + n['sea_f64']}), sweep {n['sweep']}",
                  flush=True)
            if label in CLI_K1:
                want = CLI_K1[label]
                got = {k: n[k] for k in ("f32", "f64", "sea_f32", "sea_f64")}
                check(got == {k: want.get(k, 0) for k in got}
                      and n["k1"] == sum(want.values()),
                      f"cli {label}: K1 launches by instance {got} == {want}")
            if label in ("refined", "refined_f32", "reliability_mc"):
                got = watch.calls[-1][2]
                ref, want = cli_library_counts(pt, hk, dev, label)
                same = n == want
                if label == "reliability_mc":
                    err_v = max(abs(got[0] / ref[0] - 1.0),
                                abs(got[1] / ref[1] - 1.0))
                    tol = IS_TOL
                else:
                    ci, cr = int(got.critical_index), int(ref.critical_index)
                    err_v = abs(float(got.utilization[ci].max())
                                / float(ref.utilization[cr].max()) - 1.0)
                    tol = CLI_FLAGSHIP_TOL
                    if label == "refined_f32":
                        f64 = out["refined_util"]
                        err_v = abs(float(got.utilization[ci].max()) / f64
                                    - 1.0)
                        tol = MAX_UTIL_TOL
                    else:
                        out["refined_util"] = float(ref.utilization[cr].max())
                check(same and err_v <= tol,
                      f"cli {label}: launches {n} == the library call's "
                      f"{want} {same}; result vs "
                      + ("the f64 scan" if label == "refined_f32"
                         else "the library call")
                      + f" {err_v:.2e} <= {tol:g}")
                out[f"{label}_err"] = err_v

        # the module entry point, as a user runs it
        sub_json = f"{card_dir}/sub.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "small_fem_solver_tpu_torch.cli", "run",
             "--phase-scan", "--wave-model", "airy", "--json-out", sub_json],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=300)
        out["subprocess_s"] = time.perf_counter() - t0
        with open(f"{card_dir}/run.json") as f:
            run_json = json.load(f)
        same = proc.returncode == 0 and os.path.exists(sub_json)
        if same:
            with open(sub_json) as f:
                same = json.load(f) == run_json
        check(same, f"python -m small_fem_solver_tpu_torch.cli run "
              f"--phase-scan --wave-model airy --json-out: exit "
              f"{proc.returncode}, JSON equal to the in-process run {same} "
              f"({out['subprocess_s']:.1f} s){proc.stderr[-1500:]}")

        # the 126-DOF invocations against their CPU runs
        t0 = time.perf_counter()
        for label, fut in cpu.items():
            bad = text_diff(texts[label],
                            fut.result().replace(cpu_dir, card_dir))
            out["cpu_diff"][label] = len(bad)
            check(not bad, f"cli {label}: card stdout vs --device cpu: "
                  + ("equal by the CLI rule" if not bad
                     else "; ".join(bad[:5])))
        out["cpu_wait_s"] = time.perf_counter() - t0

    # K1 f64's device time at the first launch of each invocation that
    # launched it, on that launch's own operands, beside its bound (these
    # launches are outside every count window)
    for label, (shape, (k, wheeler)) in f64_args.items():
        def launch(k=k, wheeler=wheeler):
            return hk.launch_morison_batch64(k, wheeler)
        dev_us = harm64_us(device_events(launch, SHORT_REPS))
        C, S, M, Q, N, n_nodes, _ = shape
        bound = harm64_bound(S, M, Q, N, n_nodes, C, wheeler)
        out["f64_times"][label] = {
            "shape": f"C={C}, S={S}, M={M}, Q={Q}, N={N}"
                     + (", Wheeler" if wheeler else ""),
            "device_us": dev_us, "bound": bound,
            "share": bound["us"] / dev_us["total"],
            "ms": cuda_ms(launch, n=10)}
    # the f64 refined scan at the CLI's defaults, through K1 f64
    reps = 3
    events = device_events(cli_library_call(pt, dev, "refined"), reps)
    out["refined_busy"] = {
        "ops": len(events) / reps,
        "busy_ms": sum(t for _, t in events) / 1e3 / reps,
        "k1_us": harm64_us(events)["total"], "top": top_device_ops(events)}

    # run --wave-model airy --json-out against the default golden
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "default_case.json")) as f:
        fem = json.load(f)["fem"]
    disp = np.linalg.norm(np.asarray(fem["U"]).reshape(-1, 6)[:, :3], axis=1)
    f64 = functools.partial(np.asarray, dtype=np.float64)
    errs = {"utilization": allclose_err(
                f64([m["utilization"] for m in run_json["member_forces"]]),
                f64([m["utilization"] for m in fem["internal_forces"]])),
            "reactions": allclose_err(
                f64(list(run_json["reactions"].values())),
                f64([fem["reactions"][k] for k in run_json["reactions"]])),
            "max_displacement_mm": abs(run_json["max_displacement_mm"]
                                       / disp.max() - 1.0)}
    check(max(errs.values()) <= CLI_GOLDEN_TOL,
          "cli run --wave-model airy --json-out vs the default golden: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" <= {CLI_GOLDEN_TOL:g}")
    out.update(golden=errs, run_json=run_json, texts=texts)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


class _FakeText:
    """A Text widget's insert/delete, for the GUI's handlers without Tk."""

    def __init__(self):
        self.buf = []

    def delete(self, *a):
        self.buf = []

    def insert(self, where, txt):
        self.buf.append(txt)


def gui_handler_text(gui, out: dict, handler: str) -> str:
    """The text a Results-tab handler of ``gui.JacketGUI`` writes for the
    results ``out`` of ``run_analysis_core``, driven through a stub."""
    class Stub:
        analysis_results = out["res"]
        analysis_model = out["model"]
        analysis_wave = out["wave"]
        analysis_case = out["case"]
        results_text = _FakeText()
    Stub.handler = getattr(gui.JacketGUI, handler)
    s = Stub()
    s.handler()
    return "".join(s.results_text.buf)


def gui_phase(pt, hk, dev, run_json: dict) -> dict:
    """The GUI's headless core on the card: ``run_analysis_core`` of the
    untouched GUI's storm on the Airy wave with its phase scan (no
    ``device``) against the default golden (1e-8) and the CLI's ``run
    --phase-scan --wave-model airy`` JSON (1e-12); ``show_damage_screen``
    and ``show_spectral_fatigue`` driven through stubs on the card's
    results, their text against the CPU's by the CLI rule; Tk is not
    imported."""
    import numpy as np
    from small_fem_solver_tpu_torch import gui
    from small_fem_solver_tpu_torch.models.presets import \
        default_3leg_jacket_geometry
    from cli_text import text_diff
    p = gui.parse_params(dict(gui.DEFAULT_RAW_PARAMS, wave_model="airy"))
    geo = default_3leg_jacket_geometry(47.0)
    card, n, s = counted(hk, lambda: gui.run_analysis_core(p, *geo))
    cpu = gui.run_analysis_core(p, *geo, device="cpu")
    check(card["model"].device.type == "cuda",
          f"run_analysis_core without device runs on {card['model'].device}")
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "golden", "default_case.json")) as f:
        g = json.load(f)
    model, res = card["model"], card["res"]
    gerr = max(golden_errors(res, model, g["fem"]).values())
    cli_err = max(
        nrel(res.utilization, [m["utilization"]
                               for m in run_json["member_forces"]]),
        nrel(res.reactions, list(run_json["reactions"].values())),
        abs(float(res.max_displacement_mm)
            / run_json["max_displacement_mm"] - 1.0))
    check(gerr <= CLI_GOLDEN_TOL and cli_err <= CLI_GUI_TOL,
          f"gui.run_analysis_core on the card vs the default golden "
          f"{gerr:.2e} <= {CLI_GOLDEN_TOL:g}, vs the CLI's run JSON "
          f"{cli_err:.2e} <= {CLI_GUI_TOL:g}; launches {n}")
    out = {"s": s, "golden_err": gerr, "cli_err": cli_err, "launches": n}
    for handler in ("show_damage_screen", "show_spectral_fatigue"):
        t0 = time.perf_counter()
        text = gui_handler_text(gui, card, handler)
        out[f"{handler}_s"] = time.perf_counter() - t0
        bad = text_diff(text, gui_handler_text(gui, cpu, handler))
        check(len(text.splitlines()) > 10 and not bad,
              f"gui {handler} through a stub on the card's results: "
              f"{len(text.splitlines())} lines, vs the CPU's "
              + ("equal by the CLI rule" if not bad else "; ".join(bad[:5])))
    check("tkinter" not in sys.modules, "the GUI's headless core and "
          "handlers import no tkinter")
    out["util"] = float(np.asarray(res.utilization.cpu()).max())
    return out


def _has_module(name: str) -> bool:
    """Whether ``name`` is installed on this host (found, not imported)."""
    import importlib.util
    return importlib.util.find_spec(name) is not None


def main() -> int:
    t_start = time.perf_counter()
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
    global SMI
    name, count, smi = (torch.cuda.get_device_name(0),
                        torch.cuda.device_count(), smi_line())
    SMI = smi
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
            # the kernel's outputs and the fixed-order nodal sum after it
            check(all(torch.equal(getattr(out, f), getattr(again, f))
                      for f in fields), f"kernel bit-repeatable ({label})")

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
    scan_sweeps = [(f"flagship scan loads, nested level {i + 1}", *op)
                   for i, op in enumerate(record_sweeps(
                       condense_mod, hk, lambda: condense_mod
                       .condense_loads_nested(prep.fac, g_scan)))]
    check(len(scan_sweeps) == 2, "the nested condensation ran two sweeps")
    check(scan_sweeps[0][3] and not scan_sweeps[0][2].is_contiguous(),
          "level 1 reads the (m, q) view of the scan's loads in place")
    # B = 360 and 37 take the wide form, 18 and 1 the narrow one
    sweep_inputs = [(f"{label}, random 1e5 loads{', transposed' * tr}", fac,
                     sweep_loads(fac, B, seed, tr), False)
                    for seed, (label, fac) in enumerate(sweep_facs.items())
                    for B in (N_STEPS, 37, 18, 1) for tr in (False, True)]
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
        rg = hk.sweep_narrow_rhs(B, n_int, 4)
        form = (f"narrow, {rg} right-hand sides a warp" if rg else
                f"wide, tile {hk.SWEEP_LANES}x"
                f"{hk.sweep_chains_per_block(n_int, 4)}")
        print(f"[sweep] {label}: n_int={n_int} chains={Mc} {form} "
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

    # the wrappers on the scan's operands (0-d tensor coefficients on the
    # card, the transposed chain layout): no synchronisation (PyTorch's sync
    # debug mode raises on one) and nothing but the kernels on the device,
    # in the run's first profiler sessions (see device_events)
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
        ops = [n for n, _ in device_events(fn, SHORT_REPS)]
        check(ops and all("kernel" in n for n in ops), f"{kname} wrapper: "
              f"{len(ops)} device operations in {SHORT_REPS} calls, all its "
              f"kernels ({sorted(set(ops))}), no host-to-device copy, no "
              "synchronisation")

    # ---- K1's f64 instance (after the wrappers' first profiler sessions)
    t0 = time.perf_counter()
    waves_d, cases_d, H_d, dir_d = design_batch(pt)
    n_design = len(H_d)
    print(f"[design] {n_design}-case batch (50 Stokes-5 waves, one host "
          f"solve): {time.perf_counter() - t0:.2f} s", flush=True)
    k64 = k1_f64_phase(pt, hk, dev, coarse64, refined64, wave64, waves_d,
                       dir_d)
    # the f32 instance at the dense envelope's shapes (36 phases, 51
    # members, Stokes-5 with 8 modes: its NMAX = 8 template instance), with
    # Wheeler stretching and per-member Cd / Cm, as the f32 model's
    # envelope (phase 12) runs it
    def dense_args(dtype, args=k64["dense"]):
        return (*hk.cast_operands(dtype, dev, *args[:2]), args[2],
                *hk.cast_operands(dtype, dev, *args[3:]))
    d32 = dense_args(f32)
    d64 = dense_args(f64, d32)     # the same (f32-rounded) inputs
    before = hk.morison_phase_batch_cuda.instance_launches["f32"]
    out = hk.morison_phase_batch_cuda(*d32, stretching="wheeler")
    torch.cuda.synchronize()
    n = hk.morison_phase_batch_cuda.instance_launches["f32"] - before
    ref = morison_phase_batch(*d64, stretching="wheeler")
    errs = {f: rel(getattr(out, f), getattr(ref, f)) for f in fields}
    print(f"[kernel] dense envelope shapes, Wheeler, per-member Cd/Cm: "
          f"S={DESIGN_STEPS} M={coarse64.n_members} N={d64[0].n_modes} max "
          "rel err " + " ".join(f"{f}={e:.2e}" for f, e in errs.items()),
          flush=True)
    check(n == 1 and out.F1.dtype == f32
          and all(torch.isfinite(getattr(out, f)).all() for f in fields),
          f"K1 f32 instance launched once ({n}), outputs finite (dense "
          "envelope shapes)")
    check(max(errs.values()) < KERNEL_TOL, f"kernel vs f64 plain (dense "
          f"envelope shapes): {max(errs.values()):.2e} < {KERNEL_TOL:g}")
    # its device time as the f32 model's dense envelope launches it (no
    # stretching), beside the bound of that launch's shapes
    ev = device_events(lambda: hk.morison_phase_batch_cuda(*d32),
                       SHORT_REPS)
    k1d = {k: kernel_median_us(ev, k) for k in
           ("morison_phase_batch_kernel", "morison_totals_kernel")}
    k1d_bound = k1_f32_bound(DESIGN_STEPS, coarse64.n_members, 15,
                             d64[0].n_modes, coarse64.n_nodes)
    k1d_us = sum(k1d.values())
    print(f"[bound] {smi}: K1 f32 at the dense envelope's shapes (S="
          f"{DESIGN_STEPS}, M={coarse64.n_members}, Q=15, N="
          f"{d64[0].n_modes}, no stretching): "
          f"{k1d['morison_phase_batch_kernel']:.1f} + "
          f"{k1d['morison_totals_kernel']:.1f} us on the device; bound "
          f"{k1d_bound[0]:.3f} us by {k1d_bound[1]} "
          f"({k1d_bound[3] / 1e6:.2f} MFLOP, {k1d_bound[2] / 1e3:.1f} kB): "
          f"{k1d_bound[0] / k1d_us:.1%} of the bound (torch.profiler)",
          flush=True)
    kernel_rel = max(kernel_rel, max(errs.values()))
    # K1's case-batched f32 instance: the 1,000 cases of an f32 model's
    # dense envelope in one launch
    t0 = time.perf_counter()
    kb32 = k1_f32_batch_phase(pt, hk, dev, k64["dense_b"], coarse64.n_nodes)
    print(f"[kernel f32 batch] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    # the pointwise kernel at the slam scan's shapes
    t0 = time.perf_counter()
    pw = pointwise_phase(pt, hk, dev, prep)
    print(f"[pointwise] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)

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

    # ---- 7. reference phase: the six goldens through analyze ----
    t0 = time.perf_counter()
    ref_ms = reference_phase(pt, dev)
    print(f"[reference] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)

    # ---- 8. dense-at-size phase: 9,612 DOF in f64 ----
    t0 = time.perf_counter()
    dense = dense_phase(pt, hk, dev, coarse64, refined64, wave64, ref)
    print(f"[dense] phase {time.perf_counter() - t0:.2f} s wall", flush=True)

    # ---- 9. large phase: 99,882 DOF in f64 ----
    t0 = time.perf_counter()
    large = large_phase(pt, hk, dev, coarse64, wave64)
    print(f"[large] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    print(f"[time] {smi}: analyze 126 DOF (Cholesky) {ref_ms:.3f} ms; dense "
          f"analyze 9,612 DOF Cholesky {dense['dense_chol_ms']:.1f} ms, LU "
          f"{dense['dense_lu_ms']:.1f} ms, analyze_phase_batch (36 phases) "
          f"{dense['phase_batch_ms']:.1f} ms, pointwise f64 360-phase scan "
          f"{dense['pointwise_ms']:.1f} ms; 99,882 DOF: analyze_condensed "
          f"one-shot {large['analyze_condensed_ms']:.1f} ms, "
          f"prepare_condensed {large['prepare_ms']:.1f} ms, analyze_prepared "
          f"{large['analyze_prepared_ms']:.1f} ms (medians, CUDA events)",
          flush=True)
    print(f"[profile] {smi}: analyze_prepared at 99,882 DOF: "
          f"{large['prepared_ops']} device operations, device busy "
          f"{large['prepared_busy_ms']:.3f} ms, {large['prepared_sweeps']} "
          f"chain-sweep kernels; most time: {large['prepared_top']} "
          "(torch.profiler)", flush=True)
    for label, (a, b, d, bd, by, nb, err, shape, warm) in \
            large["levels"].items():
        print(f"[bound] {smi}: chain sweep f64 at 99,882 DOF {label} "
              f"(B, n_int, chains) = {shape}: {d:.1f} us on the device with "
              f"a cold L2 ({warm:.1f} us warm), bound {bd:.2f} us by {by} "
              f"({nb / 1e6:.2f} MB): {bd / d:.1%}; wrapper {a:.4f} ms (warm), "
              f"plain loop {b:.4f} ms, f64 vs plain {err:.1e}", flush=True)

    # ---- 10. timing of the scan and envelope paths ----
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

    # K1: its two kernels (fused pass + fixed-order totals) on one launch
    ev = device_events(lambda: hk.launch_morison(k_ops, False), SHORT_REPS)
    k1_us = (kernel_us(ev, "morison_phase_batch_kernel")
             + kernel_us(ev, "morison_totals_kernel"))
    S_, M_, Q_, N_ = N_STEPS, Mr, 15, wave32.n_modes
    k1_bytes = 4 * (2 * S_ * M_ * 3 + S_ * 6 + S_ + 2 * N_ + 4
                    + refined32.n_nodes * 3 + M_) + 8 * 2 * M_
    # the mode sums, [S, 2N] phase factors times [2N, P] spatial records
    # for five fields, and the elementwise epilogue
    k1_mode_flops = S_ * M_ * Q_ * 2 * 2 * N_ * 5
    k1_epi_flops = S_ * M_ * Q_ * EPILOGUE_FLOP
    k1_flops = k1_mode_flops + k1_epi_flops
    k1_bound, k1_by = bound_us(k1_bytes, k1_flops)
    print(f"[bound] {smi}: K1 {k1_us:.1f} us on the device "
          f"(fused pass {kernel_us(ev, 'morison_phase_batch_kernel'):.1f} "
          f"+ totals {kernel_us(ev, 'morison_totals_kernel'):.1f}); bound "
          f"{k1_bound:.1f} us by {k1_by} ({k1_flops / 1e9:.2f} GFLOP, "
          f"{k1_bytes / 1e6:.1f} MB): {k1_bound / k1_us:.0%} of the bound; "
          f"{scan_launches['morison_phase_batch'] // 2} launch per scan, "
          f"{env_launches['morison_phase_batch']} per envelope call "
          f"(torch.profiler)", flush=True)

    # K1's f64 instance: its device time against its bound at each shape
    # (k1_f64_phase printed them)
    f64_flag = k64["shapes"]["flagship, none"]
    k64_us, k64_ms = f64_flag["device_us"]["total"], f64_flag["ms"]
    p64_ms, k64_bound = f64_flag["plain_ms"], f64_flag["bound"]["us"]
    k64_by = f64_flag["bound"]["by"]

    # the sweep at the main path's own operands and layouts
    sweep_runs = {"nested level 1": scan_sweeps[0][1:],
                  "nested level 2": scan_sweeps[1][1:],
                  "thomas": (prep_th.fac, g_scan, False)}
    sweep_ms = {}
    for label, (fac, g, split) in sweep_runs.items():
        B, (n_int, Mc) = N_STEPS, fac.Cprime.shape[:2]
        g_chain = (g.reshape(*g.shape[:-3], -1, 6) if split else g)
        us = kernel_us(device_events(
            lambda: hk.chain_sweep_cuda(fac, g, split), SHORT_REPS),
            SWEEP_KERNEL)
        sweep_ms[label] = (
            cuda_ms(lambda: hk.chain_sweep_cuda(fac, g, split)),
            cuda_ms(lambda: chain_sweep_plain(fac, g_chain)),
            us, *sweep_bound(4, B, n_int, Mc))
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
        n_sweep = sum(SWEEP_KERNEL in n for n, _ in events)
        print(f"[profile] {smi}: {label}: {len(events)} device operations "
              f"({len(events) / per:.0f} per scan; {n_sweep} chain-sweep "
              f"kernels), device busy {busy:.3f} ms ({busy / per:.3f} ms "
              f"per scan); K1 {kernel_us(events, 'morison_phase_batch'):.1f}"
              f" us, sweep {kernel_us(events, SWEEP_KERNEL):.1f} us "
              f"per launch (torch.profiler)" if events else
              f"[profile] {label}: torch.profiler recorded no device "
              "events: not measured", flush=True)

    # ---- 11. options phase: 9,612 DOF in f64 on foundation springs ----
    t0 = time.perf_counter()
    options = options_phase(pt, hk, dev, wave64)
    print(f"[options] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    t0 = time.perf_counter()
    env64f = f64_envelope_phase(pt, hk, dev, coarse64)
    print(f"[options] f64 condensed envelope check "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)

    # ---- 12-14. dense design tier: 1,000 cases on the default jacket ----
    t0 = time.perf_counter()
    env_d, denv = dense_envelope_phase(pt, hk, dev, coarse64, waves_d,
                                       cases_d)
    gov = int(env_d.governing_case)
    print(f"[design] dense envelope phase {time.perf_counter() - t0:.2f} s "
          f"wall (CPU f64 reference run {denv['cpu_s']:.2f} s); governing "
          f"case {gov} (H = {H_d[gov]:.2f} m, heading {dir_d[gov]:.0f} deg), "
          f"max utilization {float(env_d.max_util_per_case[gov]):.6f}; vs "
          "CPU f64: " + ", ".join(f"{k} {v:.2e}" for k, v in
                                  denv["errs"].items())
          + f"; vs analyze_phase_batch {denv['gov_err']:.2e}", flush=True)
    t0 = time.perf_counter()
    sweep = sweep_phase(pt, dev, coarse64, waves_d, cases_d)
    print(f"[design] sweep phase {time.perf_counter() - t0:.2f} s wall; "
          f"critical case {sweep['gov']} (max utilization "
          f"{sweep['gov_util']:.6f}); worst field vs analyze "
          f"{sweep['worst']:.2e}", flush=True)
    resume_s = resume_phase(pt, dev, coarse64, waves_d, cases_d, env_d)
    print(f"[time] {smi}: options scan (9,612 DOF x {N_STEPS} phases, f64 "
          f"solve on springs) {options['ms']:.3f} ms; design_envelope "
          f"{n_design} cases x {DESIGN_STEPS} phases @ {coarse64.n_dof} DOF "
          f"{denv['ms']:.1f} ms ({denv['ms'] / n_design:.3f} ms per case; "
          f"first call {denv['first_s']:.2f} s); design_sweep {n_design} "
          f"cases {sweep['ms']:.1f} ms (first call {sweep['first_s']:.2f} "
          f"s); resumable envelope, {RESUME_CHUNK}-case chunks, bounded "
          f"call then resume {resume_s:.2f} s (medians, CUDA events; host "
          "clock for first calls and the resume)", flush=True)
    print(f"[time] {smi}: design_envelope of the f32 model, {n_design} "
          f"cases x {DESIGN_STEPS} phases: {denv['ms_f32']:.2f} ms (median "
          f"of 5, CUDA events), device busy {denv['busy_f32_ms']:.3f} ms, "
          f"K1 f32 batch {denv['k1_f32_us']:.1f} us in its one launch "
          "(torch.profiler)", flush=True)
    print(f"[profile] {smi}: design_envelope ({n_design} cases): "
          f"{denv['ops']} device operations ({denv['ops'] / n_design:.1f} "
          f"per case), device busy {denv['busy_ms']:.3f} ms, K1 "
          f"{denv['k1_us']:.1f} us per launch, peak device memory "
          f"{denv['peak_mib']:.0f} MiB; most time: {denv['top']}; "
          f"design_sweep: {sweep['ops']} device operations, device busy "
          f"{sweep['busy_ms']:.3f} ms (torch.profiler)", flush=True)

    # ---- 15. dynamics at 9,612 DOF in f64 ----
    t0 = time.perf_counter()
    dyn = dynamics_phase(pt, hk, dev, coarse64, refined64, wave64)
    print(f"[dynamics] phase {time.perf_counter() - t0:.2f} s wall "
          f"(CPU f64 reference runs "
          f"{sum(v for k, v in dyn.items() if k.endswith('cpu_s')):.2f} s)",
          flush=True)

    # ---- 16. modal analysis at 99,882 DOF ----
    t0 = time.perf_counter()
    mlarge = modal_large_phase(pt, hk, coarse64, dyn["modal_freqs"])
    print(f"[dynamics] 99,882-DOF modal phase {time.perf_counter() - t0:.2f} s "
          f"wall; periods " + " ".join(f"{p:.5f}" for p in mlarge["periods"])
          + f" s; vs 9,612 DOF {mlarge['err']:.2e}", flush=True)
    for label, r in {**dyn["rec"], "modal 99,882 DOF": mlarge}.items():
        print(f"[time] {smi}: {label}: {r['s'] * 1e3:.1f} ms (host clock, "
              f"synchronised, one call), {r['ops']} device operations, "
              f"device busy "
              f"{r['busy_ms']:.3f} ms, peak device memory "
              f"{r['peak_mib']:.0f} MiB; sweep {r['sweep_us']:.1f} us, K1 "
              f"f64 {r['k1_us']:.1f} us per launch; most time: {r['top']} "
              "(torch.profiler)", flush=True)
    print(f"[time] {smi}: transient march {dyn['steps_per_s']:.0f} steps/s "
          "(1,536 steps, host clock)", flush=True)
    n_int9, n_int99 = N_SEG - 1, N_SEG_LARGE - 1
    b9, by9, _ = sweep_bound(8, 18, n_int9, coarse64.n_members)
    b99, by99, _ = sweep_bound(8, 18, n_int99, coarse64.n_members)
    print(f"[bound] {smi}: chain sweep f64, B=18 (the chain-mode iteration): "
          f"n_int={n_int9} {dyn['rec']['modal']['sweep_us']:.1f} us vs bound "
          f"{b9:.2f} us by {by9}; n_int={n_int99} {mlarge['sweep_us']:.1f} us "
          f"vs bound {b99:.2f} us by {by99} (torch.profiler)", flush=True)
    t0 = time.perf_counter()
    nsw = narrow_sweep_phase(pt, hk, dev, coarse64, refined64, large)
    print(f"[narrow sweep] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)

    # ---- 17-21. irregular seas and the frequency domain ----
    t0 = time.perf_counter()
    ksea = k1_sea_phase(pt, hk, dev, coarse64, refined64)
    print(f"[kernel sea] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    t0 = time.perf_counter()
    cpu_c = pt.default_3leg_jacket(device="cpu")
    cpu_r = pt.refine_model(cpu_c, N_SEG)
    cpu = {"coarse": cpu_c, "refined": cpu_r,
           "prep": pt.prepare_condensed(cpu_c, cpu_r, N_SEG),
           "prep8": pt.prepare_condensed(cpu_c, pt.refine_model(cpu_c, 8), 8),
           "prep8_card": pt.prepare_condensed(
               coarse64, pt.refine_model(coarse64, 8), 8)}
    prep64 = pt.prepare_condensed(coarse64, refined64, N_SEG)
    sea = sea_phase(pt, hk, dev, coarse64, refined64, prep, prep64, cpu,
                    per_scan)
    print(f"[sea] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    t0 = time.perf_counter()
    freq = freq_phase(pt, hk, dev, coarse64, refined64, prep64, cpu,
                      per_scan)
    print(f"[freq] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    t0 = time.perf_counter()
    scat = scatter_phase(pt, hk, dev, coarse64, refined64, prep64, cpu,
                         per_scan)
    print(f"[scatter] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    t0 = time.perf_counter()
    strans = sea_transient_phase(pt, hk, dev, coarse64, refined64, cpu)
    print(f"[sea transient] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    for label, r in {**sea["rec"], **freq["rec"], **scat["rec"],
                     **strans["rec"]}.items():
        print(f"[time] {smi}: {label}: {r['s'] * 1e3:.1f} ms (host clock, "
              f"synchronised, one call"
              + (f"; first call {r['first_s'] * 1e3:.1f} ms"
                 if "first_s" in r else "")
              + f"), {r['ops']} device operations, device busy "
              f"{r['busy_ms']:.3f} ms, peak device memory "
              f"{r['peak_mib']:.0f} MiB; sweep {r['sweep_us']:.1f} us, K1-sea "
              f"{r['k1_sea_us']:.1f} us per launch; most time: {r['top']} "
              "(torch.profiler)", flush=True)
    print(f"[time] {smi}: sea transient march "
          f"{strans['steps_per_s']:.0f} steps/s ({SEA_TRANSIENT_STEPS} "
          "steps, host clock)", flush=True)
    sea_launches = {**sea["launches"], **freq["launches"],
                    **scat["launches"], **strans["launches"]}

    # ---- 22. Queue C: calls past K1's limits pick the plain version ----
    t0 = time.perf_counter()
    qc = queue_c_phase(pt, hk, dev)
    print(f"[queue c] phase {time.perf_counter() - t0:.2f} s wall; "
          + "; ".join(f"{k}: {v['launches']} K1 launches, "
                      f"{v['plain_routes']} plain route, card vs CPU "
                      + ", ".join(f"{f} {e:.2e}" for f, e in
                                  v["errs"].items())
                      for k, v in qc.items()), flush=True)

    # ---- 23-25. the sparse and iterative tier ----
    t0 = time.perf_counter()
    pcg = pcg_phase(pt, dev, coarse64, refined64)
    print(f"[pcg] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    t0 = time.perf_counter()
    pcgl = pcg_large_phase(pt, dev, large)
    print(f"[pcg large] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    t0 = time.perf_counter()
    asmb = assembly_phase(pt, large)
    print(f"[assembly] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    for label, n_dof, prof in (
            ("9,612 DOF", refined64.n_dof, pcg["profile"]),
            ("99,882 DOF", N_DOF_LARGE, pcgl["profile"])):
        print(f"[profile] {smi}: PCG two-level iteration at {label}: "
              f"{prof['ops_per_iter']:.1f} device operations, device busy "
              f"{prof['busy_us_per_iter']:.1f} us an iteration "
              f"({PCG_PROFILE_ITERS} iterations in one session); bound "
              f"{prof['iter_bound_us']:.2f} us by bytes "
              f"({prof['iter_bytes'] / 1e6:.1f} MB an iteration, "
              f"{prof['n_blocks']} blocks, {prof['n_agg']} aggregates): "
              f"{prof['iter_bound_us'] / prof['busy_us_per_iter']:.1%}; "
              f"bcsr_matvec {prof['matvec_us']:.1f} us on the device "
              f"({prof['matvec_ops']:.1f} operations) vs bound "
              f"{prof['matvec_bound_us']:.2f} us by {prof['matvec_by']} "
              f"({prof['matvec_bytes'] / 1e6:.1f} MB): "
              f"{prof['matvec_bound_us'] / prof['matvec_us']:.1%}; most "
              f"time: {prof['top']} (torch.profiler)", flush=True)
    print(f"[time] {smi}: PCG at {refined64.n_dof} DOF, tol {PCG_TOL:g}: "
          + "; ".join(f"{k} {pcg['iters'][k]} iterations, "
                      f"{pcg['ms'][k]:.1f} ms CUDA events, "
                      f"{pcg['wall_s'][k] * 1e3:.1f} ms wall "
                      f"({pcg['ms'][k] * 1e3 / pcg['iters'][k]:.1f} us an "
                      "iteration)" for k in pcg["iters"])
          + f"; peak device memory of a two-level solve {pcg['peak_mib']:.0f}"
          " MiB above the process's (one synchronised call each)",
          flush=True)
    print(f"[time] {smi}: PCG at {N_DOF_LARGE} DOF (two-level, chunks of "
          "200): " + "; ".join(
              f"{label}, tol {tol:g}: {r['iters']} iterations, "
              f"{r['ms'][0]:.1f} / {r['ms'][1]:.1f} ms CUDA events, "
              f"{r['wall_s'][0] * 1e3:.1f} / {r['wall_s'][1] * 1e3:.1f} ms "
              f"wall ({r['ms'][1] * 1e3 / r['iters']:.1f} us an iteration)"
              for (label, tol), r in pcgl["runs"].items())
          + f"; peak device memory of the bench's solve "
          f"{pcgl['peak_mib']:.0f} MiB above the process's (two "
          "synchronised calls each)", flush=True)
    for label, r in asmb.items():
        print(f"[time] {smi}: direct-write assembly {label} at "
              f"{N_DOF_LARGE} DOF: single {r['single_ms']:.3f} ms = "
              f"{r['gdofs_single']:.3f} GDOF/s, sustained (64 in a row) "
              f"{r['sustained_ms']:.3f} ms = {r['gdofs_sustained']:.3f} "
              f"GDOF/s (CUDA events); {r['ops']:.0f} device operations, "
              f"{r['device_us']:.1f} us on the device vs bound "
              f"{r['bound_us']:.2f} us by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.1f} MB): "
              f"{r['bound_us'] / r['device_us']:.1%}; vs generic "
              f"{r['err']:.2e}; most time: {r['top']} (torch.profiler)",
              flush=True)

    # ---- 26-28. distribution and second-order analysis ----
    flag = dict(coarse32=coarse32, refined32=refined32, waves32=waves32,
                cases=cases, env=env, launches=env_launches)
    design = dict(coarse64=coarse64, waves=waves_d, cases=cases_d, env=env_d)
    t0 = time.perf_counter()
    d1 = dist_one_rank_phase(pt, hk, dev, flag, design, large, pcgl)
    print(f"[dist 1 rank] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    t0 = time.perf_counter()
    d2 = dist_two_rank_phase(pt, hk, dev, flag, design, refined64)
    print(f"[dist 2 ranks] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    t0 = time.perf_counter()
    pdl = pdelta_phase(pt, hk, dev, coarse64, refined64, wave64, large)
    print(f"[pdelta] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    bench1 = d1["pcg"]["bench (accel fd)"]
    print(f"[time] {smi}: distributed PCG, 1 rank (NCCL), {N_DOF_LARGE} "
          "DOF, the bench's call: " + "; ".join(
              f"{label}: {r['iters']} iterations (single device "
              f"{r['single']}), wall {r['wall_s'][0]:.3f} / "
              f"{r['wall_s'][1]:.3f} s = {r['wall_s'][1] * 1e6 / r['iters']:.0f}"
              f" us an iteration with set-up, CUDA events {r['ms'][1]:.1f} ms"
              for label, r in d1["pcg"].items())
          + f"; {bench1['per_iter']:.3f} collectives an iteration step "
          f"({bench1['collectives']} in {bench1['steps']} steps, host-staged "
          "bytes "
          f"{bench1['host_bytes']}); device busy {d1['pcg_busy_us']:.1f} us "
          f"and {d1['pcg_ops']:.1f} device operations an iteration "
          f"(difference of {PCG_PROFILE_ITERS}- and "
          f"{2 * PCG_PROFILE_ITERS}-iteration solves, torch.profiler); "
          "host time a call: " + ", ".join(
              f"{k} {v:.1f} us" for k, v in d1["host_us"].items()) + "; "
          "in a new single-rank process: " + "; ".join(
              f"{label}, {stage}: " + ", ".join(f"{k} {v:.1f} us"
                                                for k, v in r.items())
              for label, stages in d1["host_us_fr"].items()
              for stage, r in stages.items()) + "; "
          f"flagship sharded envelope {d1['envelope_s'] * 1e3:.1f} ms (first "
          f"call, host clock)", flush=True)
    print(f"[time] {smi}: P-delta: analyze_pdelta 126 DOF "
          f"{pdl['pdelta_ms']:.1f} ms; analyze_pdelta_condensed 9,612 DOF "
          f"{pdl['cond_ms']:.1f} ms, 99,882 DOF {pdl['large_s'] * 1e3:.1f} "
          f"ms; buckling_analysis_condensed 9,612 DOF "
          f"{pdl['buck_cond_s'] * 1e3:.1f} ms vs dense "
          f"{pdl['buck_dense_s'] * 1e3:.1f} ms (host clock, one synchronised "
          "call each)", flush=True)

    # ---- 29-33. the design tier ----
    t0 = time.perf_counter()
    soil = soil_phase(pt, hk, dev, coarse64, refined64, large)
    print(f"[soil] phase {time.perf_counter() - t0:.2f} s wall; springs "
          f"(N/mm, N*mm/rad) of support 0: "
          + " ".join(f"{v:.4e}" for v in soil["springs"][0])
          + f"; kz/ky {soil['kz_over_ky']:.1f}; SSI condensed max "
          f"utilization 9,612 DOF {soil['condensed_9612']['umax']:.6f}, "
          f"99,882 DOF {soil['condensed_99882']['umax']:.6f}", flush=True)
    t0 = time.perf_counter()
    seis = seismic_phase(pt, hk, dev, coarse64, refined64, large, mlarge)
    print(f"[seismic] phase {time.perf_counter() - t0:.2f} s wall; "
          f"9,612 DOF CQC base shear (kN, x y z) "
          + " ".join(f"{v:.1f}" for v in seis["base_shear"])
          + f", max utilization {seis['cond_umax']:.6f}; 99,882 DOF max "
          f"utilization {seis['large_umax']:.6f}", flush=True)
    t0 = time.perf_counter()
    push = pushover_phase(pt, hk, dev, d2)
    print(f"[pushover] phase {time.perf_counter() - t0:.2f} s wall; RSR "
          f"{push['rsr']:g}, first yield {push['first_yield']:g}, "
          f"{push['n_yielded']} members yielded at lambda 6; to lambda 18: "
          f"RSR {push['yield_rsr']:g}, first yield {push['yield_first']:g},"
          f" {push['yield_n']} yielded; rose RSR "
          f"min {min(push['rose_rsr']):g} max {max(push['rose_rsr']):g}",
          flush=True)
    t0 = time.perf_counter()
    removal = removal_phase(pt, hk, dev)
    print(f"[removal] phase {time.perf_counter() - t0:.2f} s wall",
          flush=True)
    t0 = time.perf_counter()
    checks = checks_phase(pt, hk, dev)
    print(f"[checks] phase {time.perf_counter() - t0:.2f} s wall; max UC "
          + ", ".join(f"{k} {v:.4f}" for k, v in checks["uc"].items())
          + "; air gap (m) " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         checks["airgap"].items())
          + f"; {checks['viv_flags']} VIV flags; governing combination "
          f"{checks['governing_combo']}", flush=True)
    for label, r in (("pile_head_stiffness (support 0: 3 Newton solves)",
                      soil["rec"]),
                     ("response_spectrum_condensed 9,612 DOF", seis["rec"]),
                     ("pushover_rose 16 headings x 25 lambdas",
                      push["rec"]),
                     ("member_removal_screen 51 removals", removal["rec"]),
                     ("code checks and combinations", checks["rec"])):
        print(f"[time] {smi}: {label}: {r['text']} (torch.profiler)",
              flush=True)
    print(f"[time] {smi}: design tier, host clock, one synchronised call "
          f"each: soil springs {soil['springs_s'] * 1e3:.1f} ms; SSI "
          f"analyze_condensed 9,612 DOF "
          f"{soil['condensed_9612']['s'] * 1e3:.1f} ms, 99,882 DOF "
          f"{soil['condensed_99882']['s'] * 1e3:.1f} ms; response_spectrum "
          f"126 DOF {seis['dense_s'] * 1e3:.1f} ms, condensed 9,612 DOF "
          f"{seis['cond_s'] * 1e3:.1f} ms, 99,882 DOF "
          f"{seis['large_s'] * 1e3:.1f} ms; pushover "
          f"{push['single_s'] * 1e3:.1f} ms, rose {push['rose_s'] * 1e3:.1f}"
          f" ms; removal screen {removal['s'] * 1e3:.1f} ms; checks "
          f"{checks['s'] * 1e3:.1f} ms", flush=True)

    # ---- 34-36. the long-term tier ----
    t0 = time.perf_counter()
    reli = reliability_phase(pt, hk, dev)
    print(f"[reliability] phase {time.perf_counter() - t0:.2f} s wall; "
          f"member_reliability: {reli['reachable']} members reachable, "
          f"governing member {reli['governing']} beta "
          f"{reli['beta_min']:.6f} at Hs {reli['hs_star']:.3f} m, Tp "
          f"{reli['tp_star']:.3f} s, system pf in [{reli['p_lower']:.4e}, "
          f"{reli['p_upper']:.4e}]; importance sampling pf {reli['pf']:.6e} "
          f"(cov {reli['cov']:.4f}); environmental FORM beta "
          f"{reli['form_beta']:.6f} in {reli['form_evals']} evaluations",
          flush=True)
    t0 = time.perf_counter()
    dsgn = design_phase(pt, hk, dev, refined64)
    print(f"[design] phase {time.perf_counter() - t0:.2f} s wall", flush=True)
    t0 = time.perf_counter()
    iores = io_phase(pt, hk, dev)
    print(f"[io] phase {time.perf_counter() - t0:.2f} s wall; on this "
          f"host matplotlib (the plots) is "
          f"{'present' if iores['matplotlib'] else 'absent'}", flush=True)
    for label, r in (
            (f"member_reliability ({reli['n_envelopes']} envelopes)",
             reli["rec"]),
            (f"importance_sample_batch {IS_SAMPLES} samples", reli["is_rec"]),
            ("section_sensitivities 126 DOF", dsgn["rec"]),
            (f"section_sensitivities {refined64.n_dof} DOF", dsgn["big_rec"]),
            ("optimize_sections 4 iterations + the final analysis",
             dsgn["opt_rec"])):
        print(f"[time] {smi}: {label}: {r['text']} (torch.profiler)",
              flush=True)
    print(f"[time] {smi}: long-term tier, host clock, one synchronised call "
          f"each: member_reliability {reli['s'] * 1e3:.1f} ms (CPU "
          f"{reli['cpu_s'] * 1e3:.1f} ms); importance_sample_batch "
          f"{reli['is_s'] * 1e3:.1f} ms (its K1 launch "
          f"{reli['is_rec']['k1_us']:.1f} us, records + fused, against "
          f"harm64_bound {reli['is_bound']['us']:.2f} us by "
          f"{reli['is_bound']['by']}); environmental_reliability "
          f"{reli['form_s'] * 1e3:.1f} ms ({reli['form_ms_per_eval']:.2f} ms "
          f"an evaluation); section_sensitivities 126 DOF "
          f"{dsgn['s'] * 1e3:.1f} ms, {refined64.n_dof} DOF "
          f"{dsgn['big_s'] * 1e3:.1f} ms; optimize_sections "
          f"{SIZING_ITERS} iterations {dsgn['opt_s'] * 1e3:.1f} ms "
          f"({dsgn['opt_s'] * 1e3 / SIZING_ITERS:.2f} ms an iteration)",
          flush=True)

    # ---- 37-38. the command line and the GUI's headless core ----
    t0 = time.perf_counter()
    cli = cli_phase(pt, hk, dev)
    cli_s = time.perf_counter() - t0
    print(f"[cli] phase {cli_s:.2f} s wall ({len(cli['launches'])} "
          f"invocations, {len(cli['cpu_diff'])} against their CPU runs in "
          f"{CLI_CPU_WORKERS} processes, {cli['cpu_wait_s']:.2f} s waited "
          f"for them after the card's; the module entry "
          f"{cli['subprocess_s']:.2f} s); refined f64 vs the library "
          f"{cli['refined_err']:.2e}, f32 vs f64 {cli['refined_f32_err']:.2e};"
          f" importance check vs the library {cli['reliability_mc_err']:.2e};"
          " golden " + ", ".join(f"{k} {v:.2e}" for k, v in
                                 cli["golden"].items()), flush=True)
    print(f"[time] {smi}: CLI invocations, host wall, one call each: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in cli["wall_s"].items()),
          flush=True)
    for label, bounds in {"member_reliability": reli["f64_bounds"],
                          **{f"cli_{k}": v for k, v in
                             cli["f64_shapes"].items()}}.items():
        print(f"[k1-f64] {label}: " + "; ".join(
            f"{key} ({b['calls']} launch call(s)): harm64_bound "
            f"{b['us']:.3f} us by {b['by']} ({b['sums_gflop']:.4f} + "
            f"{b['epilogue_gflop']:.4f} GFLOP, {b['mb']:.3f} MB)"
            for key, b in bounds.items()), flush=True)
    for label, r in cli["f64_times"].items():
        d = r["device_us"]
        print(f"[k1-f64] {smi}: cli_{label} ({r['shape']}): "
              f"{d['total']:.3f} us on the device (records "
              f"{d['records']:.3f} + fused {d['fused']:.3f} + totals "
              f"{d['totals']:.3f}); bound {r['bound']['us']:.3f} us by "
              f"{r['bound']['by']}: {r['share']:.1%} of the bound; launch "
              f"{r['ms']:.3f} ms (torch.profiler, CUDA events)", flush=True)
    rb = cli["refined_busy"]
    print(f"[profile] {smi}: cli refined's f64 scan ({refined64.n_dof} DOF "
          f"x {N_STEPS} phases, K1 f64 loads, f64 solve): {rb['ops']:.0f} "
          f"device operations, device busy {rb['busy_ms']:.3f} ms, K1 f64 "
          f"{rb['k1_us']:.1f} us; most time: {rb['top']} (torch.profiler, "
          "3 calls)", flush=True)
    t0 = time.perf_counter()
    guir = gui_phase(pt, hk, dev, cli["run_json"])
    print(f"[gui] phase {time.perf_counter() - t0:.2f} s wall; "
          f"run_analysis_core {guir['s'] * 1e3:.1f} ms (max utilization "
          f"{guir['util']:.6f}; golden {guir['golden_err']:.2e}, CLI run "
          f"{guir['cli_err']:.2e}); damage screen "
          f"{guir['show_damage_screen_s'] * 1e3:.1f} ms, spectral fatigue "
          f"{guir['show_spectral_fatigue_s'] * 1e3:.1f} ms", flush=True)

    print(f"[time] {smi}: the whole script {time.perf_counter() - t_start:.1f}"
          " s wall, the kernels' build included", flush=True)
    design_launches = {
        "ssi_condensed_9612": soil["condensed_9612"]["launches"],
        "ssi_condensed_99882": soil["condensed_99882"]["launches"],
        "spectrum_condensed_9612": seis["cond_launches"],
        "spectrum_condensed_99882": seis["large_launches"],
        **reli["launches"], **dsgn["launches"]}
    l1 = sweep_ms["nested level 1"]
    nl1 = nsw["shapes"]["99,882 DOF nested level 1"]
    print(json.dumps({"kernels": [{
        "name": "morison_phase_batch",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/morison_phase_batch.cu",
        "replaces": "small_fem_solver_tpu/ops/pallas_kernels.py:229",
        "launches": env_launches["morison_phase_batch"],
        "launches_by_path": {
            "scan": scan_launches["morison_phase_batch"],
            "envelope": env_launches["morison_phase_batch"],
            "dense_envelope": denv["launches"],
            "dense_envelope_f32_model": denv["launches_f32"],
            "options_scan": options["k1_launches"],
            "f64_envelope_condensed": env64f["launches"]["f64"],
            "dynamic_condensed": dyn["launches"]["dynamic_condensed"]["f64"],
            "transient": dyn["launches"]["transient"]["f64"],
            **{label: n["sea_f32"] + n["sea_f64"]
               for label, n in sea_launches.items()
               if n["sea_f32"] + n["sea_f64"]},
            "sharded_envelope_1rank": sum(
                v for k, v in d1["launches"]["envelope"].items()
                if k != "sweep"),
            "sharded_dense_envelope_1rank":
                d1["launches"]["dense_envelope"]["f64"],
            "sharded_envelope_2ranks": [
                n["k1"] for n in d2["launches"]["envelope"]],
            "sharded_dense_envelope_2ranks": [
                n["f64"] for n in d2["launches"]["dense"]],
            **{label: sum(v for k, v in n.items() if k != "sweep")
               for label, n in design_launches.items()},
            **{f"cli_{label}": n["k1"]
               for label, n in cli["launches"].items()},
            "gui_run_analysis_core": sum(
                v for k, v in guir["launches"].items() if k != "sweep")},
        "cli_instances": {f"cli_{label}": {k: v for k, v in n.items()
                                           if k not in ("k1", "sweep") and v}
                          for label, n in cli["launches"].items()
                          if n["k1"]},
        "cli_f64_times": {f"cli_{k}": {
            "shape": r["shape"], "device_us": r["device_us"]["total"],
            "bound_us": r["bound"]["us"], "bound_by": r["bound"]["by"],
            "share": r["share"], "ms": r["ms"]}
            for k, r in cli["f64_times"].items()},
        "cli_refined_f64_busy_ms": cli["refined_busy"]["busy_ms"],
        "f64_fused_vs_separable": {"options_scan": options["errs"],
                                   "envelope_condensed": env64f["errs"]},
        "f64_bounds": {"member_reliability": reli["f64_bounds"],
                       **{f"cli_{k}": v for k, v in
                          cli["f64_shapes"].items()}},
        "instances": {"f32": ["scan", "envelope", "cli_refined_f32"],
                      "f32_batch": ["dense_envelope_f32_model"],
                      "f64": ["dense_envelope", "dynamic_condensed",
                              "transient", "member_reliability",
                              "importance_sample_1000", "options_scan",
                              "f64_envelope_condensed", "cli_refined",
                              "cli_envelope"],
                      "sea_f32": [k for k, n in sea_launches.items()
                                  if n["sea_f32"]],
                      "sea_f64": [k for k, n in sea_launches.items()
                                  if n["sea_f64"]]},
        "sea": {key: {**ksea[key], "max_abs_err": ksea["abs"][key],
                      "max_rel_err": ksea["rel"][key],
                      "bound_ms": ksea[key]["bound_us"] / 1e3,
                      "share": ksea[key]["bound_us"]
                      / ksea[key]["device_us"],
                      "shapes": f"S={SEA_STEPS}, M={refined64.n_members}, "
                                f"N={SEA_N}, Wheeler"}
                for key in ("sea_f32", "sea_f64")},
        "sea_build": ksea["build"],
        "f64": {"max_abs_err": k64["abs"], "max_rel_err": k64["rel"],
                "ms": k64_ms, "plain_ms": p64_ms, "device_us": k64_us,
                "bound_ms": k64_bound / 1e3, "bound_by": k64_by,
                "shapes": {key: {"device_us": r["device_us"],
                                 "bound_us": r["bound"]["us"],
                                 "bound_by": r["bound"]["by"],
                                 "share": r["share"], "ms": r["ms"],
                                 "plain_ms": r.get("plain_ms"),
                                 "max_rel_err": r["max_rel_err"]}
                           for key, r in k64["shapes"].items()}},
        "f64_build": k64["build"],
        "f32_dense_envelope_shapes": {
            "device_us": k1d, "bound_us": k1d_bound[0],
            "bound_by": k1d_bound[1],
            "share": k1d_bound[0] / k1d_us},
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
        "launches_by_path": {
            "scan": scan_launches["chain_sweep"],
            "envelope": env_launches["chain_sweep"],
            "analyze_condensed": large["analyze_condensed_launches"],
            "analyze_prepared": large["analyze_prepared_launches"],
            "pointwise_scan": dense["pointwise_launches"],
            "ssi_scan": options["sweep_launches"],
            "modal_condensed": dyn["launches"]["modal"]["sweep"],
            "dynamic_condensed": dyn["launches"]["dynamic_condensed"]["sweep"],
            "transient": dyn["launches"]["transient"]["sweep"],
            "modal_large": mlarge["launches"]["sweep"],
            **{label: n["sweep"] for label, n in sea_launches.items()},
            "sharded_envelope_1rank": d1["launches"]["envelope"]["sweep"],
            "sharded_scatter_1rank": d1["launches"]["scatter"]["sweep"],
            "sharded_envelope_2ranks": [
                n["sweep"] for n in d2["launches"]["envelope"]],
            "pdelta_condensed_9612": pdl["cond_launches"]["sweep"],
            "pdelta_condensed_99882": pdl["large_launches"]["sweep"],
            **{label: n["sweep"] for label, n in design_launches.items()},
            **{f"cli_{label}": n["sweep"]
               for label, n in cli["launches"].items()},
            "gui_run_analysis_core": guir["launches"]["sweep"]},
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
        "by_level": {
            **{k: {"ms": a, "plain_ms": b, "device_us": d, "bound_us": bd,
                   "bound": by}
               for k, (a, b, d, bd, by, _) in sweep_ms.items()},
            **{f"99,882 DOF {k} (f64, B={shape[0]}, n_int={shape[1]}, "
               f"chains={shape[2]})": {"ms": a, "plain_ms": b,
                                       "device_us": d, "device_us_warm": w,
                                       "bound_us": bd, "bound": by}
               for k, (a, b, d, bd, by, _, _, shape, w)
               in large["levels"].items()},
            **{f"chain-mode iteration, f64, B=18, n_int={n}, chains="
               f"{coarse64.n_members}": {"device_us": us, "bound_us": bd,
                                         "bound": by}
               for n, us, bd, by in (
                   (n_int9, dyn["rec"]["modal"]["sweep_us"], b9, by9),
                   (n_int99, mlarge["sweep_us"], b99, by99))}},
    }, {
        "name": "morison_f32_batch",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/morison_phase_batch.cu",
        "replaces": "small_fem_solver_tpu/ops/pallas_kernels.py:229",
        "launches": denv["launches_f32"],
        "launches_by_path": {"dense_envelope_f32_model": denv["launches_f32"]},
        "max_abs_err": kb32["abs"],
        "max_rel_err": kb32["rel"],
        "ms": kb32["shapes"]["none"]["ms"],
        "plain_ms": kb32["shapes"]["none"]["plain_ms"],
        "device_us": kb32["shapes"]["none"]["total_us"],
        "bound_ms": kb32["shapes"]["none"]["bound_us"] / 1e3,
        "bound_by": kb32["shapes"]["none"]["bound_by"],
        "library_ms": None,
        "shapes": {k: {"device_us": r["total_us"], "bound_us": r["bound_us"],
                       "share": r["share"], "ms": r["ms"]}
                   for k, r in kb32["shapes"].items()},
        "dense_envelope_f32_model_ms": denv["ms_f32"],
        "build": kb32["build"]["instances"],
    }, {
        "name": "morison_pointwise",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/morison_pointwise.cu",
        "replaces": None,
        "launches": pw["scan_launches"]["pointwise"],
        "launches_by_path": {
            "slam_scan": pw["scan_launches"]["pointwise"],
            "pointwise_scan_f64": dense["pointwise_kernel_launches"]},
        "scan_ms": pw["scan_ms"],
        "max_rel_err": max(r["max_rel_err"]
                           for r in pw["instances"].values()),
        "ms": pw["instances"]["float32"]["ms"],
        "plain_ms": pw["instances"]["float32"]["plain_ms"],
        "device_us": pw["instances"]["float32"]["total_us"],
        "bound_ms": pw["instances"]["float32"]["bound_us"] / 1e3,
        "bound_by": pw["instances"]["float32"]["bound_by"],
        "library_ms": None,
        "instances": {k: {"device_us": r["total_us"],
                          "bound_us": r["bound_us"], "share": r["share"],
                          "ms": r["ms"], "plain_ms": r["plain_ms"]}
                      for k, r in pw["instances"].items()},
        "build": pw["build"],
    }, {
        "name": "chain_sweep_narrow",
        "route": "cuda",
        "source": "small_fem_solver_tpu_torch/csrc/chain_sweep.cu",
        "replaces": "benchmarks/ab_pallas_sweep.py:106 and "
                    "benchmarks/ab_pallas_sweep.py:114",
        "launches": large["analyze_prepared_narrow"],
        "launches_by_path": {
            "analyze_prepared": large["analyze_prepared_narrow"],
            "analyze_condensed": large["analyze_condensed_narrow"],
            "modal_large": mlarge["narrow"]},
        "max_abs_err": nsw["abs"],
        "ms": nl1["ms"],
        "plain_ms": nl1["plain_ms"],
        "device_us": nl1["device_us"],
        "bound_ms": nl1["bound_us"] / 1e3,
        "bound_by": nl1["bound_by"],
        "step_floor_ms": nl1["floor_us"] / 1e3,
        "step_us": nsw["step_us"],
        "library_ms": None,
        "shapes": {k: {f: r[f] for f in (
            "B", "n_int", "chains", "device_us", "device_us_f32", "bound_us",
            "bound_by", "floor_us", "ms", "plain_ms", "max_rel_err")}
            | ({"device_us_cold": r["device_us_cold"]}
               if "device_us_cold" in r else {})
            for k, r in nsw["shapes"].items()},
    }]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
