"""Probe of the device records torch.profiler keeps on one CUDA card.

Short profiler sessions of three calls: the Morison kernel's wrapper
(``morison_end_forces_cuda``, two kernels) on the flagship operands, the
same call inside 2 ms host sleeps, and one PyTorch elementwise kernel, six
sessions each; and three sessions of ``chip_smoke.SHORT_REPS`` wrapper
calls each, as ``chip_smoke.py`` records a short call.  They run first in
a fresh process, then after each of ``--heavy`` sessions of the
1,000-case ``design_envelope`` of ``chip_smoke.py`` (about 2,370 device
operations each).  One JSON line per round gives the device records each
short session kept and the heavy session's count.  Run it as is and with
``TEARDOWN_CUPTI=1`` (CUPTI torn down after every session) to compare the
two.

Run from the repository root:  python3 profiler_probe.py [--heavy 8]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    import small_fem_solver_tpu_torch as pt
    from small_fem_solver_tpu_torch.ops import hopper_kernels as hk

    ap = argparse.ArgumentParser()
    ap.add_argument("--heavy", type=int, default=8)
    n_heavy = ap.parse_args().heavy
    dev, f32 = torch.device("cuda", 0), torch.float32
    t_start = time.perf_counter()
    hk.build_all()
    refined = pt.refine_model(pt.default_3leg_jacket(dtype=f32, device=dev),
                              cs.N_SEG)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=f32, device=dev)
    ts = torch.arange(cs.N_STEPS, dtype=f32, device=dev) * wave.T / cs.N_STEPS
    args = (wave, refined.coords, refined.conn,
            refined.sections.D_outer[refined.sect_id] / 1000.0,
            *(torch.tensor(v, dtype=f32, device=dev)
              for v in (38.0, 38.0, 0.7, 2.0, 1025.0)), ts)
    x = torch.zeros(1024, device=dev)

    def k1():
        hk.morison_end_forces_cuda(*args)

    def k1_padded():
        time.sleep(0.002)
        k1()
        torch.cuda.synchronize()
        time.sleep(0.002)

    def one_kernel():
        x.add_(1.0)

    def kept(fn, reps=1, n=6):
        return [len(cs.device_events(fn, reps)) for _ in range(n)]

    def report(**fields):
        print(json.dumps({"t_s": round(time.perf_counter() - t_start, 1),
                          **fields}), flush=True)

    print(cs.smi_line(), flush=True)
    report(TEARDOWN_CUPTI=os.environ.get("TEARDOWN_CUPTI"),
           torch=torch.__version__, cuda=torch.version.cuda)
    report(round="fresh process", k1=kept(k1), k1_padded=kept(k1_padded),
           one_kernel=kept(one_kernel),
           k1_reps=kept(k1, cs.SHORT_REPS, 3))
    waves_cpu, cases, _, _ = cs.design_batch(pt)
    coarse64 = pt.default_3leg_jacket(dtype=torch.float64, device=dev)
    waves = waves_cpu.to(torch.float64, dev)

    def envelope():
        pt.design_envelope(coarse64, waves, cases, n_steps=cs.DESIGN_STEPS)
    for r in range(n_heavy):
        report(round=f"after heavy session {r + 1}",
               heavy_ops=len(cs.device_events(envelope)), k1=kept(k1),
               k1_padded=kept(k1_padded), one_kernel=kept(one_kernel),
               k1_reps=kept(k1, cs.SHORT_REPS, 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
