"""Times two checkouts of the port on one card, in turns (other, this,
this, other), each run a fresh process: the f32 model's 1,000-case dense
envelope and its K1 launches, the chain sweep at few right-hand sides on
deep chains (the 99,882-DOF nested level 1 and the Craig-Bampton
chain-mode iteration's shapes, f64) and at the flagship's 360 (f32), and
K1's one-case f32 instance at the flagship's shapes.

Run from a checkout, with the other checkout's root as the argument:

    python3 tools/ab_compare.py path/to/other/checkout

It prints one JSON object a run and, last, the per-checkout medians.  The
sweeps run on seeded random factors of the paths' shapes (a kernel's time
does not depend on the values).  Needs a CUDA card; imports no JAX.
"""
from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (B, n_int, chains, dtype): the 99,882-DOF nested level 1, the chain-mode
# iteration at 9,612 and 99,882 DOF, and the flagship's three sweeps
SWEEPS = [(1, 108, 153, "f64"), (18, 31, 51, "f64"), (18, 326, 51, "f64"),
          (360, 7, 204, "f32"), (360, 2, 51, "f32"), (360, 31, 51, "f32")]


def _smoke():
    """This checkout's ``chip_smoke`` (its timing helpers and design
    batch), whichever checkout's package is measured."""
    spec = importlib.util.spec_from_file_location(
        "ab_chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> dict:
    """The measurements of the checkout at ``root`` (its package first on
    the path)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import small_fem_solver_tpu_torch as pt
    from small_fem_solver_tpu_torch.ops import hopper_kernels as hk
    from small_fem_solver_tpu_torch.ops.condense import ChainFactor
    cs = _smoke()
    if not os.path.abspath(pt.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"imported {pt.__file__}, not the package of "
                           f"{root}")
    dev = torch.device("cuda")
    hk.build_all()
    out = {"root": root, "card": cs.smi_line()}
    # the f32 model's dense envelope
    waves, cases, _, _ = cs.design_batch(pt)
    m32 = pt.default_3leg_jacket(dtype=torch.float32, device=dev)
    w32 = waves.to(torch.float32, dev)

    def envelope():
        return pt.design_envelope(m32, w32, cases, n_steps=36)
    hk.launch_counts(reset=True)
    envelope()
    torch.cuda.synchronize()
    out["envelope_launches"] = {k: v for k, v in hk.launch_counts().items()
                                if v}
    out["envelope_ms"] = cs.cuda_ms(envelope, n=5, warmup=1)
    ev = cs.device_events(envelope, host=False)
    out["envelope_busy_ms"] = sum(t for _, t in ev) / 1e3
    out["envelope_k1_us"] = sum(t for n, t in ev if "morison" in n)
    # the sweeps
    out["sweep_us"] = {}
    for B, n_int, C, dt in SWEEPS:
        dtype = torch.float64 if dt == "f64" else torch.float32
        rng = np.random.default_rng(n_int * 1000 + C)

        def rand(*shape, scale=1.0):
            return torch.tensor(rng.normal(size=shape) * scale, dtype=dtype,
                                device=dev)
        fac = ChainFactor(torch.zeros(C, 12, 12, dtype=dtype, device=dev),
                          *(rand(n_int, C, 6, 6, scale=1 / 6)
                            for _ in range(5)), rand(C, 6, 6), rand(C, 6, 6))
        g = rand(B, n_int, C, 6)
        ev = cs.device_events(lambda: hk.chain_sweep_cuda(fac, g),
                              cs.SHORT_REPS)
        out["sweep_us"][f"B={B} n_int={n_int} chains={C} {dt}"] = \
            cs.kernel_median_us(ev, "chain_sweep")
    # K1's one-case f32 instance at the flagship's shapes
    refined = pt.refine_model(m32, 32)
    wave = pt.make_wave(17.038, 9.4, 50.0, U_c=1.7, model="fenton", N=18,
                        dtype=torch.float32, device=dev)
    ts = torch.arange(360, dtype=torch.float32, device=dev) * wave.T / 360
    args = (wave, refined.coords, refined.conn,
            refined.sections.D_outer[refined.sect_id] / 1000.0, 38.0, 38.0,
            0.7, 2.0, 1025.0, ts)
    ev = cs.device_events(lambda: hk.morison_end_forces_cuda(*args),
                          cs.SHORT_REPS)
    out["k1_f32_flagship_us"] = (
        cs.kernel_median_us(ev, "morison_phase_batch_kernel")
        + cs.kernel_median_us(ev, "morison_totals_kernel"))
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--worker":
        print(json.dumps(worker(argv[1])), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[0])
    runs = []
    for root in (other, HERE, HERE, other):
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", root], capture_output=True,
                             text=True)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)

    def median(key, sub=None):
        vals = {}
        for r in runs:
            v = r[key] if sub is None else r[key][sub]
            vals.setdefault(r["root"], []).append(v)
        return {("other" if k == other else "this"): statistics.median(v)
                for k, v in vals.items()}
    print(json.dumps({
        "envelope_ms": median("envelope_ms"),
        "envelope_busy_ms": median("envelope_busy_ms"),
        "envelope_k1_us": median("envelope_k1_us"),
        "k1_f32_flagship_us": median("k1_f32_flagship_us"),
        "sweep_us": {k: median("sweep_us", k) for k in runs[0]["sweep_us"]},
        "card": runs[0]["card"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
