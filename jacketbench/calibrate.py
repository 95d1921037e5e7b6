"""Readings that the limits of a cell's correctness check are set from.

    python3 jacketbench/calibrate.py --workload <cell> --seeds 12 \
        --control-seeds 3 --first-seed <n> [--seconds 2]

In one process: the program on ``--seeds`` seeds (a short window each, the
same calls checked as a run checks), then the control on
``--control-seeds`` seeds: the reference itself, in the precision below the
configuration's (the limits file's ``control``), put in the program's place.
Prints each seed's numbers as a JSON line and, last, for each number the
lower reading (the largest of the program's), the upper reading (the
smallest of the control's) and their ratio.  It runs on the card; nothing
of it runs in the benchmark's own runs.
"""
import json
import pathlib
import sys
import time


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path[0] = str(root)
    import torch
    from jacketbench import core
    from jacketbench.reference.jacket import Precision
    bench = core.load_json(root / "BENCHMARK.json")
    ctl = core.resolve(bench, a.workload)["limits"]["control"]
    control = Precision(getattr(torch, ctl["dtype"]), ctl.get("tf32", False))
    prog, cont = [], []
    for k in range(a.seeds + a.control_seeds):
        seed = a.first_seed + k
        is_ctl = k >= a.seeds
        t0 = time.perf_counter()
        line = core.run(a.workload, seed, a.seconds, False, t0,
                        device=a.device, bench=bench,
                        control=control if is_ctl else None,
                        every_number=True)
        vals = {n: c["value"] for n, c in line["checks"].items()}
        (cont if is_ctl else prog).append(vals)
        print(json.dumps({"seed": seed, "control": is_ctl,
                          "correct": line["correct"], "numbers": vals,
                          "s": time.perf_counter() - t0}), flush=True)
    summary = {}
    for n in prog[0]:
        lo = max((v[n] for v in prog if v.get(n) is not None), default=None)
        up = [v[n] if isinstance(v[n], float) else float("inf")
              for v in cont if v.get(n) is not None]
        up = min(up) if up else None
        summary[n] = {"lower": lo, "upper": up,
                      "ratio": (up / lo if lo and up is not None else None)}
    print(json.dumps({"workload": a.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
