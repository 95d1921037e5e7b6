"""Run one cell of the port's benchmark on the chips of this machine.

    python3 jacketbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``host`` (a call's wall and CPU time on the host, a
diagnostic), and last ``checks``: each number compared with the plain
reference beside its limit (also the last lines of standard error).  Exits
non-zero, with no result, without the CUDA cards the cell asks for, or if a
module of JAX or of the JAX package was loaded.
"""
import os
import pathlib
import sys
import time

T0 = time.perf_counter()
ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "2")
    sys.path[0] = str(ROOT)
    import json

    import torch
    from jacketbench import core
    bench = core.load_json(ROOT / "BENCHMARK.json")
    chips = core.resolve(bench, a.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{a.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = core.run(a.workload, a.seed, a.seconds, bool(a.trace), T0,
                    bench=bench)
    foreign = core.foreign_modules(sys.modules)
    if foreign:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(foreign), file=sys.stderr)
        return 3
    for text in core.check_lines(line):
        print(text, file=sys.stderr)
    print(json.dumps(line, allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
