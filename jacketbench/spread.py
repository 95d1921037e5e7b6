"""Spreads of a cell's runs, as the bounds of ``BENCHMARK.json`` are set
from them: for each end-to-end metric and each set of runs, the distance
between the first and third quartiles (``statistics.quantiles``, n = 4) as
a share of the median; beside it the same with the set's run farthest
from the median left out, and the second set's median over the first's.

    python3 jacketbench/spread.py runs.jsonl

``runs.jsonl``: one JSON object a run, ``{"set": k, "trace": 0|1, "line":
<the run's result line>}``.  Prints each set's medians and spreads, and
whether every run was correct.
"""
import json
import statistics
import sys


def spreads(values: list) -> tuple:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return q2, (q3 - q1) / q2


def trimmed(values: list) -> list:
    """The values without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda k: abs(values[k] - med))
    return values[:far] + values[far + 1:]


def main(path: str) -> int:
    rows = [json.loads(x) for x in open(path) if x.strip()]
    by_set: dict = {}
    for r in rows:
        if r.get("trace") == 0 and r.get("line"):
            by_set.setdefault(r["set"], []).append(r["line"])
    out = {"correct": all(r.get("line") and r["line"]["correct"]
                          for r in rows),
           "runs": len(rows)}
    for s, lines in sorted(by_set.items()):
        for m in lines[0]["metrics"]:
            vals = [ln["metrics"][m]["value"] for ln in lines]
            med, sp = spreads(vals)
            out[f"set{s}.{m}"] = {"median": med, "spread": sp,
                                  "spread_trimmed": spreads(trimmed(vals))[1],
                                  "values": vals}
    if len(by_set) == 2:
        one, two = (f"set{s}.case_phases_per_s" for s in sorted(by_set))
        out["median_ratio.case_phases_per_s"] = (out[two]["median"]
                                                 / out[one]["median"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
