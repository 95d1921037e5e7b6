"""The harness: one run of one cell of ``BENCHMARK.json``.

Everything a cell needs is found by name: its configuration file (the
``file`` of its ``configs`` entry), its traffic mix
(``traffic/<traffic>.json``), the program entry the mix names
(``entries/<entry>.py``), the per-layer metrics that list the cell or list
no cell (``metrics/<metric>.py``) and the limits of its correctness check
(``limits/<cell>.json``).  Adding a configuration, a mix, an entry or a
metric adds files; nothing here changes.

A run: set-up (the port, its kernels, the model, the wave set, warm-up
calls), then calls back to back for ``seconds`` (one client, closed loop;
a call ends when its results are on the host), then the sampled calls'
answers against the plain reference.  With ``trace`` one profiler session
spans the window and the per-layer metrics are read from it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import pathlib
import resource
import sys
import time
import traceback

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "jacketbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "small_fem_solver_tpu")
E2E = ("setup_s", "case_phases_per_s", "call_ms_p95")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` of the harness, imported as a module of the
    ``jacketbench.<kind>`` package."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod_name = f"jacketbench.{kind}." + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    importlib.import_module(f"jacketbench.{kind}")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix and metrics, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]
    return {"workload": w, "config": cfg,
            "config_data": load_json(ROOT / cfg["file"]),
            "mix": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "limits" / f"{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if listed(m)],
            "per_layer": [m for m in bench["per_layer"] if listed(m)]}


def foreign_modules(names) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


def run(workload: str, seed: int, seconds: float, trace: bool, t0: float,
        device: str = "cuda", overrides: dict | None = None, fault=None,
        control=None, bench: dict | None = None,
        every_number: bool = False) -> dict:
    """One run of a cell; returns the result line's object.  ``overrides``
    ({"config": ..., "mix": ..., "limits": ...}) and ``fault`` (wraps the
    entry's call) serve the harness's own tests; ``control`` (a
    ``reference.jacket.Precision``) answers the sampled calls with the
    reference in that precision in the program's place; ``every_number``
    reports every number the entry compares, limited or not."""
    import torch

    from . import generator, judge, sut as sut_mod, tracing
    from .reference import jacket

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell = resolve(bench, workload)
    over = overrides or {}
    cfg = merge(cell["config_data"], over.get("config", {}))
    mix = merge(cell["mix"], over.get("mix", {}))
    lim = merge(cell["limits"], over.get("limits", {}))
    entry = load_module("entries", mix["entry"])
    metrics = {m["name"]: (m, load_module("metrics", m["name"]))
               for m in cell["per_layer"]}
    cuda = torch.device(device).type == "cuda"

    stages = [("start", t0)]

    def stage(name):
        if cuda:
            torch.cuda.synchronize()
        stages.append((name, time.perf_counter()))

    import small_fem_solver_tpu_torch as pt
    hk = pt.ops.hopper_kernels
    if cuda:
        torch.zeros(1, device=device)
    stage("imports and device")
    traffic = generator.Traffic(mix, seed)
    sut = sut_mod.build(pt, cfg, mix, traffic.H, device)
    stage("model and waves")
    state = entry.setup(sut)
    stage("entry set-up")
    call = entry.call if fault is None else (
        lambda s, spec: fault(entry.call, s, spec))
    for i in range(int(mix["warmup_calls"])):
        call(state, traffic.call(i, warmup=True))
    stage("warm-up calls")
    gc.collect()
    gc.freeze()     # set-up's objects out of the collector's way in the window
    setup_s = stages[-1][1] - t0
    print("set-up: " + ", ".join(f"{n} {b - a:.3f} s" for (_, a), (n, b)
                                 in zip(stages, stages[1:])),
          file=sys.stderr)

    lat, work, calls, failed = [], 0, [], 0
    sample = generator.Reservoir(int(mix["sample_calls"]), seed)
    records = {}
    hk.launch_counts(reset=True)
    with contextlib.ExitStack() as stack:
        if trace:
            prof = stack.enter_context(tracing.profiler())
            for name, (_, mod) in metrics.items():
                if hasattr(mod, "instrument"):
                    records[name] = []
                    stack.enter_context(mod.instrument(records[name]))
            stack.enter_context(torch.profiler.record_function(
                tracing.WINDOW))
        switches = resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw
        cpu0, main0 = time.process_time(), time.thread_time()
        start = time.perf_counter()
        i = 0
        while True:
            spec = traffic.call(i)
            c0 = time.perf_counter()
            try:
                with (torch.profiler.record_function(tracing.CALL) if trace
                      else contextlib.nullcontext()):
                    out = call(state, spec)
            except Exception:                   # a failed call is counted
                out = None
                if not failed:
                    traceback.print_exc()
                failed += 1
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            if out is not None:
                work += traffic.work(spec)
                sample.offer(i, (spec, out))
            calls.append({"counters": hk.launch_counts(reset=True),
                          "work": entry.work_shapes(state, spec)})
            i += 1
            if c1 - start >= seconds:
                break
        window_s = c1 - start
        host_info = {      # where the window's wall time went on the host
            "wall_ms_per_call": 1e3 * window_s / i,
            "process_cpu_ms_per_call": 1e3 * (time.process_time() - cpu0) / i,
            "main_thread_cpu_share": (time.thread_time() - main0) / window_s,
            "involuntary_switches_per_call": (resource.getrusage(
                resource.RUSAGE_SELF).ru_nivcsw - switches) / i}
    print("host: " + ", ".join(f"{k} {v:.6g}" for k, v in host_info.items()),
          file=sys.stderr)
    result_metrics = {               # the end-to-end metrics, E2E
        "setup_s": {"value": setup_s, "unit": "s"},
        "case_phases_per_s": {"value": work / window_s, "unit": "phases/s"},
        "call_ms_p95": {"value": float(np.percentile(lat, 95)) * 1e3,
                        "unit": "ms"}}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": 1,
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if cuda else 0)}
    out_line = {"correct": False, "attempted": i, "failed": failed}
    if trace:
        tr = tracing.read(prof, calls, records)
        out_line["metrics"] = {}
        for name, (m, mod) in metrics.items():
            v = mod.read(tr)
            if v is not None:
                out_line["metrics"][name] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        out_line["device"] = device_info
        out_line["breakdown"] = tracing.breakdown(tr)
        del prof, tr
    else:
        names = {m["name"] for m in cell["end_to_end"]}
        out_line["metrics"] = {k: v for k, v in result_metrics.items()
                               if k in names}
        out_line["device"] = device_info
    out_line["host"] = host_info
    del state
    judge.free_device()

    jd = judge.build(cfg, mix, traffic.H, entry.CLAMP,
                     lim["surface_band_m"],
                     jacket.Precision(torch.float64), device)
    ctl = None if control is None else judge.build(
        cfg, mix, traffic.H, entry.CLAMP, lim["surface_band_m"], control,
        device)
    t_ref = time.perf_counter()
    readings = []
    for spec, got in sample.kept:
        ref = judge.answer(jd, spec)
        if ctl is not None:
            got = entry.from_reference(judge.answer(ctl, spec))
        readings.append(entry.readings(got, ref))
    print(f"reference: {len(readings)} calls in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limits = lim["checks"]
    if every_number:
        limits = {n: limits.get(n, 1e300) for r in readings for n in r}
    checks = judge.judge(readings, limits)
    out_line["correct"] = bool(failed == 0 and readings
                               and all(c["ok"] for c in checks.values()))
    out_line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                          for k, c in checks.items()}
    return out_line


def check_lines(line: dict) -> list:
    return [f"check {k}: {c['value']!r} <= {c['limit']!r}"
            for k, c in line["checks"].items()]
