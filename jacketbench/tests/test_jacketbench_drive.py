"""A run of every cell driven on the CPU at a small size (the chip look
skipped): the port's answers against the plain reference, the result line,
the import check; then the control and the faults, which must come out
not correct.  The ``cuda`` tests drive the real cells on the card.

    python -m pytest -q -p no:cacheprovider jacketbench/tests
"""
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from jacketbench import core  # noqa: E402
from jacketbench.reference.jacket import Precision  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(cell: str) -> dict:
    """The cell at a size a test run holds: 2 segments a member (72
    nodes) and a few short calls, or 16 cases of the design grid."""
    if "9612" in cell:
        mix = {"waves": {"H_m": {"count": 4}}, "n_steps": 12,
               "warmup_calls": 1, "sample_calls": 2}
        if "storm" in cell:
            mix["call"] = {"draw_waves": 2}
        return {"config": {"mesh": {"n_seg": 2}}, "mix": mix}
    mix = {"waves": {"H_m": {"linspace": [2.0, 14.0, 4]}},
           "cases": {"cross_headings_deg": {"arange": [0.0, 360.0, 90.0]}},
           "warmup_calls": 1, "sample_calls": 2}
    if "design" in cell:
        mix["n_steps"] = 6
    return {"mix": mix}


def drive(cell: str, **kw) -> dict:
    return core.run(cell, 2**31 + 77, 0.3, False, time.perf_counter(),
                    device="cpu", overrides=small(cell), bench=BENCH, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(cell):
    line = drive(cell)
    assert line["correct"], line["checks"]
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "host", "checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    units = {m["name"]: m["unit"]
             for m in core.resolve(BENCH, cell)["end_to_end"]}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == units
    assert all(v["value"] > 0 for v in line["metrics"].values())
    for name, c in line["checks"].items():
        assert 0 <= c["value"] <= c["limit"], name
    json.dumps(line, allow_nan=False)


def test_no_module_of_jax_is_loaded():
    code = ("import sys, time; sys.path.insert(0, '.')\n"
            "from jacketbench import core\n"
            "from jacketbench.tests.test_jacketbench_drive import small\n"
            "for c in ('j126.design-envelope', 'j9612.storm-envelope'):\n"
            "    core.run(c, 3, 0.2, False, time.perf_counter(), "
            "device='cpu', overrides=small(c))\n"
            "print(core.foreign_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference in the precision below the configuration's, put in
    the program's place, fails the cell's limits."""
    ctl = core.resolve(BENCH, cell)["limits"]["control"]
    line = drive(cell, control=Precision(getattr(torch, ctl["dtype"]),
                                         ctl.get("tf32", False)))
    assert not line["correct"], line["checks"]


def _batch(spec: dict) -> int:
    n = len(spec["wave_idx"])
    return n if n > 1 else spec["n_steps"]


def half_batch(call, state, spec):
    """Half of the batch left out: its rows are the mean of the rest."""
    out = call(state, spec)
    n = _batch(spec)
    for v in out.values():
        if v.ndim and v.shape[0] == n:
            v[n // 2:] = v[:n // 2].mean(axis=0)
    return out


def altered_answer(call, state, spec):
    """One answer altered where it is produced: the largest utilization
    5% higher."""
    out = call(state, spec)
    key = "max_util_per_phase" if "max_util_per_phase" in out \
        else "utilization"
    v = out[key]
    v.flat[np.argmax(v)] *= 1.05
    return out


@pytest.mark.parametrize("fault", [half_batch, altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    assert not drive(cell, fault=fault)["correct"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "jacketbench/run.py", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
