"""The benchmark's own CPU tests: its definition, its files found by name,
its arithmetic, its import check and its result line.

    python -m pytest -q -p no:cacheprovider jacketbench/tests
"""
import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from jacketbench import core, generator  # noqa: E402
from jacketbench.bounds import k1, sweep  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "jacketbench/run.py"]
    assert BENCH["paths"] == ["jacketbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("jacketbench/")
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    assert all(NAME.match(n) for n in names), names
    for text in [c["source"] for c in BENCH["configs"]] + [
            w["why"] for w in BENCH["workloads"] + BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_resolves_by_name():
    for w in BENCH["workloads"]:
        cell = core.resolve(BENCH, w["name"])
        core.load_module("entries", cell["mix"]["entry"])
        for m in cell["per_layer"]:
            mod = core.load_module("metrics", m["name"])
            assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]
            assert mod.LAYER == m["layer"] and mod.SOURCE == m["source"]
        assert set(cell["limits"]["checks"])
        e2e = {e["name"] for e in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and e2e <= set(core.E2E)


def test_added_files_are_found_without_edits(tmp_path):
    """A configuration, a traffic mix and a metric added as new files (and
    named in BENCHMARK.json) are found; no file of the harness changes."""
    shutil.copytree(ROOT / "jacketbench", tmp_path / "jacketbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "jacketbench").rglob("*")
              if p.is_file()}
    jb = tmp_path / "jacketbench"
    cfg = json.loads((jb / "configs/jacket3-126-f64.json").read_text())
    cfg["name"] = "jacket3-126-f64-deep"
    cfg["sea"]["d_m"] = 60.0
    (jb / "configs/jacket3-126-f64-deep.json").write_text(json.dumps(cfg))
    mix = json.loads((jb / "traffic/design-envelope.json").read_text())
    mix["n_steps"] = 12
    (jb / "traffic/design-envelope-12.json").write_text(json.dumps(mix))
    (jb / "limits/j126deep.design-envelope-12.json").write_text(
        (jb / "limits/j126.design-envelope.json").read_text())
    (jb / "metrics/calls_seen.py").write_text(
        'LAYER = "Entry points (api.py)"\nUNIT = "calls"\n'
        'SOURCE = "program_counter"\nMOVES = "case_phases_per_s"\n\n\n'
        'def read(trace):\n    return float(trace.n_calls)\n')
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "jacket3-126-f64-deep", "source": "x",
                             "file": "jacketbench/configs/"
                                     "jacket3-126-f64-deep.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "j126deep.design-envelope-12",
                               "config": "jacket3-126-f64-deep",
                               "traffic": "design-envelope-12", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "Entry points (api.py)",
                               "moves": "case_phases_per_s",
                               "workloads": ["j126deep.design-envelope-12"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys; sys.path.insert(0, '.')\n"
        "from jacketbench import core\n"
        "b = core.load_json(core.ROOT / 'BENCHMARK.json')\n"
        "c = core.resolve(b, 'j126deep.design-envelope-12')\n"
        "assert c['config_data']['sea']['d_m'] == 60.0\n"
        "assert c['mix']['n_steps'] == 12\n"
        "m = core.load_module('metrics', 'calls_seen')\n"
        "assert [x['name'] for x in c['per_layer']][-1] == 'calls_seen'\n"
        "print(m.read(type('T', (), {'n_calls': 3})()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3.0"
    for p, data in before.items():
        assert p.read_bytes() == data


def test_bounds_at_known_shapes():
    """The copied roofline arithmetic at the shapes of the repo's records:
    K1 f32 batch (1,000 cases, S 36, M 51, Q 15, N 8) 90.4 us, K1 f64 at
    the same shapes 114.4 us, the flagship f32 scan 55.2 us, the flagship
    level-1 sweep 8.6 us."""
    assert k1.k1_f32_batch_bound(1000, 36, 51, 15, 8, 21)[0] == \
        pytest.approx(90.4, abs=0.05)
    assert k1.harm64_bound(36, 51, 15, 8, 21, C=1000)["us"] == \
        pytest.approx(114.4, abs=0.05)
    assert k1.k1_f32_bound(360, 1632, 15, 18, 1602)[0] == \
        pytest.approx(55.2, abs=0.05)
    assert sweep.sweep_bound(4, 360, 31, 51)[0] == pytest.approx(8.6,
                                                                 abs=0.05)
    assert k1.work_us(dict(dtype="float64", C=1000, S=36, M=51, Q=15, N=8,
                           n_nodes=21)) == pytest.approx(114.4, abs=0.05)


def test_module_check_compares_whole_top_level_names():
    names = ["small_fem_solver_tpu_torch", "small_fem_solver_tpu_torch.api",
             "jaxtyping", "jacketbench.core", "jax.numpy", "jaxlib",
             "small_fem_solver_tpu", "small_fem_solver_tpu.ops", "flax.nn"]
    assert core.foreign_modules(names) == [
        "flax.nn", "jax.numpy", "jaxlib", "small_fem_solver_tpu",
        "small_fem_solver_tpu.ops"]


def test_seeds_draw_the_same_calls():
    mix = json.loads((ROOT / "jacketbench/traffic/storm-envelope.json")
                     .read_text())
    big = 2**31 + 12345
    a, b = generator.Traffic(mix, big), generator.Traffic(mix, big)
    assert (a.H == b.H).all()
    for i in (0, 7):
        x, y = a.call(i), b.call(i)
        assert (x["wave_idx"] == y["wave_idx"]).all()
        assert (x["heading_deg"] == y["heading_deg"]).all()
    assert len(set(a.call(0)["wave_idx"])) == 10
    assert a.call(0, warmup=True)["heading_deg"].tolist() != \
        a.call(0)["heading_deg"].tolist()


def test_run_refuses_without_a_card():
    """The run exits non-zero and prints no result line without CUDA."""
    out = subprocess.run(
        [sys.executable, "jacketbench/run.py", "--workload",
         "j126.design-envelope", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_fails_in_a_directory_of_the_benchmark_alone(tmp_path):
    shutil.copytree(ROOT / "jacketbench", tmp_path / "jacketbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "jacketbench/run.py", "--workload",
         "j126.design-envelope", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
