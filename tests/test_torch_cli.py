"""The port's CLI (``small_fem_solver_tpu_torch.cli``) against the JAX
package's on the CPU: the analysis subcommands (``run`` and its outputs,
``save-default``, ``sweep``, ``refined``, ``envelope``),
the ``--f32`` mode, the ``--device`` rule and the module entry point.
Stdout is compared by ``torch_cli_compare.text_diff`` (numbers within one
unit of their last printed digit; ``--f32`` within 1e-4 relative), the
output files at 1e-8.  The other subcommands are in
``test_torch_cli_dynamics.py``, ``test_torch_cli_design.py``,
``test_torch_cli_seas.py`` and ``test_torch_cli_longterm.py``."""
import csv
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import small_fem_solver_tpu_torch as pt
import small_fem_solver_tpu_torch.cli as tcli
from test_torch_convert import rel_err
from torch_cli_compare import (assert_same_text, jcli, json_err, run,
                               run_pair)

FILE_TOL = 1e-8       # --json-out, --csv, --save-results, relative
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("argv", [
    ["sweep", "--H-range", "8", "17", "3", "--dirs", "0", "38",
     "--wave-model", "airy"],
    ["refined", "--n-seg", "2", "--phase-steps", "12", "--wave-model",
     "airy"],
    ["refined", "--n-seg", "4", "--phase-steps", "12", "--f32",
     "--wave-model", "airy"],
    ["envelope", "--H-range", "8", "17", "2", "--n-seg", "2",
     "--phase-steps", "12", "--wave-model", "airy"],
    ["run", "--wave-model", "airy", "--phase-scan", "--refine", "2"],
    ["run", "--wave-model", "airy", "--support-spring", "1e6", "1e6", "1e6",
     "1e12", "1e12", "1e12"],
    ["run", "--wave-model", "airy", "--f32", "--solver", "pcg",
     "--pcg-precond", "two_level", "--pcg-chunk", "50", "--pcg-tol", "1e-9"],
], ids=lambda a: " ".join(a))
def test_subcommand_stdout_matches_jax(argv):
    jax_out, port_out = run_pair(argv)
    assert_same_text(port_out, jax_out, f32="--f32" in argv)


def test_run_outputs_match_jax(tmp_path):
    """``run`` with every output flag: the stdout report, the JSON, the
    CSV, the npz results and the model JSON of both CLIs at 1e-8."""
    outs = {}
    for tag, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        argv = ["run", "--wave-model", "airy", "--csv", str(d / "f.csv"),
                "--json-out", str(d / "r.json"),
                "--save-results", str(d / "r.npz"),
                "--save-model", str(d / "m.json"), *extra]
        outs[tag] = (run(main, argv), d)
    (jtext, jd), (ttext, td) = outs["jax"], outs["port"]
    assert_same_text(ttext, jtext)
    assert "ANALYSIS COMPLETE" in ttext
    assert json_err(td / "r.json", jd / "r.json") <= FILE_TOL
    rows = []
    for d in (td, jd):
        with open(d / "f.csv", newline="") as f:
            rows.append(list(csv.reader(f)))
    assert rows[0][0] == rows[1][0]
    assert [r[:4] for r in rows[0]] == [r[:4] for r in rows[1]]
    xa = np.array([r[4:] for r in rows[0][1:]], float)
    xb = np.array([r[4:] for r in rows[1][1:]], float)
    assert rel_err(xa, xb) <= FILE_TOL
    na, nb = np.load(td / "r.npz", allow_pickle=True), \
        np.load(jd / "r.npz", allow_pickle=True)
    assert set(na.files) == set(nb.files)
    for k in nb.files:
        if nb[k].dtype.kind == "f" and nb[k].size:
            assert rel_err(na[k], nb[k]) <= FILE_TOL, k
        else:
            assert np.array_equal(na[k], nb[k]), k
    ma, mb = (json.loads((d / "m.json").read_text()) for d in (td, jd))
    assert ma == mb
    res = pt.load_results(td / "r.npz")
    assert type(res).__name__ == "AnalysisResults"


def test_save_default_matches_jax(tmp_path):
    outs = [run(main, ["save-default", str(tmp_path / f"{tag}.json"),
                       *extra])
            for tag, main, extra in (("jax", jcli.main, []),
                                     ("port", tcli.main,
                                      ["--device", "cpu"]))]
    assert outs == [f"wrote {tmp_path / 'jax.json'}\n",
                    f"wrote {tmp_path / 'port.json'}\n"]
    assert json.loads((tmp_path / "jax.json").read_text()) == \
        json.loads((tmp_path / "port.json").read_text())


def test_f32_runs_float32_throughout(tmp_path, monkeypatch):
    """``--f32``: the model, the wave, the sea and the wave batch that the
    CLI builds are float32, and so is every floating result ``run``
    persists (the port passes the run's dtype wherever the JAX package
    relies on x64 being off)."""
    from small_fem_solver_tpu_torch.ops import spectrum
    from small_fem_solver_tpu_torch.parallel import sweep
    built = []

    def spy(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            built.append(out if isinstance(out, tuple) else (out,))
            return out
        return wrapped
    monkeypatch.setattr(tcli, "_setup", spy(tcli._setup))
    monkeypatch.setattr(spectrum, "make_random_sea",
                        spy(spectrum.make_random_sea))
    monkeypatch.setattr(sweep, "make_wave_batch", spy(sweep.make_wave_batch))
    path = tmp_path / "run.npz"
    for argv in (["run", "--wave-model", "airy", "--refine", "2",
                  "--save-results", str(path)],
                 ["spectral", "--refine", "2", "--components", "8", "--hs",
                  "6", "--tp", "9"],
                 ["sweep", "--H-range", "8", "17", "2"]):
        run(tcli.main, [*argv, "--f32", "--device", "cpu"])
    # models carry .dtype, Fourier waves E, seas omega; cases are skipped
    dtypes = [getattr(o, "dtype", None) or getattr(o, "E", None).dtype
              if hasattr(o, "dtype") or hasattr(o, "E") else o.omega.dtype
              for objs in built for o in objs if not hasattr(o, "Cd")]
    assert len(dtypes) == 8 and set(dtypes) == {torch.float32}, dtypes
    data = np.load(path, allow_pickle=True)
    kinds = {k: data[k].dtype for k in data.files if data[k].dtype.kind == "f"}
    assert kinds and set(kinds.values()) == {np.dtype(np.float32)}, kinds


def test_no_card_without_device_exits_naming_device_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default runs there")
    with pytest.raises(SystemExit) as exc:
        tcli.main(["run", "--wave-model", "airy"])
    assert exc.value.code != 0 and "--device cpu" in str(exc.value.code)
    with pytest.raises(SystemExit) as exc:
        tcli.main(["save-default", "x.json"])
    assert "--device cpu" in str(exc.value.code)


def test_cli_holds_no_cpu_detour():
    """No path of the port's CLI moves work to the CPU: no ``_cpu_if_f64``,
    no ``default_device``, no CPU device or ``.cpu()`` in its code (host
    copies for printing go through ``utils.io._np``), and no JAX."""
    src = (REPO / "small_fem_solver_tpu_torch" / "cli.py").read_text()
    code = re.sub(r'"""[\s\S]*?"""', "", src)
    code = "\n".join(line.split("#")[0] for line in code.splitlines())
    for bad in ("_cpu_if_f64", "default_device", ".cpu()", 'device="cpu"',
                "device('cpu')", 'device("cpu")', "jax", "except"):
        assert bad not in code, bad


def test_module_entry_point(tmp_path):
    """``python -m small_fem_solver_tpu_torch.cli`` exits 0 and writes the
    same JSON as the in-process call."""
    path = tmp_path / "sub.json"
    argv = ["run", "--phase-scan", "--wave-model", "airy", "--device", "cpu"]
    proc = subprocess.run([sys.executable, "-m",
                           "small_fem_solver_tpu_torch.cli", *argv,
                           "--json-out", str(path)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    run(tcli.main, [*argv, "--json-out", str(tmp_path / "in.json")])
    assert json.loads(path.read_text()) == \
        json.loads((tmp_path / "in.json").read_text())
    assert "ANALYSIS COMPLETE" in proc.stdout


def test_run_plot_writes_png(tmp_path):
    """``run --plot`` writes the utilization plot (matplotlib, imported by
    ``utils.plotting`` only; skipped where it is absent)."""
    pytest.importorskip("matplotlib")
    path = tmp_path / "u.png"
    run(tcli.main, ["run", "--wave-model", "airy", "--plot", str(path),
                    "--device", "cpu"])
    assert path.stat().st_size > 10_000
