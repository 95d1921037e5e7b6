"""Helpers of the CLI tests (``tests/test_torch_cli*.py``): run the JAX
package's ``cli.main`` and the port's ``cli.main(argv + ["--device",
"cpu"])`` on one argv in this process with stdout captured, and compare
the two texts by ``cli_text.text_diff``: the text with every number
masked is equal, and each number lies within one unit of its last
printed digit (``--f32`` runs: within 1e-4 relative, or one unit,
whichever is larger).

Every run of the JAX CLI here has ``jax_enable_x64`` on (``conftest.py``),
so a JAX ``--f32`` run builds its model and wave in float32 and every
other array in float64; the port's ``--f32`` runs in float32 throughout.
"""
import contextlib
import io
import json

import numpy as np

import small_fem_solver_tpu.cli as jcli
import small_fem_solver_tpu_torch.cli as tcli
import test_torch_convert  # noqa: F401  (the port tests' thread policy)
from cli_text import text_diff

def run(main, argv) -> str:
    """stdout of ``main(argv)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(list(argv))
    return buf.getvalue()


def run_pair(argv) -> tuple[str, str]:
    """(JAX stdout, port stdout) of one argv; the port on the CPU."""
    return run(jcli.main, argv), run(tcli.main, [*argv, "--device", "cpu"])


def run_port(argv) -> str:
    """stdout of the port's CLI alone on the CPU (the branches whose JAX
    runs would cost tens of seconds of compiles each: ``--refine`` > 1 on
    the dense-by-default subcommands, the dynamic transfers)."""
    return run(tcli.main, [*argv, "--device", "cpu"])


def assert_same_text(a: str, b: str, f32: bool = False):
    bad = text_diff(a, b, f32)
    assert not bad, "\n".join(bad[:20]) + f"\n--- port ---\n{a}\n--- JAX ---\n{b}"


def json_err(pa, pb) -> float:
    """Largest relative difference of the numbers of two ``--json-out``
    files (member table columns, reactions, displacement), each column
    against its own maximum."""
    a, b = json.loads(open(pa).read()), json.loads(open(pb).read())
    assert [m["member"] for m in a["member_forces"]] == \
        [m["member"] for m in b["member_forces"]]
    assert list(a["reactions"]) == list(b["reactions"])
    cols = [k for k, v in b["member_forces"][0].items()
            if isinstance(v, float)]
    errs = []
    for k in cols:
        xa = np.array([m[k] for m in a["member_forces"]])
        xb = np.array([m[k] for m in b["member_forces"]])
        errs.append(np.abs(xa - xb).max() / max(np.abs(xb).max(), 1e-300))
    ra, rb = np.array(list(a["reactions"].values())), \
        np.array(list(b["reactions"].values()))
    errs.append(np.abs(ra - rb).max() / np.abs(rb).max())
    errs.append(abs(a["max_displacement_mm"] / b["max_displacement_mm"] - 1))
    return float(max(errs))


def climate(path, n=300, seed=0):
    """A synthetic (Hs, Tp) scatter JSON at ``path`` (the one of
    ``tests/test_io_cli.py::test_cli_contour_spectral``)."""
    rng = np.random.default_rng(seed)
    hs = rng.weibull(1.5, n) * 3.0 + 0.3
    tp = 5.0 + 1.9 * np.sqrt(hs) + rng.normal(0, 0.5, n)
    path.write_text(json.dumps([[float(h), float(t)]
                                for h, t in zip(hs, tp)]))
    return str(path)
