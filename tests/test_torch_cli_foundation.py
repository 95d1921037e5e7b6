"""The port's CLI against the JAX package's on the CPU (stdout by
``torch_cli_compare.text_diff``): ``pile`` (springs from the clamped
analysis's reactions, then the SSI run) and ``seismic``.  The pile head
at the working loads and the Craig-Bampton spectrum (``--refine`` > 1)
run on the port alone (``test_torch_soil.py`` and
``test_torch_seismic.py`` hold ``pile_head_stiffness`` and
``response_spectrum_condensed`` against JAX)."""
import pytest

from torch_cli_compare import assert_same_text, run_pair, run_port

AIRY = ["--wave-model", "airy"]


@pytest.mark.parametrize("argv", [
    ["pile", "--from-analysis", "--analyze", *AIRY],
    ["seismic", *AIRY],
], ids=lambda a: " ".join(a))
def test_subcommand_stdout_matches_jax(argv):
    jax_out, port_out = run_pair(argv)
    assert_same_text(port_out, jax_out)


def test_pile_from_working_loads_runs():
    out = run_port(["pile", *AIRY])
    assert "pile head at working loads H=2000.0 kN, V=15000.0 kN" in out
    assert out.count("  support ") == 3


def test_condensed_spectrum_runs():
    out = run_port(["seismic", "--refine", "2", "--ground", "C",
                    "--vertical", *AIRY])
    assert "Craig-Bampton reduced spectrum analysis: 432 DOF" in out
    assert "over 3 directions" in out
