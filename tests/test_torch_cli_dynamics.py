"""The port's CLI against the JAX package's on the CPU (stdout by
``torch_cli_compare.text_diff``): the dynamics and second-order
subcommands ``modes``, ``dynamic``, ``transient``, ``buckling`` and
``pdelta`` (``seismic`` is in ``test_torch_cli_foundation.py``).  Their
Craig-Bampton and condensed branches
(``--refine`` > 1) and the sea-driven transient run on the port alone
(the library calls under them are held against JAX in
``test_torch_dynamics.py``, ``test_torch_pdelta.py`` and
``test_torch_spectrum_dynamics.py``; here the CLI's wiring of them)."""
import pytest

from torch_cli_compare import assert_same_text, run_pair, run_port

AIRY = ["--wave-model", "airy"]


@pytest.mark.parametrize("argv", [
    ["modes", "--n-modes", "4", *AIRY],
    ["dynamic", *AIRY],
    ["transient", "--refine", "2", "--periods", "2", *AIRY],
    ["buckling", *AIRY],
    ["pdelta", *AIRY],
], ids=lambda a: " ".join(a))
def test_subcommand_stdout_matches_jax(argv):
    jax_out, port_out = run_pair(argv)
    assert_same_text(port_out, jax_out)


@pytest.mark.parametrize("argv,banner", [
    (["modes", "--refine", "2", "--n-modes", "4"],
     "Craig-Bampton reduced modal analysis: 432 DOF -> 738 reduced DOF"),
    (["dynamic", "--refine", "2", "--phase-steps", "24", "--n-harmonics",
      "4"], "Craig-Bampton reduced dynamic response: 432 DOF refined mesh"),
    (["transient", "--spectrum", "jonswap", "--components", "12",
      "--periods", "2", "--refine", "2"],
     "irregular sea: JONSWAP Hs=17.038 m Tp=9.4 s, 12 components"),
    (["buckling", "--refine", "2"],
     "Craig-Bampton reduced buckling: 432 DOF, 12 retained modes/chain"),
    (["pdelta", "--refine", "2"], "condensed P-delta: 432 DOF"),
], ids=lambda a: " ".join(a) if isinstance(a, list) else "")
def test_port_branch_runs(argv, banner):
    out = run_port([*argv, *AIRY])
    assert banner in out, out
