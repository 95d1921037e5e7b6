"""The port's CLI against the JAX package's on the CPU (stdout by
``torch_cli_compare.text_diff``): the design-tier subcommands
``pushover`` (and its heading rose), ``robustness``, ``code-check`` (API
and ISO), ``joint-check``, ``viv`` and ``air-gap`` (``pile`` and
``seismic`` are in ``test_torch_cli_foundation.py``)."""
import pytest

from torch_cli_compare import assert_same_text, run_pair

AIRY = ["--wave-model", "airy"]


@pytest.mark.parametrize("argv", [
    ["pushover", "--n-lambda", "5", "--iterations", "30", *AIRY],
    ["pushover", "--n-lambda", "5", "--iterations", "30", "--rose", "4",
     *AIRY],
    ["robustness", *AIRY],
    ["code-check", *AIRY],
    ["code-check", "--standard", "iso", *AIRY],
    ["joint-check", "--joint-class", "K", "--gap", "75.0", *AIRY],
    ["joint-check", "--joint-class", "auto", *AIRY],
    ["viv", "--current-alpha", "0.1429", "--flooded", "legs"],
    ["air-gap", *AIRY],
], ids=lambda a: " ".join(a))
def test_subcommand_stdout_matches_jax(argv):
    jax_out, port_out = run_pair(argv)
    assert_same_text(port_out, jax_out)

