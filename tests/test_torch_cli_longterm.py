"""The port's CLI against the JAX package's on the CPU (stdout by
``torch_cli_compare.text_diff``): ``contour`` (the fit, ``--envelope``,
``--spectral``) and ``reliability`` (FORM, and the importance-sampling
check) on a synthetic (Hs, Tp) climate, and ``optimize``."""
import pytest

from torch_cli_compare import assert_same_text, climate, run_pair

AIRY = ["--wave-model", "airy"]


@pytest.fixture(scope="module")
def clim(tmp_path_factory):
    return climate(tmp_path_factory.mktemp("climate") / "climate.json")


@pytest.mark.parametrize("argv", [
    ["contour", "--return-years", "50", "--points", "6"],
    ["contour", "--return-years", "50", "--points", "6", "--envelope",
     *AIRY],
    ["contour", "--return-years", "50", "--points", "6", "--spectral",
     "--components", "10", "--refine", "2", *AIRY],
    ["reliability", *AIRY],
    ["reliability", "--threshold", "0.3", "--monte-carlo", "200", *AIRY],
], ids=lambda a: " ".join(a))
def test_climate_subcommand_stdout_matches_jax(argv, clim):
    jax_out, port_out = run_pair([argv[0], "--scatter", clim, *argv[1:]])
    assert_same_text(port_out, jax_out)


def test_optimize_stdout_matches_jax():
    jax_out, port_out = run_pair(["optimize", "--n-iter", "3", *AIRY])
    assert_same_text(port_out, jax_out)
