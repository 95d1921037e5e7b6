"""The port's CLI against the JAX package's on the CPU (stdout by
``torch_cli_compare.text_diff``): ``fatigue`` by all four routes
(deterministic, ``--spectrum``, ``--scatter`` and ``--scatter
--freq-domain`` with long-term extremes) and ``spectral``, with the
``--save-results`` files at 1e-8.  The Craig-Bampton dynamic transfer
(``--dynamic``) runs on the port alone (``spectral_response_dynamic`` and
the dynamic scatter are held against JAX in
``test_torch_spectrum_dynamics.py``)."""
import numpy as np
import pytest

import small_fem_solver_tpu_torch.cli as tcli
from torch_cli_compare import assert_same_text, jcli, run, run_pair, run_port

AIRY = ["--wave-model", "airy"]
FILE_TOL = 1e-8


@pytest.mark.parametrize("argv", [
    ["fatigue", "--refine", "2", "--phase-steps", "12", *AIRY],
    ["fatigue", "--spectrum", "jonswap", "--hs", "9.0", "--tp", "9.4",
     "--sea-steps", "128", "--components", "24", "--scf", "2.0", *AIRY],
    ["fatigue", "--scatter", "[[4.0, 8.0, 0.5], [8.0, 9.4, 0.1]]",
     "--sea-steps", "64", "--components", "12", "--refine", "2", "--scf",
     "2.0", *AIRY],
    ["fatigue", *AIRY],
], ids=lambda a: " ".join(a))
def test_subcommand_stdout_matches_jax(argv):
    jax_out, port_out = run_pair(argv)
    assert_same_text(port_out, jax_out)


@pytest.mark.parametrize("argv", [
    ["spectral", "--hs", "9.0", "--tp", "11.0", "--components", "16",
     "--refine", "2", "--storm-hours", "6", *AIRY],
    ["fatigue", "--scatter", "[[4.0, 8.0, 0.4, 30.0], [7.0, 9.4, 0.1, "
     "120.0]]", "--components", "10", "--refine", "2", "--freq-domain",
     "--return-years", "10,100", *AIRY],
], ids=lambda a: " ".join(a[:2]))
def test_saved_results_match_jax(argv, tmp_path):
    """stdout, and the ``--save-results`` npz of both CLIs at 1e-8.  A mean
    stress is that of the member's governing circumferential point, an
    argmax over 8 variances in which opposite points of a member tie to
    roundoff, so either package may pick either point: those fields
    (``*mean*``) are held to one of the tied points in
    ``test_torch_spectrum.py`` (``tie_candidates``), not here."""
    texts = [run(main, [*argv, "--save-results", str(tmp_path / f"{t}.npz"),
                        *extra])
             for t, main, extra in (("jax", jcli.main, []),
                                    ("port", tcli.main,
                                     ["--device", "cpu"]))]
    assert_same_text(texts[1], texts[0])
    a = np.load(tmp_path / "port.npz", allow_pickle=True)
    b = np.load(tmp_path / "jax.npz", allow_pickle=True)
    assert set(a.files) == set(b.files)
    for k in b.files:
        if "mean" in k:
            assert a[k].shape == b[k].shape and np.isfinite(a[k]).all(), k
        elif b[k].dtype.kind == "f" and b[k].size:
            x, y = a[k].astype(np.float64), b[k].astype(np.float64)
            fin = np.isfinite(y)
            assert np.array_equal(fin, np.isfinite(x)), k
            err = np.abs(x[fin] - y[fin]).max(initial=0.0) \
                / max(np.abs(y[fin]).max(initial=0.0), 1e-300)
            assert err <= FILE_TOL, (k, err)
        else:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("argv,banner", [
    (["spectral", "--hs", "9.0", "--tp", "11.0", "--components", "12",
      "--refine", "2", "--dynamic", "--damping", "0.03", "--hydro-damping"],
     "dynamic CB transfer, zeta=0.03"),
    (["fatigue", "--scatter", "[[4.0, 8.0, 0.4], [7.0, 9.4, 0.1, 120.0]]",
      "--components", "10", "--refine", "2", "--freq-domain", "--dynamic"],
     "scatter-diagram fatigue (frequency-domain DYNAMIC (CB)): 2 sea states"),
], ids=["spectral --dynamic", "fatigue --freq-domain --dynamic"])
def test_port_dynamic_transfer_runs(argv, banner):
    out = run_port([*argv, *AIRY])
    assert banner in out and "Life [y]" in out, out
