"""The port GUI's Results-tab handlers that compute (``show_summary``,
``show_code_checks``, ``show_damage_screen``, ``show_spectral_fatigue``),
driven through stubs on each package's storm results on the CPU: the same
text as the JAX package's handlers (``torch_cli_compare.text_diff``)."""
import pytest

import small_fem_solver_tpu.gui as jgui
import small_fem_solver_tpu_torch.gui as tgui
from test_torch_gui import core_pair
from torch_cli_compare import assert_same_text


@pytest.fixture(scope="module")
def storm():
    return core_pair()


class FakeText:
    def __init__(self):
        self.buf = []

    def delete(self, *a):
        self.buf = []

    def insert(self, where, txt):
        assert where in ("end", "1.0")
        self.buf.append(txt)


def _handler_text(gui, out, handler):
    class Stub:
        analysis_results = out["res"]
        analysis_model = out["model"]
        analysis_wave = out["wave"]
        analysis_case = out["case"]
        results_text = FakeText()
    Stub.handler = getattr(gui.JacketGUI, handler)
    s = Stub()
    s.handler()
    return "".join(s.results_text.buf)


@pytest.mark.parametrize("handler", ["show_summary", "show_code_checks",
                                     "show_damage_screen",
                                     "show_spectral_fatigue"])
def test_results_handlers_match_jax(storm, handler):
    """The Results tab's computing handlers on each package's storm results
    (Airy), driven through stubs: the same text."""
    jout, tout, _ = storm
    jtext = _handler_text(jgui, jout, handler)
    ttext = _handler_text(tgui, tout, handler)
    assert len(ttext) > 200
    assert_same_text(ttext, jtext)
