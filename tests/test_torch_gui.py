"""The port's GUI (``small_fem_solver_tpu_torch.gui``) against the JAX
package's on the CPU: the headless core (``parse_params``,
``run_analysis_core`` against the default golden at 1e-8 and against JAX's
at 1e-10, with and without foundation springs), the Members tab's
appurtenance handlers driven through stubs, ``INFO_TEXT``, and the widget
tree where a display exists (skipped otherwise, as ``tests/test_gui.py``
does).  The Results tab's handlers are in ``test_torch_gui_handlers.py``."""
import numpy as np
import pytest

import small_fem_solver_tpu.gui as jgui
from small_fem_solver_tpu.models.presets import default_3leg_jacket_geometry
import small_fem_solver_tpu_torch.gui as tgui
from test_torch_convert import rel_err
from torch_cli_compare import assert_same_text

GOLDEN_TOL = 1e-8     # the default golden (tests/test_gui.py)
JAX_TOL = 1e-10       # the JAX package's run_analysis_core
SPRINGS = [1e6, 1e6, 1e6, 1e12, 1e12, 1e12]
FIELDS = ("U", "reactions", "F1_local", "F2_local", "von_mises",
          "utilization", "max_displacement_mm")


def _geometry():
    return default_3leg_jacket_geometry(47.0)


def core_pair(springs=None, do_phase_scan=True):
    """(JAX result, port result, (JAX log, port log)) of
    run_analysis_core on the untouched GUI's storm with the Airy wave
    (the golden's theory)."""
    raw = dict(jgui.DEFAULT_RAW_PARAMS, wave_model="airy")
    kw = dict(do_phase_scan=do_phase_scan, springs=springs)
    logs = ([], [])
    return (jgui.run_analysis_core(jgui.parse_params(raw), *_geometry(),
                                   log=logs[0].append, **kw),
            tgui.run_analysis_core(tgui.parse_params(raw), *_geometry(),
                                   log=logs[1].append, device="cpu", **kw),
            logs)


@pytest.fixture(scope="module")
def runs():
    """With a phase scan on rigid supports, and without one on springs."""
    return {"airy": core_pair(), "springs": core_pair(SPRINGS, False)}


def test_parse_params_matches_jax():
    """The full surface parses as in the JAX package, and bad input raises
    the same ValueError."""
    assert tgui.DEFAULT_RAW_PARAMS == jgui.DEFAULT_RAW_PARAMS
    for name in ("PARAM_KEYS_FLOAT", "PARAM_KEYS_INT", "PARAM_KEYS_STR"):
        assert getattr(tgui, name) == getattr(jgui, name)
    for raw in (tgui.DEFAULT_RAW_PARAMS,
                dict(tgui.DEFAULT_RAW_PARAMS, N="12.0", wave_model="airy",
                     sw_mode="none", marine_growth="25")):
        p = tgui.parse_params(raw)
        assert p == jgui.parse_params(raw)
        assert isinstance(p["N"], int)
    bad = dict(tgui.DEFAULT_RAW_PARAMS)
    del bad["Cd"]
    for raw in (dict(tgui.DEFAULT_RAW_PARAMS, H="not-a-number"),
                dict(tgui.DEFAULT_RAW_PARAMS, N=None), bad):
        with pytest.raises(ValueError) as want:
            jgui.parse_params(raw)
        with pytest.raises(ValueError, match=str(want.value).replace(
                "(", r"\(").replace(")", r"\)")):
            tgui.parse_params(raw)


def test_run_analysis_core_matches_golden_and_jax(runs, golden_default):
    jout, tout, (jlog, tlog) = runs["airy"]
    util_ref = np.array([m["utilization"] for m in
                         golden_default["fem"]["internal_forces"]])
    np.testing.assert_allclose(tout["res"].utilization.numpy(), util_ref,
                               rtol=GOLDEN_TOL)
    for f in FIELDS:
        assert rel_err(getattr(tout["res"], f), getattr(jout["res"], f)) \
            <= JAX_TOL, f
    for f in ("t", "total_kN", "drag_kN", "inertia_kN"):
        assert rel_err(getattr(tout["scan"], f), getattr(jout["scan"], f)) \
            <= JAX_TOL, f
    assert int(tout["scan"].critical_index) == int(jout["scan"].critical_index)
    assert tout["util"] == float(tout["res"].utilization.max())
    assert abs(tout["util"] / jout["util"] - 1.0) <= JAX_TOL
    assert_same_text(tout["report"], jout["report"])
    assert tout["model"].device.type == "cpu"
    # the log: JAX's lines, the solve's line saying where it runs
    assert tlog[:2] == jlog[:2] and tlog[3:] == [tout["report"]]
    assert tlog[2] == "Solving (float64 on cpu)..."


def test_run_analysis_core_springs_matches_jax(runs):
    jout, tout, (jlog, tlog) = runs["springs"]
    assert tout["scan"] is None
    for f in FIELDS:
        assert rel_err(getattr(tout["res"], f), getattr(jout["res"], f)) \
            <= JAX_TOL, f
    assert_same_text(tout["report"], jout["report"])
    assert [m for m in tlog if "foundation" in m] == \
        [m for m in jlog if "foundation" in m]
    rigid = tgui.run_analysis_core(tgui.parse_params(dict(
        tgui.DEFAULT_RAW_PARAMS, wave_model="airy")), *_geometry(),
        do_phase_scan=False, device="cpu")
    assert float(tout["res"].max_displacement_mm) > \
        float(rigid["res"].max_displacement_mm)


def test_appurtenance_handlers_match_jax():
    """The Members tab's appurtenance editor, headless."""
    class FakeEntry:
        def __init__(self, v):
            self.v = v

        def get(self):
            return self.v

    class FakeTree:
        def __init__(self):
            self.rows = []

        def delete(self, *a):
            self.rows = []

        def get_children(self):
            return ()

        def insert(self, where, end, values=()):
            self.rows.append(values)

        def selection(self):
            return ()

    states = []
    for gui in (jgui, tgui):
        class Stub:
            nodes_data = {"A1": [0.0, 0.0, -40.0], "A2": [0.0, 0.0, -20.0]}
            add_appurtenance = gui.JacketGUI.add_appurtenance
            delete_appurtenance = gui.JacketGUI.delete_appurtenance
            refresh_appurtenances = gui.JacketGUI.refresh_appurtenances

            def update_3d_preview(self):
                pass
        s = Stub()
        s.apps_data, s.app_tree = [], FakeTree()
        s.app_entries = {k: FakeEntry(v) for k, v in dict(
            name="R1", node1="a1", node2="A2", D_mm="610", cd_mult="0.8",
            cm_mult="1.0").items()}
        s.add_appurtenance()
        s.delete_appurtenance()          # nothing selected: the row stays
        states.append((s.apps_data, s.app_tree.rows))
    assert states[0] == states[1]
    assert states[1][0] == [{"name": "R1", "node1": "A1", "node2": "A2",
                             "D_mm": 610.0, "cd_mult": 0.8,
                             "cm_mult": 1.0}]


def test_info_text_matches_jax_apart_from_the_tpu():
    """INFO_TEXT is JAX's, line for line, except the title line that names
    the TPU."""
    jl, tl = jgui.INFO_TEXT.splitlines(), tgui.INFO_TEXT.splitlines()
    assert len(jl) == len(tl) > 150
    diff = [(a, b) for a, b in zip(jl, tl) if a != b]
    assert len(diff) == 1 and "TPU" in diff[0][0] and "TPU" not in diff[0][1]
    assert "TPU" not in tgui.INFO_TEXT


def _display_works() -> str | None:
    try:
        import tkinter as tk
    except ImportError as e:
        return f"no tkinter: {e}"
    try:
        root = tk.Tk()
        root.destroy()
        return None
    except tk.TclError as e:
        return f"no usable display: {e}"


def test_gui_builds_widget_tree():
    """The whole widget tree on a display (skipped without one, as
    ``tests/test_gui.py`` does)."""
    reason = _display_works()
    if reason is not None:
        pytest.skip(reason)
    import tkinter as tk
    root = tk.Tk()
    try:
        app = tgui.JacketGUI(root, device="cpu")
        assert len(app.nodes_data) == 21 and len(app.members_data) == 51
        p = app._params()
        assert p["H"] == 17.038
        assert app._build_model(p).n_members == 51
        app.update_3d_preview()
    finally:
        root.destroy()
