"""PyTorch port vs the JAX package: model JSON (files cross-load between
the packages), the member-force table and its CSV, the text reports
(non-numeric text equal, numbers 1e-9 relative), ``validate_sections``,
and the six plot functions (each writes a non-empty PNG).  f64 on the CPU,
the default jacket with a conductor and pinned h-braces under the Airy
storm."""
import csv
import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.models.presets import default_3leg_jacket_geometry
from small_fem_solver_tpu.ops import sections as jsections
from small_fem_solver_tpu.utils import io as jio
from small_fem_solver_tpu.utils import report as jreport
import small_fem_solver_tpu_torch as pt
from small_fem_solver_tpu_torch.utils import io as tio
from small_fem_solver_tpu_torch.utils import report as treport
from test_torch_convert import port_case, port_model, port_wave

TEXT_TOL = 1e-9       # numbers in the reports, relative
TABLE_TOL = 1e-9      # member-force table, relative to each column's max
STORM = dict(wave_dir_deg=38.0, current_dir_deg=38.0, F_axial_kN=25100.0,
             F_shear_kN=2900.0, custom_sw_tonnes=1100.0, sw_mode="custom")
CONDUCTOR = [{"name": "C1", "node1": "A2", "node2": "A3", "D_mm": 700.0,
              "cd_mult": 0.8, "cm_mult": 1.1}]
NUMBER = re.compile(r"[-+]?\d+\.?\d*(?:[eE][-+]?\d+)?")


def _jax_model():
    """The default jacket with pinned h-braces and one conductor."""
    nodes, members, fixed, top = default_3leg_jacket_geometry()
    members = [dict(m, release="pinned") if m["type"] == "h_brace" else m
               for m in members]
    return sf.add_appurtenances(sf.build_model(nodes, members, fixed, top),
                                CONDUCTOR)


@pytest.fixture(scope="module")
def storm():
    """The storm analysis and phase scan in both packages."""
    jm = _jax_model()
    jw = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    jc = sf.LoadCase(**STORM, t_analysis=0.34)
    tm, tw, tc = port_model(jm), port_wave(jw), port_case(jc)

    def scan(m, pkg, wave):
        D_m = m.sections.D_outer[m.sect_id] / 1000.0
        return pkg.phase_scan(wave, m.coords, m.conn, D_m, 38.0, 38.0, 0.7,
                              2.0, 1025.0, n_steps=12)
    # JAX's scan jitted: op by op it costs seconds
    return {"jax": (jm, jw, jc, sf.analyze(jm, jw, jc, solver="chol"),
                    jax.jit(lambda: scan(jm, sf, jw))()),
            "port": (tm, tw, tc, pt.analyze(tm, tw, tc, solver="chol"),
                     scan(tm, pt, tw))}


def _same_text(out: str, ref: str):
    """Equal text with the numbers taken out; the numbers 1e-9
    relative."""
    assert NUMBER.sub("#", out) == NUMBER.sub("#", ref)
    for a, b in zip(NUMBER.findall(out), NUMBER.findall(ref)):
        assert abs(float(a) - float(b)) <= TEXT_TOL * abs(float(b)), (a, b)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_json_cross_loads(tmp_path, writer):
    """A model file written by either package (releases, appurtenances,
    parameters) loads in the other; both packages write the same dict."""
    jm = _jax_model()
    tm = port_model(jm)
    assert tio.model_to_dict(tm, {"H": 17.038}) == jio.model_to_dict(
        jm, {"H": 17.038})
    path = tmp_path / "jacket.json"
    if writer == "port":
        tio.save_model(path, tm, params={"H": 17.038})
        m2, params = jio.load_model(path)
        same = port_model(m2)
    else:
        jio.save_model(path, jm, params={"H": 17.038})
        same, params = tio.load_model(path, device="cpu")
    assert params == {"H": 17.038}
    assert same.device.type == "cpu" and same.dtype == torch.float64
    for f in ("node_names", "member_names", "member_types", "app_names"):
        assert getattr(same, f) == getattr(tm, f), f
    for f in ("coords", "conn", "sect_id", "fixed_mask", "top_mask",
              "release", "app_conn", "app_D_mm", "app_cd_mult",
              "app_cm_mult"):
        assert torch.equal(getattr(same, f), getattr(tm, f)), f
    for f in pt.TubeSections._fields:
        assert torch.equal(getattr(same.sections, f),
                           getattr(tm.sections, f)), f
    f32, _ = tio.load_model(path, dtype=torch.float32, device="cpu")
    assert f32.coords.dtype == torch.float32
    with pytest.raises(ValueError, match="2-section"):
        tio.model_to_dict(dataclasses.replace(tm, sections=pt.tube_sections(
            [2000.0, 800.0, 900.0], [75.0, 30.0, 35.0], device="cpu")))


def test_member_force_table_and_csv_match_jax(storm, tmp_path):
    """The reference's member-force records and the CSV with its columns
    (written through the standard library's ``csv``: the card host has no
    pandas)."""
    jm, _, _, jres, _ = storm["jax"]
    tm, _, _, tres, _ = storm["port"]
    rows, ref = tio.member_force_table(tm, tres), jio.member_force_table(
        jm, jres)
    assert [list(r) for r in rows] == [list(r) for r in ref]
    for col in tio.CSV_COLUMNS:
        a = [r[col] for r in rows]
        b = [r[col] for r in ref]
        if isinstance(b[0], str):
            assert a == b, col
        else:
            assert np.abs(np.subtract(a, b)).max() <= TABLE_TOL * max(
                np.abs(b).max(), 1e-300), col
    tio.export_csv(tmp_path / "port.csv", tm, tres)
    jio.export_csv(tmp_path / "jax.csv", jm, jres)
    with open(tmp_path / "port.csv") as f:
        got = list(csv.reader(f))
    with open(tmp_path / "jax.csv") as f:
        want = list(csv.reader(f))
    assert got[0] == want[0] == tio.CSV_COLUMNS
    assert len(got) == len(want) == tm.n_members + 1
    for g, w in zip(got[1:], want[1:]):
        assert g[:4] == w[:4]
        np.testing.assert_allclose(np.array(g[4:], float),
                                   np.array(w[4:], float), rtol=TABLE_TOL,
                                   atol=1e-12)


def test_reports_match_jax(storm):
    """``render_report`` with the phase scan and ``render_code_checks``
    (member and 'auto' joint checks): the JAX package's text."""
    jm, jw, jc, jres, jscan = storm["jax"]
    tm, tw, tc, tres, tscan = storm["port"]
    out = treport.render_report(tm, tw, tc, tres, phase_scan=tscan)
    ref = jreport.render_report(jm, jw, jc, jres, phase_scan=jscan)
    assert "SUPPORT REACTIONS" in out and "Deck air gap" in out
    _same_text(out, ref)
    _same_text(treport.render_code_checks(tm, tres, top_n=10),
               jreport.render_code_checks(jm, jres, top_n=10))


def test_validate_sections_matches_jax():
    """D/t <= 10 flags a section with the JAX package's message; strict
    raises; a valid layout passes."""
    D, t = [2000.0, 800.0, 300.0], [75.0, 90.0, 30.0]
    out = pt.validate_sections(pt.tube_sections(D, t, device="cpu"))
    ref = jsections.validate_sections(sf.tube_sections(jnp.asarray(D),
                                                       jnp.asarray(t)))
    assert out == ref and len(out) == 2
    with pytest.raises(ValueError, match="D/t"):
        pt.validate_sections(pt.tube_sections(D, t, device="cpu"),
                             strict=True)
    assert pt.validate_sections(pt.default_3leg_jacket(
        device="cpu").sections, strict=True) == []


def test_library_imports_no_matplotlib_and_no_jax():
    """The package, its reliability, design, I/O and report modules import
    neither matplotlib (absent on the GPU host; only ``utils.plotting``
    needs it) nor JAX."""
    code = ("import sys; import small_fem_solver_tpu_torch; "
            "from small_fem_solver_tpu_torch.ops import reliability, design; "
            "from small_fem_solver_tpu_torch.utils import io, report; "
            "bad = {'matplotlib', 'jax', 'small_fem_solver_tpu'} "
            "& set(sys.modules); assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("tk", ["tk_present", "tk_absent"])
def test_cli_and_gui_import_no_matplotlib_jax_or_tk(tk):
    """The CLI and the GUI's headless core import neither matplotlib nor
    JAX nor the JAX package, and the GUI module imports no tkinter (only
    building a widget does), so both load where Tk is absent
    (``sys.modules["tkinter"] = None`` makes any import of it fail)."""
    block = "sys.modules['tkinter'] = None; " if tk == "tk_absent" else ""
    code = ("import sys; " + block
            + "import small_fem_solver_tpu_torch.cli as c; "
            "import small_fem_solver_tpu_torch.gui as g; "
            "from small_fem_solver_tpu_torch.gui import (INFO_TEXT, "
            "DEFAULT_RAW_PARAMS, PARAM_KEYS_FLOAT, parse_params, "
            "build_model_from_data, run_analysis_core, JacketGUI); "
            "assert g.JacketGUI.show_damage_screen and c.main; "
            "bad = {'matplotlib', 'jax', 'small_fem_solver_tpu', 'tkinter'} "
            "& {m for m in sys.modules if sys.modules[m] is not None}; "
            "assert not bad, bad")
    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("plot", ["structure", "utilization", "phase_scan",
                                  "mode", "pushover", "transfer"])
def test_plots_write_png(storm, tmp_path, plot):
    """Every plot function renders the port's CPU results to a non-empty
    PNG (headless Agg)."""
    pytest.importorskip("matplotlib")
    from small_fem_solver_tpu_torch.utils import plotting
    tm, tw, tc, tres, tscan = storm["port"]
    path = tmp_path / f"{plot}.png"
    if plot == "structure":
        plotting.plot_structure(tm, path)
    elif plot == "utilization":
        plotting.plot_utilization(tm, tres, path, wave_dir=38.0,
                                  current_dir=38.0)
    elif plot == "phase_scan":
        plotting.plot_phase_scan(tscan, path)
    elif plot == "mode":
        modal = pt.modal_analysis(tm, n_modes=1, topside_mass_t=1100.0)
        plotting.plot_mode(tm, modal.mode_shapes[0], str(path))
    elif plot == "pushover":
        res = pt.pushover(tm, tw, tc, lambda_max=14.0, n_lambda=6,
                          n_iter=30)
        plotting.plot_pushover(res, str(path))
    else:
        m = pt.default_3leg_jacket(device="cpu")
        refined = pt.refine_model(m, 2)
        prep = pt.prepare_condensed(m, refined, 2)
        sea = pt.make_random_sea(6.0, 9.0, 50.0, n_components=12, seed=1,
                                 device="cpu")
        tr = pt.spectral_transfer_prepared(prep, sea, tc)
        plotting.plot_transfer(tr, sea, path,
                               member_names=refined.member_names)
    assert path.stat().st_size > 10_000
