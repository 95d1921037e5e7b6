"""The port's layer spans (``utils/spans.py``) and the benchmark's
attribution of the card's idle time to them (``jacketbench/spans.py``).

The spans are checked under a CPU-only ``torch.profiler`` session on the
preset jacket at a CPU size (``n_seg`` 2, 2 cases x 4 phases), through the
three entries the benchmark times; with no session running a span must
create no ``RecordFunction`` at all.  The attribution is checked on a
hand-made trace.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import small_fem_solver_tpu_torch as pt
from jacketbench import spans as jspans
from jacketbench.core import load_module
from jacketbench.tracing import Trace
from small_fem_solver_tpu_torch.utils import io, spans

N_SEG, C, S = 2, 2, 4
CASE = pt.LoadCase(F_axial_kN=25100.0, F_shear_kN=2900.0,
                   custom_sw_tonnes=1100.0, sw_mode="custom")
HEADINGS = np.array([0.0, 38.0])


@pytest.fixture(scope="module")
def jacket():
    coarse = pt.default_3leg_jacket(device="cpu")
    refined = pt.refine_model(coarse, N_SEG)
    waves = pt.make_wave_batch([8.0, 11.0], 9.4, 50.0, U_c=1.7, model="airy",
                               n_modes=4, dtype=torch.float64, device="cpu")
    prep = pt.prepare_condensed(coarse, refined, N_SEG)
    return coarse, refined, waves, prep


def _storm_envelope(coarse, refined, waves, prep):
    cases = pt.make_case_batch(CASE, wave_dir_deg=HEADINGS,
                               current_dir_deg=HEADINGS)
    return pt.design_envelope_condensed(coarse, refined, N_SEG, waves, cases,
                                        n_steps=S).member_envelope


def _design_envelope(coarse, refined, waves, prep):
    cases = pt.make_case_batch(CASE, wave_dir_deg=HEADINGS,
                               current_dir_deg=HEADINGS)
    return pt.design_envelope(coarse, waves, cases,
                              n_steps=S).member_envelope


def _slam_scan(coarse, refined, waves, prep):
    case = dataclasses.replace(CASE, wave_dir_deg=38.0, current_dir_deg=38.0,
                               slam_cs=5.15)
    return pt.phase_scan_prepared(prep, waves.case(0), case, S,
                                  kinematics="pointwise").utilization


# entry -> (its fem.* names, their counts a call); make_case_batch opens a
# fem.entry of its own, and the host copy one fem.host_copy after the call
ENTRIES = {
    "storm_envelope": (_storm_envelope, {
        spans.ENTRY: 2, spans.PREPARE: 1, spans.LOADS: C, spans.CONDENSE: C,
        spans.RECOVER: C + 1,            # a case each, and the reductions
        spans.HOST_COPY: 1}),
    "design_envelope": (_design_envelope, {
        spans.ENTRY: 2, spans.PREPARE: 1, spans.LOADS: 1,
        spans.DENSE_SOLVE: 1, spans.RECOVER: 2, spans.HOST_COPY: 1}),
    "slam_scan": (_slam_scan, {
        spans.ENTRY: 1, spans.LOADS: 1, spans.CONDENSE: 1, spans.RECOVER: 1,
        spans.HOST_COPY: 1}),
}


def _fem_events(prof):
    return [e for e in prof.events() if e.name.startswith("fem.")]


def _enclosing(ev, name):
    p = ev.cpu_parent
    while p is not None and p.name != name:
        p = p.cpu_parent
    return p


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_layer_spans_of_each_entry(jacket, entry):
    fn, want = ENTRIES[entry]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        io._np(fn(*jacket))
    evs = _fem_events(prof)
    counts = {}
    for e in evs:
        counts[e.name] = counts.get(e.name, 0) + 1
    assert counts == want
    for e in evs:
        outer = _enclosing(e, spans.ENTRY)
        if e.name == spans.HOST_COPY:
            assert outer is None            # the caller's copy, after it
        elif e.name != spans.ENTRY:
            assert outer is not None, e.name
    if entry == "storm_envelope":           # per case: loads, condense,
        order = [e.name for e in sorted(evs, key=lambda e: e.time_range.start)
                 if e.name in (spans.LOADS, spans.CONDENSE, spans.RECOVER)]
        assert order == [spans.LOADS, spans.CONDENSE, spans.RECOVER] * C + [
            spans.RECOVER]                  # then the envelope's reductions


def test_no_record_function_without_a_profiler(jacket, monkeypatch):
    def refuse(name, args=None):
        raise AssertionError(f"RecordFunction {name!r} with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span(spans.ENTRY) is spans.span(spans.LOADS)
    env = _storm_envelope(*jacket)
    assert io._np(env).shape == (jacket[1].n_members,)


# --- the attribution of idle time to the spans (no profiler) --------------

METRICS = {"entry_idle_ms_per_call": spans.ENTRY,
           "prepare_idle_ms_per_call": spans.PREPARE,
           "loads_idle_ms_per_call": spans.LOADS,
           "condense_idle_ms_per_call": spans.CONDENSE,
           "dense_solve_idle_ms_per_call": spans.DENSE_SOLVE,
           "recovery_idle_ms_per_call": spans.RECOVER,
           "host_copy_idle_ms_per_call": spans.HOST_COPY}


def _trace(host, device, window_ns, n_calls=2):
    def arr(rows, i):
        return np.array([r[i] for r in rows], np.int64)
    return Trace(window_s=window_ns * 1e-9,
                 names=[f"op{i}" for i in range(len(device))],
                 start=arr(device, 0), end=arr(device, 1),
                 host_names=[h[0] for h in host], host_start=arr(host, 1),
                 host_end=arr(host, 2), calls=[{}] * n_calls, records={})


def test_idle_is_put_down_to_the_innermost_span():
    """Window [0, 1000) ns and two calls, with device operations (two of
    them overlapping), nested fem.* spans (one opening with its parent),
    an aten operation and the benchmark's call spans set by hand."""
    device = [(20, 40), (30, 50), (110, 130), (210, 260), (400, 420),
              (520, 540), (560, 600), (700, 705), (980, 1000)]
    host = [("jacketbench.call", 0, 490), ("jacketbench.call", 500, 990),
            ("fem.entry", 10, 470),
            ("fem.prepare", 60, 200), ("aten::mm", 65, 120),
            ("fem.loads", 200, 300), ("fem.condense", 230, 290),
            ("fem.recover", 300, 400),
            ("fem.host_copy", 475, 485),
            ("fem.entry", 510, 800),
            ("fem.loads", 510, 600), ("fem.recover", 600, 700),
            ("fem.host_copy", 900, 950)]
    # busy [20,50) [110,130) [210,260) [400,420) [520,540) [560,600)
    # [700,705) [980,1000): 205 of the window's 1000 ns
    want_ns = {
        spans.ENTRY: 20 + 50 + 95,      # [10,60) [400,470) [700,800)
        spans.PREPARE: 140 - 20,
        spans.LOADS: 10 + 10 + 30,      # [200,230) [290,300) [510,600)
        spans.CONDENSE: 60 - 30,
        spans.RECOVER: 100 + 100,
        spans.HOST_COPY: 10 + 50,
    }
    outside = 10 + 5 + 25 + 100 + 30   # [0,10) [470,475) [485,510)
    #                                    [800,900) [950,1000)
    tr = _trace(host, device, 1000)
    got = {n: load_module("metrics", m).read(tr) for m, n in METRICS.items()}
    for name, ns in want_ns.items():
        assert got[name] == pytest.approx(ns * 1e-6 / 2, abs=1e-15), name
    assert got[spans.DENSE_SOLVE] is None          # never opened
    window_idle_ms = (tr.window_s - tr.busy_s()) * 1e3 / tr.n_calls
    assert sum(v for v in got.values() if v is not None) \
        + outside * 1e-6 / 2 == pytest.approx(window_idle_ms, abs=1e-9)
    assert jspans.idle_ns(tr) is jspans.idle_ns(tr)   # one sweep a trace


def test_no_span_reads_none():
    """A trace of a program that opens no fem.* span (a port without
    them) reads None in every span metric, and raises nothing."""
    tr = _trace([("jacketbench.call", 0, 90), ("aten::mm", 5, 50)],
                [(10, 20)], 100, n_calls=1)
    for m in METRICS:
        assert load_module("metrics", m).read(tr) is None
