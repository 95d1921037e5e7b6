"""The card's idle time put down to the port's layer spans.

The port opens ``fem.*`` spans at its layer boundaries
(``small_fem_solver_tpu_torch/utils/spans.py``); the traced run's profiler
keeps them among the host operations (``Trace.host_names``, ``host_start``,
``host_end``), on the clock of the device records.  Spans nest by time on
the one host thread that makes the calls, so every instant inside a span
has one innermost open ``fem.*`` span.  The idle time of the card in the
window (the complement of ``Trace.busy_intervals``) that falls inside a
span and outside its child spans is put down to that span's name.

``idle_ns`` sweeps a trace once and keeps the result in the trace's
``records`` (under ``RECORD``), so the metrics that read it share one
sweep.  A trace with no ``fem.*`` span
(a port that opens none) gives an empty mapping, and each metric reads
``None``.
"""
from __future__ import annotations

import numpy as np

PREFIX = "fem."
RECORD = "fem_idle_ns"           # the sweep, kept in ``Trace.records``


def busy_before(intervals: np.ndarray):
    """``f(t)``: the card's busy ns before each ``t``, over the disjoint,
    sorted busy intervals [k, 2] (ns)."""
    starts, ends = intervals[:, 0], intervals[:, 1]
    cum = np.concatenate([[0], np.cumsum(ends - starts)])

    def f(t):
        t = np.asarray(t, np.int64)
        if not starts.size:
            return np.zeros_like(t)
        k = np.maximum(np.searchsorted(starts, t, side="right") - 1, 0)
        return cum[k] + np.clip(t - starts[k], 0, ends[k] - starts[k])
    return f


def idle_between(busy, a, b) -> np.ndarray:
    """The card's idle ns in each interval [a, b] (``busy``: ``busy_before``
    of the window's busy intervals)."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return (b - a) - (busy(b) - busy(a))


def idle_ns(trace) -> dict:
    """Per span name, the card's idle ns while that span was the innermost
    open ``fem.*`` span, summed over the window."""
    if RECORD in trace.records:
        return trace.records[RECORD]
    keep = [j for j, n in enumerate(trace.host_names) if n.startswith(PREFIX)]
    out: dict = {}
    if keep:
        s, e = trace.host_start[keep], trace.host_end[keep]
        idle = idle_between(busy_before(trace.busy_intervals()), s, e)
        own = idle.copy()
        stack: list = []
        for j in np.lexsort((-e, s)):       # by start, an enclosing span first
            while stack and e[stack[-1]] <= s[j]:
                stack.pop()
            if stack:                       # the child's idle is not its
                own[stack[-1]] -= idle[j]   # parent's own
            stack.append(j)
        for j, v in zip(keep, own):
            name = trace.host_names[j]
            out[name] = out.get(name, 0) + int(v)
    trace.records[RECORD] = out
    return out


def idle_ms_per_call(trace, name: str):
    """Idle ms a call under span ``name``, or None where it never opens."""
    ns = idle_ns(trace).get(name)
    if ns is None or not trace.n_calls:
        return None
    return ns * 1e-6 / trace.n_calls
