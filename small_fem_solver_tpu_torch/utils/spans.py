"""Layer spans of the port, on the clock of a ``torch.profiler`` trace.

The analysis entry points open one span at each layer boundary they cross
(the names below).  A span is a ``torch.profiler.record_function`` while a
profiler session is running and one shared null context otherwise, so the
port has nothing to switch on: a span is recorded exactly when a profiler
runs, and costs one flag check when none does.  Kineto keeps the spans in
memory with the profiler's other events, on the clock of the device's
records, so each stretch in which the card waits can be put down to the
innermost span the host was in (``jacketbench/spans.py`` does that).

To look at them, profile a call and export a Chrome trace (open it in
``chrome://tracing`` or Perfetto)::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pt.design_envelope(model, waves, cases)
    prof.export_chrome_trace("design_envelope.json")

Spans nest by time on the calling thread; a layer's self time is its span
less the child spans inside it.  Open spans only at layer boundaries,
never inside a kernel wrapper, a per-phase loop or a vmapped function
body: ``@spanned(NAME)`` round a function whose whole body is one layer,
``with span(NAME):`` round a part of a body.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.autograd.profiler as _autograd_profiler

ENTRY = "fem.entry"              # the public entry points' bodies
PREPARE = "fem.prepare"          # the per-call factorization set-up
LOADS = "fem.loads"              # wave loads, in the chain layout if any
CONDENSE = "fem.condense"        # chain sweeps, interface solves, refinement
DENSE_SOLVE = "fem.dense_solve"  # the dense tier's triangular solves
RECOVER = "fem.recover"          # end forces, von Mises, utilization,
                                 # reactions and envelope reductions
HOST_COPY = "fem.host_copy"      # results brought to the host

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a span of the running profiler
    session, or the shared null context when no session runs."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorator: the whole call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
