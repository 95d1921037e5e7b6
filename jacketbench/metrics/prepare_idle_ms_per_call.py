"""The card's idle ms a call while ``fem.prepare`` is the innermost open span
of the port (the per-call factorization set-up: ``api.prepare_condensed``
(every condensed envelope call) and ``api._dense_batch`` (the dense tier's
K assembled and factored)); ``jacketbench/spans.py`` puts the idle time
down to the spans."""
from ..spans import idle_ms_per_call

LAYER = "Entry points (api.py)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.prepare"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
