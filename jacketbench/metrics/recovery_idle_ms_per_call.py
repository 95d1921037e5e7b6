"""The card's idle ms a call while ``fem.recover`` is the innermost open span
of the port (the recovery: end forces, von Mises, utilization, reactions
and the envelope reductions); ``jacketbench/spans.py`` puts the idle time
down to the spans."""
from ..spans import idle_ms_per_call

LAYER = "Recovery (api.py, ops/sections.py)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.recover"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
