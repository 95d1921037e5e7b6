"""The card's idle ms a call while ``fem.entry`` is the innermost open span of
the port (the public entry points' own host work outside every inner span:
argument checks, the case batch, the host syncs they make);
``jacketbench/spans.py`` puts the idle time down to the spans."""
from ..spans import idle_ms_per_call

LAYER = "Entry points (api.py)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.entry"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
