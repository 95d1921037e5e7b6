"""The card's idle ms a call while ``fem.host_copy`` is the innermost open
span of the port (``utils.io._np``, through which the results come to the
host); ``jacketbench/spans.py`` puts the idle time down to the spans."""
from ..spans import idle_ms_per_call

LAYER = "Entry points (api.py)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.host_copy"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
