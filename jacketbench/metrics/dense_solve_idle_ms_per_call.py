"""The card's idle ms a call while ``fem.dense_solve`` is the innermost open
span of the port (the dense tier's ``solve_factored`` call in
``design_envelope``); ``jacketbench/spans.py`` puts the idle time down to
the spans."""
from ..spans import idle_ms_per_call

LAYER = "Dense solve (ops/solve.py)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.dense_solve"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
