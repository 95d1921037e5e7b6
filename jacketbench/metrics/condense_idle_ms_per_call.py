"""The card's idle ms a call while ``fem.condense`` is the innermost open span
of the port (``api._condensed_solution``: the chain sweeps, the interface
solves and the refinement round); ``jacketbench/spans.py`` puts the idle
time down to the spans."""
from ..spans import idle_ms_per_call

LAYER = "Chain layout + condensation (ops/condense.py, csrc/chain_sweep.cu)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.condense"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
