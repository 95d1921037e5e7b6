"""The card's idle ms a call while ``fem.loads`` is the innermost open span of
the port (the wave loads: ``api._scan_loads`` (either kinematics, with the
chain layout of the loads) and ``design_envelope``'s load block);
``jacketbench/spans.py`` puts the idle time down to the spans."""
from ..spans import idle_ms_per_call

LAYER = "Loads (phase-batch and pointwise)"
UNIT = "ms/call"
SOURCE = "program_span"
MOVES = "case_phases_per_s"
SPAN = "fem.loads"


def read(trace):
    return idle_ms_per_call(trace, SPAN)
