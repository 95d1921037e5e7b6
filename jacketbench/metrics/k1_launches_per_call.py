"""Launches of the phase-batch Morison kernel (K1, every instance) a call:
the program's own counter (``ops.hopper_kernels.launch_counts``), read and
reset round each call."""
LAYER = "Phase-batch loads (ops/hopper_kernels.py, csrc/morison_phase_batch.cu)"
UNIT = "launches/call"
SOURCE = "program_counter"
MOVES = "case_phases_per_s"


def read(trace):
    if not trace.n_calls:
        return None
    return sum(c["counters"].get("k1", 0) for c in trace.calls) / trace.n_calls
