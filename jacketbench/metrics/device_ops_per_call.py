"""Device operations (kernels, copies, sets) a call, from the profiler."""
LAYER = "Entry points (api.py)"
UNIT = "ops/call"
SOURCE = "device_trace"
MOVES = "case_phases_per_s"


def read(trace):
    if not trace.n_calls or not trace.names:
        return None
    return len(trace.names) / trace.n_calls
