"""The share of the traced window in which no kernel, copy or set ran on
the card (the union of the profiler's device operations' intervals)."""
LAYER = "Device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "case_phases_per_s"


def read(trace):
    if not trace.names:
        raise RuntimeError("the traced window holds no device operation")
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
