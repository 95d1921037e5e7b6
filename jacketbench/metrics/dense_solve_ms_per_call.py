"""Device time a call of the dense factor and triangular solves (cuSOLVER
and cuBLAS kernels whose names hold one of NAMES).  The refinement round's
residual product is a general matrix product, named like the recovery's,
and is not counted."""
import re

LAYER = "Dense solve (ops/solve.py)"
UNIT = "ms/call"
SOURCE = "device_trace"
MOVES = "case_phases_per_s"
NAMES = ("potrf", "potrs", "trsm", "trsv", "getrf", "getrs", "syrk",
         "herk")
KERNEL = re.compile("|".join(NAMES), re.IGNORECASE)


def read(trace):
    t = trace.device_s(KERNEL.search)
    if not trace.n_calls or not t:
        return None
    return 1e3 * t / trace.n_calls
