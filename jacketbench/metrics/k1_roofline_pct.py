"""K1's share of its bound: the bound of the Morison loads' work of every
call in the window (``bounds/k1.py``, from the calls' shapes, whatever
kernels compute it) over the device time of the kernels named
``morison_...``."""
import re

from ..bounds.k1 import work_us

LAYER = "Phase-batch loads (ops/hopper_kernels.py, csrc/morison_phase_batch.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "case_phases_per_s"
KERNEL = re.compile(r"morison_\w*kernel")


def read(trace):
    bound = sum(work_us(w) for c in trace.calls
                for w in c["work"].get("k1", ()))
    t = trace.device_s(KERNEL.search)
    if not bound or not t:
        return None
    return 100.0 * bound * 1e-6 / t
