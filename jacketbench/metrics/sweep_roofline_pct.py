"""The chain sweep's share of its bound: the sum of ``bounds/sweep.py``'s
bound over every sweep launch in the window, with its right-hand sides,
levels and chains (recorded round the program's sweep wrapper), over the
device time of the kernels named ``chain_sweep...``."""
import contextlib
import re

from ..bounds.sweep import sweep_bound

LAYER = "Chain layout + condensation (ops/condense.py, csrc/chain_sweep.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "case_phases_per_s"
KERNEL = re.compile(r"chain_sweep\w*kernel")


@contextlib.contextmanager
def instrument(records: list):
    """Record (itemsize, B, n_int, C) of every chain sweep launched."""
    from small_fem_solver_tpu_torch.ops import condense, hopper_kernels as hk
    inner = condense.chain_sweep_cuda

    def recording(fac, g, split=False):
        n_int, C = fac.Cprime.shape[:2]
        B = hk.sweep_operand(g, split)[1]
        records.append((g.element_size(), int(B), int(n_int), int(C)))
        return inner(fac, g, split)
    condense.chain_sweep_cuda = recording
    try:
        yield
    finally:
        condense.chain_sweep_cuda = inner


def read(trace):
    launches = trace.records.get("sweep_roofline_pct", [])
    bound = sum(sweep_bound(*x)[0] for x in launches)
    t = trace.device_s(KERNEL.search)
    if not bound or not t:
        return None
    return 100.0 * bound * 1e-6 / t
