"""Bounds of the phase-batch Morison kernel's (K1's) work: for C cases,
S phases, M members of Q Gauss points and N wave modes, the mode sums
(F fields, 4 FLOP a mode and field for the cosine and sine halves) and an
epilogue of EPILOGUE_FLOP a (phase, point): normal projection, drag,
inertia, lever-rule sums; outputs (end forces, totals) written once, inputs
(phases, wave modes, per-case member coefficients, nodes) read once."""
from .peaks import (FP32_FLOP_PER_S, FP64_FLOP_PER_S, FP64_TC_FLOP_PER_S,
                    HBM_BYTES_PER_S, bound_us)

EPILOGUE_FLOP = 60


def k1_f32_bound(S: int, M: int, Q: int, N: int, n_nodes: int):
    """(bound us, by, bytes, FLOPs) of one case in float32 (the scans'
    instance): 5 fields, all at the FP32 rate."""
    nbytes = 4 * (2 * S * M * 3 + S * 6 + S + 2 * N + 4 + n_nodes * 3
                  + M) + 8 * 2 * M
    flops = S * M * Q * (2 * 2 * N * 5 + EPILOGUE_FLOP)
    return (*bound_us(nbytes, flops), nbytes, flops)


def k1_f32_batch_bound(C: int, S: int, M: int, Q: int, N: int,
                       n_nodes: int):
    """(bound us, by, bytes, FLOPs) of C cases in float32: the FLOPs, the
    outputs and the per-case inputs C times, nodes and members once."""
    nbytes = 4 * (C * (2 * S * M * 3 + S * 6 + S + 2 * N + 4 + 3 * M)
                  + n_nodes * 3) + 8 * 2 * M
    flops = C * S * M * Q * (2 * 2 * N * 5 + EPILOGUE_FLOP)
    return (*bound_us(nbytes, flops), nbytes, flops)


def harm64_bound(S: int, M: int, Q: int, N: int, n_nodes: int, C: int = 1,
                 wheeler: bool = False) -> dict:
    """C cases in float64: the mode sums on the FP64 tensor cores (4F FLOP
    a case, phase, point and mode; F = 5, 13 with Wheeler) plus the
    epilogue at the FP64 rate outside them, against the bytes."""
    F = 13 if wheeler else 5
    sums = C * S * M * Q * N * 4 * F
    epi = C * S * M * Q * EPILOGUE_FLOP
    nbytes = (8 * (C * (2 * S * M * 3 + S * 6 + S + 2 * N + 4 + 3 * M)
                   + n_nodes * 3) + 8 * 2 * M)
    t_ops = sums / FP64_TC_FLOP_PER_S + epi / FP64_FLOP_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return dict(us=max(t_ops, t_bytes) * 1e6,
                by="bytes" if t_bytes >= t_ops else "operations",
                sums_gflop=sums / 1e9, epilogue_gflop=epi / 1e9,
                mb=nbytes / 1e6)


def work_us(shape: dict) -> float:
    """The bound of one K1 work item {dtype, C, S, M, Q, N, n_nodes},
    whichever kernel computes it."""
    s = dict(shape)
    dtype, C = s.pop("dtype"), s.pop("C")
    if dtype == "float64":
        return harm64_bound(C=C, **s)["us"]
    if C == 1:
        return k1_f32_bound(**s)[0]
    return k1_f32_batch_bound(C, **s)[0]
