"""Bound of one chain sweep (the condensation kernel): for B right-hand
sides, n_int interior levels and C chains, the factors Dinv, DinvL,
Cprime and B0, Cn read once, the loads read and the solution written once,
the interface forces fI, fJ written once; 36 multiply-adds a 6x6 block
product, 3 a level and right-hand side plus the 2 interface products."""
from .peaks import FP32_FLOP_PER_S, FP64_FLOP_PER_S, bound_us


def sweep_bound(itemsize: int, B: int, n_int: int, C: int):
    """(bound us, by, bytes)."""
    nbytes = itemsize * (2 * B * n_int * C * 6 + 2 * B * C * 6
                         + 3 * n_int * C * 36 + 2 * C * 36)
    flops = 2 * B * C * (3 * n_int + 2) * 36
    return (*bound_us(nbytes, flops, FP32_FLOP_PER_S if itemsize == 4
                      else FP64_FLOP_PER_S), nbytes)
