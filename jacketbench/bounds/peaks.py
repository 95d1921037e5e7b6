"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit; a card set below it runs slower, so
every share is stated with the card's power limit beside it)."""

HBM_BYTES_PER_S = 3.35e12   # device memory
FP32_FLOP_PER_S = 67e12     # FP32 outside the tensor cores
FP64_FLOP_PER_S = 34e12     # FP64 outside the tensor cores
FP64_TC_FLOP_PER_S = 67e12  # FP64 on the tensor cores (DMMA)


def bound_us(nbytes: float, flops: float, flop_rate: float = FP32_FLOP_PER_S):
    """(bound in us, what bounds it): the larger of the bytes over the
    device-memory rate and the FLOPs over the given rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return (max(t_bytes, t_ops) * 1e6,
            "bytes" if t_bytes >= t_ops else "operations")
