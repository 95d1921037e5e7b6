"""The port's default device.

Every public constructor (models, sections, waves, wave batches, the
converters) takes ``device=None`` and resolves it here when it is called,
never when a module is imported: ``None`` means the current CUDA device.
Without a card that raises instead of landing on the CPU silently; CPU runs
say so with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the current CUDA
    device, and raises ``RuntimeError`` when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "small_fem_solver_tpu_torch runs on the CUDA card by default and "
            "found none; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
