"""Collectives of the sharded paths: the one place where the port talks to
``torch.distributed``.

A ``mesh=`` argument of the port is a 1-D
:class:`torch.distributed.device_mesh.DeviceMesh`, the counterpart of the
JAX package's 1-D ``jax.sharding.Mesh`` (axis ``"cases"`` or ``"dof"``):
every rank of its group runs the same call on its contiguous block of the
sharded axis (:func:`block_range`), and the collectives below join the
blocks.

- :func:`all_gather_cat` concatenates the ranks' blocks in rank order on
  every rank (uneven blocks are padded to the largest and the padding
  stripped);
- :func:`all_reduce_max` is an element-wise maximum (exact, so its order
  does not matter);
- :func:`ordered_sum` gathers the ranks' partial sums and adds them in
  rank order, so every cross-rank sum is bit-repeatable and the same on
  NCCL and gloo whatever order the backend would reduce in (the partials
  are small: dot products and the coarse residual of the two-level
  preconditioner).

An NCCL group takes device tensors (CPU tensors are moved to the current
CUDA device and back).  A gloo group holding CUDA tensors stages them
through the host on purpose, counting the bytes on ``STATS["host_bytes"]``:
PyTorch documents gloo's CUDA support for ``broadcast`` and ``all_reduce``
only.  ``STATS["collectives"]`` counts the backend calls.  A mesh of any
other kind, or one whose process group is gone, raises; nothing falls back
to an unsharded run.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

STATS = {"collectives": 0, "host_bytes": 0}


def mesh_info(mesh) -> tuple:
    """(process group, rank, size) of a 1-D device mesh; raises
    ``TypeError`` for anything but a :class:`DeviceMesh` and
    ``ValueError`` for a mesh of more dimensions or without an initialised
    process group."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            "mesh= takes a 1-D torch.distributed.device_mesh.DeviceMesh "
            f"(axis 'cases' or 'dof'), got {type(mesh).__name__}")
    if mesh.ndim != 1:
        raise ValueError(f"mesh= must be a 1-D DeviceMesh, got {mesh.ndim} "
                         "dimensions")
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError("mesh= needs an initialised process group "
                         "(torch.distributed.init_process_group, "
                         "parallel.multihost.init_multihost)")
    group = mesh.get_group()
    return group, dist.get_rank(group), dist.get_world_size(group)


def block_range(n: int, rank: int, size: int) -> tuple:
    """The contiguous block [lo, hi) of ``n`` items that ``rank`` of
    ``size`` owns: ceiling-division blocks, the last ones shorter or
    empty."""
    per = -(-n // size)
    return min(rank * per, n), min((rank + 1) * per, n)


def _staged(x: torch.Tensor, group):
    """(tensor the backend takes, device to copy the result back to or
    None)."""
    backend = dist.get_backend(group)
    if backend == "gloo" and x.is_cuda:
        STATS["host_bytes"] += x.numel() * x.element_size()
        return x.cpu(), x.device
    if backend == "nccl" and not x.is_cuda:
        return x.to(torch.device("cuda", torch.cuda.current_device())), \
            x.device
    return x, None


def _back(x: torch.Tensor, device) -> torch.Tensor:
    if device is None:
        return x
    if device.type == "cpu" and x.is_cuda:
        return x.cpu()
    if device.type == "cuda":
        STATS["host_bytes"] += x.numel() * x.element_size()
    return x.to(device)


def all_gather_cat(x: torch.Tensor, mesh, sizes) -> torch.Tensor:
    """The ranks' blocks ``x`` [n_r, ...] concatenated in rank order, on
    every rank; ``sizes`` holds every rank's n_r.  Blocks shorter than
    the largest are zero-padded for the backend and the padding
    stripped."""
    group, _, W = mesh_info(mesh)
    x = x.contiguous()
    sizes = [int(s) for s in sizes]
    n_max = max(sizes)
    xs, back = _staged(x, group)
    if xs.shape[0] < n_max:
        xs = torch.cat([xs, xs.new_zeros(n_max - xs.shape[0],
                                         *xs.shape[1:])])
    if dist.get_backend(group) == "nccl":
        out = xs.new_empty(W * n_max, *xs.shape[1:])
        dist.all_gather_into_tensor(out, xs, group=group)
        parts = out.split(n_max)
    else:
        parts = [torch.empty_like(xs) for _ in range(W)]
        dist.all_gather(parts, xs, group=group)
        out = None
    STATS["collectives"] += 1
    if out is None or min(sizes) < n_max:
        out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    return _back(out, back)


def all_reduce_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """Element-wise maximum of ``x`` over the ranks, on every rank."""
    group, _, _ = mesh_info(mesh)
    xs, back = _staged(x.contiguous().clone(), group)
    dist.all_reduce(xs, op=dist.ReduceOp.MAX, group=group)
    STATS["collectives"] += 1
    return _back(xs, back)


def ordered_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the ranks of their partials ``x`` (any shape), added
    in rank order on every rank: bit-repeatable, and the same on every
    backend."""
    W = mesh_info(mesh)[2]
    parts = all_gather_cat(x.reshape(1, *x.shape), mesh, [1] * W)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def gather_tree(obj, mesh, sizes):
    """:func:`all_gather_cat` of every tensor with a leading (sharded) axis
    in a NamedTuple / tuple / list tree; ``None`` and 0-d entries stay."""
    if obj is None:
        return None
    if isinstance(obj, torch.Tensor):
        return obj if obj.ndim == 0 else all_gather_cat(obj, mesh, sizes)
    if hasattr(obj, "_fields"):
        return type(obj)(*(gather_tree(v, mesh, sizes) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(gather_tree(v, mesh, sizes) for v in obj)
    return obj


def stats(reset: bool = False) -> dict:
    """A copy of :data:`STATS` (backend calls, host-staged bytes) of this
    process; with ``reset`` the counters are set to 0 after the read."""
    out = dict(STATS)
    if reset:
        STATS.update({k: 0 for k in STATS})
    return out
