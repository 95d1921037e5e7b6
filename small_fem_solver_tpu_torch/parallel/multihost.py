"""Multi-process design sweeps on ``torch.distributed`` (PyTorch
counterpart of ``small_fem_solver_tpu/parallel/multihost.py``).

The JAX package runs one controller per host and shards the case axis over
the global device set.  Here every rank is a process with one device (a
card, or the CPU), launched by ``torchrun`` or :func:`spawn_ranks`, and
the case axis is split into contiguous rank blocks
(:func:`process_local_slice`).  Each rank builds the waves of its own
block only (the Fenton collocations are the host-side per-case work),
:func:`shard_cases_from_local` all-gathers the small wave and case blocks
into the global batch, and the envelope runs with ``mesh=`` the global
1-D :class:`~torch.distributed.device_mesh.DeviceMesh`
(:func:`global_case_mesh`): each rank solves its block and the blocks are
joined by the collectives of :mod:`.comm`.

:func:`init_multihost` stands in for ``jax.distributed.initialize``: with
no arguments and no ``WORLD_SIZE`` above 1 in the environment it does
nothing and returns False, so a script may call it unconditionally;
without a process group every function here runs on the one process,
unsharded.  :func:`spawn_ranks` is the local launcher the single JAX
controller does not need: it starts the ranks of one group on this host
(``spawn`` start method, a ``FileStore`` in a temporary directory) and
returns their results.
"""
from __future__ import annotations

import dataclasses
import os
import pathlib
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from . import comm


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None,
                   rank: int | None = None) -> bool:
    """Initialise the default process group for a multi-process run.

    Returns False, and does nothing, when there is nothing to join: no
    ``init_method``, ``world_size`` unset or 1, and no ``WORLD_SIZE`` above
    1 in the environment.  Otherwise calls ``init_process_group``
    (``init_method`` defaults to ``env://``, torchrun's environment) and
    returns True.  The backend is NCCL when CUDA is available (each rank
    on card ``LOCAL_RANK``), gloo on the CPU."""
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if (init_method is None and world_size in (None, 0, 1)
            and env_world <= 1):
        return False
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    kw = {} if world_size is None else {"world_size": world_size}
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kw)
    return True


def global_case_mesh(axis: str = "cases", device=None):
    """1-D mesh over every rank of the default group (``None`` when no
    process group is initialised: one process, unsharded).  ``device``:
    the mesh's device type, 'cuda' for an NCCL group, else 'cpu'."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(str(device), (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _rank_size() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_local_slice(n_cases: int) -> slice:
    """The contiguous case range this rank owns (block layout: ceiling
    division, the last blocks shorter)."""
    lo, hi = comm.block_range(n_cases, *_rank_size())
    return slice(lo, hi)


def shard_cases_from_local(local, n_cases: int, mesh, axis: str = "cases"):
    """The global case batch from each rank's local block (built with
    :func:`process_local_slice`): every tensor field with a case axis of
    the wave or case dataclass ``local`` is all-gathered in rank order.
    Without a mesh (one process) the local block is the batch."""
    if mesh is None:
        return local
    W = comm.mesh_info(mesh)[2]
    sizes = [hi - lo for lo, hi in (comm.block_range(n_cases, r, W)
                                    for r in range(W))]
    return dataclasses.replace(local, **{
        f.name: comm.all_gather_cat(getattr(local, f.name), mesh, sizes)
        for f in dataclasses.fields(local)
        if torch.is_tensor(getattr(local, f.name))
        and getattr(local, f.name).ndim > 0})


def _local_batches(H_list, T, d, U_c, base_case, wave_model, N, n_modes,
                   dtype, device):
    """(the global wave batch, case batch and mesh): each rank builds its
    own block of cases, all-gathered into the batch."""
    from .sweep import make_case_batch, make_wave_batch

    H = np.asarray(H_list, dtype=np.float64)
    n_cases = H.shape[0]
    sl = process_local_slice(n_cases)
    waves = make_wave_batch(H[sl], T, d, U_c=U_c, model=wave_model, N=N,
                            n_modes=n_modes, dtype=dtype, device=device)
    cases = make_case_batch(base_case,
                            t_analysis=np.zeros(sl.stop - sl.start))
    mesh = global_case_mesh()
    return (shard_cases_from_local(waves, n_cases, mesh),
            shard_cases_from_local(cases, n_cases, mesh), mesh)


def multihost_design_envelope(model, H_list, T, d, U_c, base_case,
                              wave_model: str = "fenton", N: int = 18,
                              n_modes: int = 18, n_steps: int = 36,
                              dtype: torch.dtype | None = None,
                              **envelope_kw):
    """Storm envelope over the (H) cases, sharded across the ranks: each
    rank builds the waves of its own case block, the blocks are gathered
    into the global batch, and :func:`..api.design_envelope` runs with the
    global mesh (unsharded on one process)."""
    from ..api import design_envelope

    waves, cases, mesh = _local_batches(
        H_list, T, d, U_c, base_case, wave_model, N, n_modes,
        dtype or torch.float32, model.device)
    return design_envelope(model, waves, cases, n_steps=n_steps, mesh=mesh,
                           **envelope_kw)


def multihost_design_envelope_condensed(coarse, refined, n_seg, H_list, T,
                                        d, U_c, base_case,
                                        wave_model: str = "fenton",
                                        N: int = 18, n_modes: int = 18,
                                        n_steps: int = 36,
                                        dtype: torch.dtype | None = None,
                                        solve_dtype: torch.dtype | None = None,
                                        **envelope_kw):
    """The refined mesh's condensed storm envelope
    (:func:`..api.design_envelope_condensed`) with the case axis sharded
    across the ranks, wave set-up per rank as in
    :func:`multihost_design_envelope`: every rank factors the
    case-independent chains itself, and only the wave and case blocks and
    the envelope's reductions cross ranks."""
    from ..api import design_envelope_condensed

    waves, cases, mesh = _local_batches(
        H_list, T, d, U_c, base_case, wave_model, N, n_modes,
        dtype or torch.float32, refined.device)
    return design_envelope_condensed(coarse, refined, n_seg, waves, cases,
                                     n_steps=n_steps,
                                     solve_dtype=solve_dtype or torch.float32,
                                     mesh=mesh, **envelope_kw)


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankMesh:
    """Stand-in for ``mesh=`` in a :func:`spawn_ranks` call: each rank
    replaces it with the 1-D DeviceMesh of its group, axis ``axis``."""

    axis: str = "cases"


@dataclasses.dataclass(frozen=True)
class PerRank:
    """Stand-in for an argument of a :func:`spawn_ranks` call that differs
    between the ranks: rank r gets ``values[r]``."""

    values: tuple


def to_device(obj, device):
    """``obj`` with every tensor moved to ``device``: tensors, NamedTuples,
    dataclasses, tuples, lists and dicts are walked; anything else is
    returned as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type) \
            and not isinstance(obj, (RankMesh, PerRank)):
        return dataclasses.replace(obj, **{
            f.name: to_device(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def _for_rank(obj, rank: int, device, meshes: dict, mesh_device: str,
              world_size: int):
    """A top-level argument as the rank takes it: a :class:`PerRank` its
    entry, a :class:`RankMesh` the rank's DeviceMesh of that axis, tensors
    on the rank's device."""
    if isinstance(obj, PerRank):
        obj = obj.values[rank]
    if not isinstance(obj, RankMesh):
        return to_device(obj, device)
    if obj.axis not in meshes:
        from torch.distributed.device_mesh import init_device_mesh
        meshes[obj.axis] = init_device_mesh(mesh_device, (world_size,),
                                            mesh_dim_names=(obj.axis,))
    return meshes[obj.axis]


def _rank_main(rank: int, world_size: int, backend: str, device: str,
               calls, tmp: str, return_exceptions: bool) -> None:
    """One rank of :func:`spawn_ranks`: join the group, run the calls,
    write the results (on the CPU) to ``tmp``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world_size))
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            world_size=world_size, rank=rank)
    mesh_device = "cuda" if backend == "nccl" else "cpu"
    meshes, results = {}, []
    try:
        for fn, args, kwargs in calls:
            args = [_for_rank(a, rank, dev, meshes, mesh_device, world_size)
                    for a in args]
            kwargs = {k: _for_rank(v, rank, dev, meshes, mesh_device,
                                   world_size)
                      for k, v in kwargs.items()}
            try:
                res = fn(*args, **kwargs)
            except Exception as e:      # noqa: BLE001 - handed back
                if not return_exceptions:
                    raise
                res = e
            results.append(to_device(res, "cpu"))
    finally:
        dist.destroy_process_group()
    torch.save(results, pathlib.Path(tmp) / f"rank{rank}.pt")


def spawn_ranks(world_size: int, calls, backend: str | None = None,
                device=None, timeout: float = 900.0,
                return_exceptions: bool = False) -> list:
    """Run ``calls`` in ``world_size`` new processes that form one process
    group, and return every rank's results: ``out[rank][i]`` is call
    ``i``'s return value on that rank, its tensors on the CPU.

    ``calls``: a list of ``(callable, args, kwargs)``, run in order by
    every rank.  The callables must be importable top-level functions (the
    ranks are started with the ``spawn`` method and unpickle them); tensors
    in the arguments are moved to the rank's device, a :class:`RankMesh`
    argument becomes the rank's 1-D DeviceMesh and a :class:`PerRank` one
    the rank's own value.
    ``device``: the ranks' device type, ``None`` (the default) the card
    (rank r on card r modulo the cards; raises without one), ``"cpu"`` for
    CPU ranks.  ``backend``: default NCCL when every rank has a card of
    its own, else gloo (NCCL refuses two ranks on one card; gloo stages
    CUDA tensors through the host, :mod:`.comm`).  With
    ``return_exceptions`` an exception a call raises is returned in its
    place (the ranks must agree on it, or the next collective waits on the
    ones that did not raise); otherwise the first failing rank ends the
    launch, the others are killed and its traceback is raised
    (``torch.multiprocessing.ProcessRaisedException``).  The ranks are
    killed after ``timeout`` seconds."""
    from torch.multiprocessing import start_processes

    from ..device import resolve_device

    device = str(resolve_device(device))
    if backend is None:
        backend = ("nccl" if device.startswith("cuda")
                   and torch.cuda.device_count() >= world_size else "gloo")
    with tempfile.TemporaryDirectory(prefix="spawn_ranks_") as tmp:
        ctx = start_processes(
            _rank_main, args=(world_size, backend, device, calls, tmp,
                              return_exceptions),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(max(deadline - time.monotonic(), 0.0)):
                if time.monotonic() >= deadline:
                    raise RuntimeError(f"spawn_ranks: the ranks did not "
                                       f"finish within {timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(pathlib.Path(tmp, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
