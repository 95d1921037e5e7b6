"""Distributed preconditioned CG over a row-sharded BCSR stiffness (PyTorch
counterpart of ``small_fem_solver_tpu/parallel/pcg_dist.py``).

The global K's 6x6 node-block rows are partitioned into contiguous slabs
over a 1-D mesh (axis ``"dof"``): every rank holds its slab of the BCSR
blocks and its slice of the solution and right-hand side, and runs the
same CG iteration as the others; the collectives of :mod:`.comm` join
them:

- mat-vec: ``all_gather`` of the (small) solution vector, the slab's
  gathered 6x6 block products and their fixed-order row sums
  (:func:`..ops.assembly.segment_table`): no scatter across ranks;
- dot products and norms: a local partial, summed over the ranks in rank
  order (:func:`.comm.ordered_sum`);
- preconditioner: block-Jacobi on the slab's diagonal blocks (no
  communication); the two-level correction restricts the slab's residual
  through its prolongator rows, sums the tiny [6 n_agg] coarse residual
  over the ranks, applies the replicated coarse inverse and prolongs
  locally.

Dirichlet BCs by projection (fixed DOFs pinned to identity rows), as on
one device (``ops/solve.py``).  Nodes are padded to a multiple of the
mesh size; padded rows are pinned like fixed ones.  The CG loop is the
one-device loop of ``ops/solve.py`` (the JAX package's stop test
``sqrt(r.r) / ||b|| > tol`` kept on the device as a running flag, read
by the host once every ``check_every`` iterations) given this module's
operator, preconditioner and dot-product reduction.  An iteration makes
four collectives (three with block-Jacobi): the mat-vec's gather,
``p.Ap``, the coarse residual, and ``r.z`` with ``r.r`` in one sum.
Every rank returns the same bits.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.assembly import BCSRMatrix, segment_sum_ordered, segment_table
from ..ops.solve import (PCG_CHECK_EVERY, block_jacobi_inverse,
                         dof_free_mask, pcg)
from . import comm


class ShardedBCSR(NamedTuple):
    """Row-partitioned BCSR data, leading axis = rank."""

    blocks: torch.Tensor       # [D, Bmax, 6, 6] (padding blocks zero)
    cols: torch.Tensor         # [D, Bmax] global block-column ids
    local_rows: torch.Tensor   # [D, Bmax] row id within the rank's slab
    diag: torch.Tensor         # [D, rows_per_dev, 6, 6] diagonal blocks
    rows_per_dev: int
    n_nodes_padded: int
    counts: tuple = ()         # real blocks of each slab (the rest pads)


def shard_bcsr(A: BCSRMatrix, n_devices: int) -> ShardedBCSR:
    """Partition a BCSR matrix's block rows into ``n_devices`` equal
    slabs (the node count padded up to a multiple of ``n_devices``)."""
    br = A.pattern.block_rows.cpu().numpy()
    bc = A.pattern.block_cols.cpu().numpy()
    blocks = A.blocks
    n = A.pattern.n_nodes
    rows_per_dev = -(-n // n_devices)
    dev_of = br // rows_per_dev
    counts = np.bincount(dev_of, minlength=n_devices)
    Bmax = max(int(counts.max(initial=0)), 1)

    blocks_p = blocks.new_zeros(n_devices, Bmax, 6, 6)
    cols_p = np.zeros((n_devices, Bmax), np.int64)
    lrows_p = np.zeros((n_devices, Bmax), np.int64)
    diag = blocks.new_zeros(n_devices, rows_per_dev, 6, 6)
    for d in range(n_devices):
        sel = np.nonzero(dev_of == d)[0]
        k = sel.size
        blocks_p[d, :k] = blocks[torch.as_tensor(sel, device=blocks.device)]
        cols_p[d, :k] = bc[sel]
        lrows_p[d, :k] = br[sel] - d * rows_per_dev
        on = sel[br[sel] == bc[sel]]
        diag[d, torch.as_tensor(br[on] - d * rows_per_dev,
                                device=blocks.device)] = blocks[
            torch.as_tensor(on, device=blocks.device)]

    def t(a):
        return torch.as_tensor(a, device=blocks.device)
    return ShardedBCSR(blocks=blocks_p, cols=t(cols_p), local_rows=t(lrows_p),
                       diag=diag, rows_per_dev=rows_per_dev,
                       n_nodes_padded=rows_per_dev * n_devices,
                       counts=tuple(int(c) for c in counts))


def _pad_rows(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``x`` [n, ...] zero-padded to [n_rows, ...]."""
    return torch.cat([x, x.new_zeros(n_rows - x.shape[0], *x.shape[1:])])


def distributed_pcg(A: BCSRMatrix, b, fixed_mask, mesh, axis: str = "dof",
                    tol: float = 1e-10, maxiter: int = 1000, coarse=None,
                    check_every: int = PCG_CHECK_EVERY):
    """Solve K u = b (fixed DOFs pinned to zero) across the ranks of the
    1-D ``mesh``; every rank passes the same ``A``, ``b`` and
    ``fixed_mask`` and gets the same result.

    ``coarse`` (an ``ops.coarse.CoarseSpace``) adds the smoothed
    rigid-body-aggregate correction to the block-Jacobi preconditioner:
    one ordered sum of the [6 n_agg] coarse residual an iteration.
    ``axis``: the mesh's axis the rows are sharded over, as in the JAX
    package; a named mesh without it raises ``ValueError``.  The CG loop
    is ``ops/solve.py``'s (:func:`..ops.solve.pcg`) with this module's
    operator, preconditioner and rank-ordered dot products.  Returns
    (u [n_dof], n_iter, rel_residual), the last two 0-d tensors on the
    device."""
    _, rank, W = comm.mesh_info(mesh)
    if mesh.mesh_dim_names and axis not in mesh.mesh_dim_names:
        raise ValueError(f"distributed_pcg shards over the mesh axis "
                         f"{axis!r}; the mesh has {mesh.mesh_dim_names}")
    S = shard_bcsr(A, W)
    n, R = A.pattern.n_nodes, S.rows_per_dev
    n_pad, dev, dtype = S.n_nodes_padded, A.blocks.device, A.blocks.dtype
    lo, hi = 6 * rank * R, 6 * (rank + 1) * R

    cnt = S.counts[rank]
    blocks, cols = S.blocks[rank, :cnt], S.cols[rank, :cnt]
    rows = segment_table(S.local_rows[rank, :cnt].cpu().numpy(), R, dev)
    free = _pad_rows(dof_free_mask(fixed_mask.to(dev)).to(dtype), 6 * n_pad)
    fm = free[lo:hi]
    b_loc = _pad_rows(torch.as_tensor(b, dtype=dtype, device=dev),
                      6 * n_pad)[lo:hi] * fm
    Dinv = block_jacobi_inverse(S.diag[rank], fm)
    if coarse is not None:
        n_agg = coarse.n_agg
        pc = _pad_rows(coarse.p_cols, n_pad)[rank * R:(rank + 1) * R]
        prow = _pad_rows(coarse.p_rows.to(dtype), n_pad)[
            rank * R:(rank + 1) * R]
        # pad slots carry zero blocks: their sums add exact zeros
        csum = segment_table(pc.reshape(-1).cpu().numpy(), n_agg, dev)
        Acinv, cscale = coarse.Ac_inv.to(dtype), coarse.scale.to(dtype)
    sizes = [6 * R] * W

    def op(x):
        xf = comm.all_gather_cat(fm * x, mesh, sizes).reshape(n_pad, 6, 1)
        y = segment_sum_ordered(blocks @ xf[cols], rows).reshape(-1)
        return fm * y + (1.0 - fm) * x

    def precond(r):
        rb = r.reshape(R, 6, 1)
        z = (Dinv @ rb).reshape(-1)
        if coarse is None:
            return z
        c = (prow.mT @ rb).reshape(-1, 6)                  # [R K, 6]
        rc = comm.ordered_sum(segment_sum_ordered(c, csum).reshape(-1), mesh)
        y = (cscale * (Acinv @ (cscale * rc))).reshape(n_agg, 6)
        return z + (prow @ y[pc].reshape(R, -1, 1)).reshape(-1)

    def dots(*pairs):
        return comm.ordered_sum(torch.stack([torch.dot(a, c)
                                             for a, c in pairs]),
                                mesh).unbind()

    res = pcg(op, b_loc, precond=precond, tol=tol, maxiter=maxiter,
              check_every=check_every, dots=dots)
    return (comm.all_gather_cat(res.x, mesh, sizes)[:6 * n], res.n_iter,
            res.residual)
