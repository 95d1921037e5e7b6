"""Two-level (smoothed rigid-body aggregation) preconditioning for PCG
(PyTorch counterpart of ``small_fem_solver_tpu/ops/coarse.py``).

Block-Jacobi PCG on a slender-frame stiffness needs ~O(chain length)
iterations: smooth global deformations are invisible to a 6x6 nodal
smoother.  The coarse space carries them:

- nodes are partitioned on the host into connected aggregates of ~target
  size (greedy BFS over the member graph, ``native/mesh_kit.cpp`` when
  built; at most ``max_aggregates`` = 192 of them, so the coarse space has
  at most 1,152 DOFs);
- each aggregate carries 6 coarse DOFs, its rigid-body motions about its
  centroid; the tentative prolongator block of node i is
  P_i = [[I, -S(r_i)], [0, I]] with r_i the node's centroid offset in mm;
- one damped-Jacobi pass P = (I - omega D_bj^-1 A) P_tent (omega = 0.5)
  smooths it;
- A_c = P^T A P is factored once and inverted explicitly: the coarse
  solve is then one [6 n_agg]^2 mat-vec an iteration (a triangular solve
  is latency-bound on the card too);
- the preconditioner is the additive D_bj^-1 + P A_c^-1 P^T (SPD).

P is block-sparse: a node's row has K_i <= K nonzero 6x6 blocks, stored
in a padded per-node slot table (``p_cols`` [n, K], ``p_blocks``
[n, K, 6, 6], pad slots zero), so every operation is O(n).  Every
segment sum (the smoothing into slots, P^T r, the Galerkin product)
runs in a fixed order through host-built gather tables
(:func:`.assembly.segment_table`) instead of ``segment_sum``, so on the
card two solves give bit-equal iterates and the same iteration count.
The dense construction (:func:`build_coarse_space_dense`) is a test
oracle only: its P is 0.9 GB at 99,882 DOF.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .assembly import (BCSRMatrix, SegmentTable, bcsr_block_diagonal,
                       bcsr_matvec, segment_sum_ordered, segment_table)
from .solve import block_jacobi_inverse


def aggregate_nodes(conn, n_nodes: int, target_size: int = 32) -> np.ndarray:
    """Aggregate id [n_nodes] (int64) of each node: connected aggregates of
    ~``target_size`` nodes by greedy BFS over the graph of ``conn``
    [E, 2] (host, once per mesh).  The native mesh kit when built, else
    the Python BFS; both give the same ids."""
    from .. import native
    conn = np.asarray(conn)
    out = native.aggregate_nodes_native(conn, n_nodes, target_size)
    if out is not None:
        return out
    src = np.concatenate([conn[:, 0], conn[:, 1]])
    dst = np.concatenate([conn[:, 1], conn[:, 0]])
    order = np.argsort(src, kind="stable")
    dst_s = dst[order]
    ptr = np.searchsorted(src[order], np.arange(n_nodes + 1))
    agg = np.full(n_nodes, -1, dtype=np.int64)
    next_agg = 0
    for seed in range(n_nodes):
        if agg[seed] >= 0:
            continue
        frontier = [seed]
        agg[seed] = next_agg
        count = 1
        while frontier and count < target_size:
            nxt = []
            for u in frontier:
                for v in dst_s[ptr[u]:ptr[u + 1]]:
                    if agg[v] < 0:
                        agg[v] = next_agg
                        nxt.append(v)
                        count += 1
                        if count >= target_size:
                            break
                if count >= target_size:
                    break
            frontier = nxt
        next_agg += 1
    return agg


def aggregates_from_pattern(pattern, target_size: int = 32,
                            max_aggregates: int = 192) -> np.ndarray:
    """Aggregation over the BCSR pattern's node graph (its off-diagonal
    blocks are the adjacency), with ``target_size`` raised as needed to
    keep at most ``max_aggregates`` aggregates (bounding the dense coarse
    operator at [6 * 192]^2)."""
    br = pattern.block_rows.cpu().numpy()
    bc = pattern.block_cols.cpu().numpy()
    off = br != bc
    tsz = max(int(target_size), -(-pattern.n_nodes // max_aggregates))
    return aggregate_nodes(np.stack([br[off], bc[off]], axis=1),
                           pattern.n_nodes, tsz)


@dataclasses.dataclass(frozen=True)
class SparsePPlan:
    """Host-built slot plan of the block-sparse smoothed prolongator, once
    per (pattern, aggregation); tensors on the pattern's device.

    p_cols [n, K]         aggregate of each slot (pad slots: 0)
    valid [n, K]          True on the real slots
    entry_slot [nnzA]     flat slot (node * K + k) each BCSR entry's
                          smoothing contribution lands in
    tent_slot [n]         flat slot of each node's tentative block
    smooth_sum            fixed-order plan: [entries | tentative] -> slots
    restrict_sum          fixed-order plan: real slots -> aggregates
    tri_e / tri_ka / tri_kb [T]  the Galerkin product's (BCSR entry, left
                          slot, right slot) triples with both slots real
    coarse_keys [U]       their distinct coarse blocks (row * n_agg + col)
    galerkin_sum          fixed-order plan: triples -> coarse_keys
    """

    p_cols: torch.Tensor
    valid: torch.Tensor
    entry_slot: torch.Tensor
    tent_slot: torch.Tensor
    smooth_sum: SegmentTable
    restrict_sum: SegmentTable
    tri_e: torch.Tensor
    tri_ka: torch.Tensor
    tri_kb: torch.Tensor
    coarse_keys: torch.Tensor
    galerkin_sum: SegmentTable
    K: int = 1


def plan_sparse_p(pattern, agg, n_agg: int) -> SparsePPlan:
    """Sparsity plan of the one-pass-smoothed prolongator (host numpy).

    BCSR entry (i, j) contributes -omega D_i^-1 A_ij Pb_j to P's block at
    (row i, aggregate agg[j]); the tentative block Pb_i lands at
    (i, agg[i]).  The union of those targets per row is the pattern; the
    slot ids are the JAX package's."""
    dev = pattern.block_rows.device
    br = pattern.block_rows.cpu().numpy()
    bc = pattern.block_cols.cpu().numpy()
    aggn = np.asarray(torch.as_tensor(agg).cpu()).astype(np.int64)
    n = pattern.n_nodes
    keys_e = br * n_agg + aggn[bc]
    keys_t = np.arange(n, dtype=np.int64) * n_agg + aggn
    uniq, inv = np.unique(np.concatenate([keys_e, keys_t]),
                          return_inverse=True)
    rows = uniq // n_agg
    counts = np.bincount(rows, minlength=n)
    K = int(counts.max())
    starts = np.cumsum(counts) - counts
    slot_of_uniq = np.arange(uniq.size) - starts[rows]  # rows are contiguous
    flat = rows * K + slot_of_uniq
    p_cols = np.zeros((n, K), np.int64)
    p_cols[rows, slot_of_uniq] = uniq % n_agg
    valid = np.zeros((n, K), bool)
    valid[rows, slot_of_uniq] = True
    entry_slot, tent_slot = flat[inv[:keys_e.size]], flat[inv[keys_e.size:]]

    # Galerkin triples in the JAX package's (ka, kb, entry) pass order
    tri = [np.nonzero(valid[br, ka] & valid[bc, kb])[0]
           for ka in range(K) for kb in range(K)]
    tri_ka = np.concatenate([np.full(t.size, k // K) for k, t in
                             enumerate(tri)])
    tri_kb = np.concatenate([np.full(t.size, k % K) for k, t in
                             enumerate(tri)])
    tri_e = np.concatenate(tri)
    keys = p_cols[br[tri_e], tri_ka] * n_agg + p_cols[bc[tri_e], tri_kb]
    coarse_keys, key_of = np.unique(keys, return_inverse=True)

    def t(a):
        return torch.as_tensor(a, device=dev)
    return SparsePPlan(
        p_cols=t(p_cols), valid=t(valid), entry_slot=t(entry_slot),
        tent_slot=t(tent_slot),
        smooth_sum=segment_table(np.concatenate([entry_slot, tent_slot]),
                                 n * K, dev),
        restrict_sum=segment_table(np.where(valid, p_cols, -1), n_agg, dev),
        tri_e=t(tri_e), tri_ka=t(tri_ka), tri_kb=t(tri_kb),
        coarse_keys=t(coarse_keys),
        galerkin_sum=segment_table(key_of, coarse_keys.size, dev), K=K)


@dataclasses.dataclass(frozen=True)
class CoarseSpace:
    """Smoothed rigid-body coarse space with the block-sparse prolongator."""

    p_cols: torch.Tensor    # [n, K] aggregate of each slot
    p_blocks: torch.Tensor  # [n, K, 6, 6] smoothed blocks (fixed rows zero)
    p_rows: torch.Tensor    # [n, 6, 6 K]: p_blocks as one row block a node
    L_c: torch.Tensor       # lower Cholesky factor of the scaled A_c
    scale: torch.Tensor     # [6 n_agg] symmetric Jacobi scaling of A_c
    Ac_inv: torch.Tensor    # explicit inverse of the scaled A_c
    restrict_sum: SegmentTable
    n_agg: int = 0


def _skew(r: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(r[..., 0])
    return torch.stack([
        torch.stack([z, -r[..., 2], r[..., 1]], dim=-1),
        torch.stack([r[..., 2], z, -r[..., 0]], dim=-1),
        torch.stack([-r[..., 1], r[..., 0], z], dim=-1)], dim=-2)


def _tentative_blocks(coords: torch.Tensor, agg, n_agg: int, fixed_mask,
                      dtype):
    """Per-node tentative rigid-body blocks Pb [n, 6, 6] (fixed rows
    zeroed) and the free-node mask [n]."""
    n = coords.shape[0]
    agg_np = np.asarray(torch.as_tensor(agg).cpu()).astype(np.int64)
    counts = np.bincount(agg_np, minlength=n_agg)
    cent = segment_sum_ordered(coords, segment_table(agg_np, n_agg,
                                                     coords.device))
    cent = cent / torch.as_tensor(counts, dtype=coords.dtype,
                                  device=coords.device)[:, None]
    aggt = torch.as_tensor(agg_np, device=coords.device)
    r_mm = ((coords - cent[aggt]) * 1000.0).to(dtype)
    eye3 = torch.eye(3, dtype=dtype, device=coords.device).expand(n, 3, 3)
    top = torch.cat([eye3, -_skew(r_mm)], dim=-1)
    bot = torch.cat([torch.zeros_like(eye3), eye3], dim=-1)
    free = torch.logical_not(fixed_mask.to(coords.device)).to(dtype)
    return torch.cat([top, bot], dim=-2) * free[:, None, None], free


def _factor_coarse(Ac: torch.Tensor, n_agg: int):
    """Symmetric Jacobi scaling + a 1e-10 shift + Cholesky of A_c, and the
    explicit inverse of the scaled operator, so the per-iteration coarse
    solve is one mat-vec.  Inactive coarse DOFs (fully fixed aggregates,
    zero columns) get identity rows, so the correction is exactly zero
    there."""
    d = torch.diagonal(Ac)
    active = d > 1e-12 * torch.max(d)
    ds = torch.where(active, 1.0 / torch.sqrt(torch.where(
        active, d, torch.ones_like(d))), torch.zeros_like(d))
    Acs = Ac * ds[:, None] * ds[None, :]
    idx = torch.arange(6 * n_agg, device=Ac.device)
    Acs[idx, idx] = torch.where(active, Acs[idx, idx] + 1e-10,
                                torch.ones_like(d))
    L, _ = torch.linalg.cholesky_ex(Acs)
    return L, ds, torch.cholesky_inverse(L)


def _p_rows(p_blocks: torch.Tensor) -> torch.Tensor:
    """[n, K, 6, 6] -> [n, 6, 6 K]: node i's slots side by side."""
    n, K = p_blocks.shape[:2]
    return p_blocks.permute(0, 2, 1, 3).reshape(n, 6, 6 * K)


def build_coarse_space(A: BCSRMatrix, coords, fixed_mask, agg=None,
                       n_agg: int | None = None, target_size: int = 32,
                       omega: float = 0.5, n_smooth: int = 1,
                       plan: SparsePPlan | None = None) -> CoarseSpace:
    """The block-sparse smoothed prolongator and the factored
    A_c = P^T A P (once per (mesh, K); O(nnz)).  ``agg`` / ``n_agg`` /
    ``plan`` (:func:`aggregates_from_pattern`, :func:`plan_sparse_p`) are
    computed when not given; ``n_smooth`` is 0 or 1 (the slot plan holds
    one pass of support growth)."""
    if n_smooth not in (0, 1):
        raise ValueError("sparse coarse build supports n_smooth in {0, 1}; "
                         "use build_coarse_space_dense for experiments")
    n = A.pattern.n_nodes
    if agg is None:
        agg = aggregates_from_pattern(A.pattern, target_size)
    if n_agg is None:
        n_agg = int(np.asarray(torch.as_tensor(agg).cpu()).max()) + 1
    if plan is None:
        plan = plan_sparse_p(A.pattern, agg, n_agg)
    dtype, K = A.blocks.dtype, plan.K
    Pb, free = _tentative_blocks(torch.as_tensor(coords, device=A.blocks
                                                 .device), agg, n_agg,
                                 fixed_mask, dtype)
    if n_smooth:
        free6 = free.repeat_interleave(6)
        Dinv = block_jacobi_inverse(bcsr_block_diagonal(A), free6)
        br, bc = A.pattern.block_rows, A.pattern.block_cols
        contrib = -omega * (Dinv[br] @ A.blocks @ Pb[bc])
        flat = segment_sum_ordered(
            torch.cat([contrib, Pb]).reshape(-1, 36), plan.smooth_sum)
    else:
        flat = Pb.new_zeros(n * K, 36)
        flat[plan.tent_slot] = Pb.reshape(n, 36)
    p_blocks = flat.reshape(n, K, 6, 6) * free[:, None, None, None]
    L_c, ds, Ainv = _factor_coarse(
        galerkin_coarse_operator(A, plan, p_blocks, n_agg), n_agg)
    return CoarseSpace(p_cols=plan.p_cols, p_blocks=p_blocks,
                       p_rows=_p_rows(p_blocks), L_c=L_c, scale=ds,
                       Ac_inv=Ainv, restrict_sum=plan.restrict_sum,
                       n_agg=n_agg)


def galerkin_coarse_operator(A: BCSRMatrix, plan: SparsePPlan,
                             p_blocks: torch.Tensor,
                             n_agg: int) -> torch.Tensor:
    """Dense A_c = P^T A P [6 n_agg, 6 n_agg] from the sparse P: one
    batched 6x6 triple product per (BCSR entry, left slot, right slot)
    triple with both slots real, summed in a fixed order into the coarse
    blocks they touch (build time only; no [6n, 6 n_agg] intermediate)."""
    br, bc = A.pattern.block_rows, A.pattern.block_cols
    e = plan.tri_e
    left = p_blocks[br[e], plan.tri_ka]
    right = p_blocks[bc[e], plan.tri_kb]
    blk = left.mT @ A.blocks[e] @ right
    Ablk = A.blocks.new_zeros(n_agg * n_agg, 36)
    Ablk[plan.coarse_keys] = segment_sum_ordered(blk.reshape(-1, 36),
                                                 plan.galerkin_sum)
    return Ablk.reshape(n_agg, n_agg, 6, 6).permute(0, 2, 1, 3).reshape(
        6 * n_agg, 6 * n_agg)


def prolong(cs: CoarseSpace, xc: torch.Tensor) -> torch.Tensor:
    """y = P @ x_c ([6 n_agg] -> [6n]): gather each slot's coarse block,
    one batched product a node."""
    n = cs.p_cols.shape[0]
    g = xc.reshape(cs.n_agg, 6)[cs.p_cols].reshape(n, -1, 1)
    return (cs.p_rows @ g).reshape(-1)


def restrict(cs: CoarseSpace, r: torch.Tensor) -> torch.Tensor:
    """r_c = P^T @ r ([6n] -> [6 n_agg]): one batched product a node, then
    the fixed-order sum of the real slots into their aggregates."""
    n = cs.p_cols.shape[0]
    c = (cs.p_rows.mT @ r.reshape(n, 6, 1)).reshape(-1, 6)   # [n K, 6]
    return segment_sum_ordered(c, cs.restrict_sum).reshape(-1)


def prolongator_dense(cs: CoarseSpace) -> torch.Tensor:
    """The sparse P as a dense [6n, 6 n_agg] (tests only)."""
    n, K = cs.p_cols.shape
    onehot = (cs.p_cols[..., None] == torch.arange(
        cs.n_agg, device=cs.p_cols.device)).to(cs.p_blocks.dtype)
    Pd = torch.einsum("nka,nkuq->nuaq", onehot, cs.p_blocks)
    return Pd.reshape(6 * n, 6 * cs.n_agg)


def coarse_solve(cs, rc: torch.Tensor) -> torch.Tensor:
    """A_c^-1 rc through the precomputed scaled inverse (one mat-vec)."""
    return cs.scale * (cs.Ac_inv @ (cs.scale * rc))


def two_level_preconditioner(block_jacobi, cs: CoarseSpace):
    """Additive two-level preconditioner D_bj^-1 + P A_c^-1 P^T
    (``block_jacobi``: the nodal smoother callable,
    :func:`.solve.block_jacobi_preconditioner`); SPD, so plain CG
    applies."""
    def precond(r):
        return block_jacobi(r) + prolong(cs, coarse_solve(cs, restrict(cs,
                                                                       r)))
    return precond


# ---------------------------------------------------------------------------
# Dense construction (test oracle only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DenseCoarseSpace:
    """Dense-P coarse space: the oracle of :func:`build_coarse_space`."""

    P: torch.Tensor        # [6n, 6 n_agg]
    L_c: torch.Tensor
    scale: torch.Tensor
    Ac_inv: torch.Tensor
    n_agg: int = 0


def build_coarse_space_dense(A: BCSRMatrix, coords, fixed_mask, agg=None,
                             n_agg: int | None = None,
                             target_size: int = 32, omega: float = 0.5,
                             n_smooth: int = 1) -> DenseCoarseSpace:
    """Dense-P construction (any ``n_smooth``), the test oracle of
    :func:`build_coarse_space`; its P is O(n * n_agg)."""
    n = A.pattern.n_nodes
    if agg is None:
        agg = aggregates_from_pattern(A.pattern, target_size)
    agg = torch.as_tensor(agg, device=A.blocks.device)
    if n_agg is None:
        n_agg = int(agg.max()) + 1
    dtype = A.blocks.dtype
    Pb, free = _tentative_blocks(torch.as_tensor(coords, device=A.blocks
                                                 .device), agg, n_agg,
                                 fixed_mask, dtype)
    free6 = free.repeat_interleave(6)
    onehot = (agg[:, None] == torch.arange(n_agg, device=agg.device)
              ).to(dtype)
    P = torch.einsum("na,nij->niaj", onehot, Pb).reshape(6 * n, 6 * n_agg)
    Dinv = block_jacobi_inverse(bcsr_block_diagonal(A), free6)

    def amat(X, chunk: int = 128):
        return torch.cat([bcsr_matvec(A, X[:, c:c + chunk])
                          for c in range(0, X.shape[1], chunk)], dim=1)

    for _ in range(n_smooth):
        P = P - omega * (Dinv @ amat(P).reshape(n, 6, -1)).reshape(6 * n, -1)
        P = P * free6[:, None]
    L_c, ds, Ainv = _factor_coarse(P.T @ amat(P), n_agg)
    return DenseCoarseSpace(P=P, L_c=L_c, scale=ds, Ac_inv=Ainv, n_agg=n_agg)


def two_level_preconditioner_dense(block_jacobi, cs: DenseCoarseSpace):
    """Dense-P additive two-level preconditioner (test oracle)."""
    def precond(r):
        return block_jacobi(r) + cs.P @ coarse_solve(cs, cs.P.T @ r)
    return precond
