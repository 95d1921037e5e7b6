"""Global stiffness assembly: dense, block-sparse (BCSR) and direct-write
(PyTorch counterpart of ``small_fem_solver_tpu/ops/assembly.py``), and
the fixed-order sums they rest on.

- The dense path is one accumulating scatter of all element entries.
- The block-sparse path lays K out as 6x6 node blocks in BCSR.  The
  pattern depends only on the connectivity and is built once on the host
  (``native/mesh_kit.cpp`` when built, else a numpy sort);
  :func:`bcsr_matvec`, the hot operation of the CG solver, is a gather,
  one batched 6x6 product and a row sum.
- The direct-write path (:func:`assemble_bcsr_direct`) emits the blocks in
  assembled [diag | ij | ji] order from member geometry permuted at
  prepare time, with no scatter (the bench's assembly line).

Every repeated-index sum here (nodal sums of member-end values, BCSR
assembly, the mat-vec's row sums, the block diagonal) runs in a fixed
order through a gather table built once on the host
(:func:`segment_table`, :func:`node_gather_table`), so results on the card
are bit-repeatable: ``index_add_`` adds with atomics there.  This one
fixed-order row reduction replaces the JAX package's two-tier gather plan
(``small_fem_solver_tpu/ops/assembly.py:64-71``, a TPU gather-vs-scatter
workaround).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .beams import lane_quadrants, quadrant_stack


def element_dof_indices(conn: torch.Tensor) -> torch.Tensor:
    """``dofs[M, 12]``: global DOF indices (6*node + c) of each element."""
    c = torch.arange(6, dtype=conn.dtype, device=conn.device)
    return torch.cat([6 * conn[:, 0:1] + c, 6 * conn[:, 1:2] + c], dim=-1)


def assemble_dense(K_elems: torch.Tensor, conn: torch.Tensor,
                   n_dof: int) -> torch.Tensor:
    """Dense global K: one accumulating scatter of all element entries."""
    dofs = element_dof_indices(conn)
    rows = dofs[:, :, None].expand(K_elems.shape).reshape(-1)
    cols = dofs[:, None, :].expand(K_elems.shape).reshape(-1)
    K = K_elems.new_zeros(n_dof, n_dof)
    return K.index_put_((rows, cols), K_elems.reshape(-1), accumulate=True)


def node_gather_table(nodes: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[n_nodes, max count] positions of each node's entries in ``nodes``
    [E] (ascending, padded with E), on ``nodes``' device: the fixed
    summation order of :func:`node_sum_ordered`.  Built on the host from
    one copy of ``nodes`` (a synchronisation on the card: build it once
    per call, outside loops)."""
    idx = nodes.cpu().numpy()
    E = idx.shape[0]
    order = np.argsort(idx, kind="stable")
    counts = np.bincount(idx, minlength=n_nodes)
    first = np.cumsum(counts) - counts
    table = np.full((n_nodes, max(int(counts.max(initial=0)), 1)), E)
    table[idx[order], np.arange(E) - first[idx[order]]] = order
    return torch.as_tensor(table, device=nodes.device)


def node_sum_ordered(values: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """``values`` [..., E, c] summed onto their nodes -> [..., n_nodes, c]
    in a fixed order: each node gathers its entries into one row of
    ``table`` (:func:`node_gather_table`, zero-padded to the largest
    count) that is summed along the row, so the result is bit-repeatable
    on the card, where ``index_add_`` adds with atomics."""
    padded = torch.cat([values, values.new_zeros(*values.shape[:-2], 1,
                                                 values.shape[-1])], dim=-2)
    return padded[..., table, :].sum(dim=-2)


# ---------------------------------------------------------------------------
# Fixed-order segment sums
# ---------------------------------------------------------------------------

class SegmentTable(NamedTuple):
    """Host-built plan of a fixed-order segment sum of E entries into
    ``n_segments`` segments (:func:`segment_sum_ordered`).

    ``tables``: per bucket of segments, [rows, width] entry positions in
    ascending order, padded with E (a zero row appended to the entries);
    ``inverse``: [n_segments] row of each segment in the concatenated
    bucket results, or None when one bucket holds every segment in
    order."""

    tables: tuple
    inverse: torch.Tensor | None


def segment_table(seg, n_segments: int, device) -> SegmentTable:
    """The fixed-order plan of summing entry ``e`` into segment
    ``seg[e]`` (host numpy ints; entries with ``seg < 0`` are left out).

    One padded table when it holds at most 4 slots an entry, else buckets
    of segments by entry count (widths rounded up to powers of two), so
    that a few long segments do not pad every other one."""
    seg = np.asarray(seg, np.int64).reshape(-1)
    E = seg.shape[0]
    pos = np.nonzero(seg >= 0)[0]
    keys = seg[pos]
    srt = np.argsort(keys, kind="stable")
    order, sorted_keys = pos[srt], keys[srt]
    counts = np.bincount(keys, minlength=n_segments)
    first = np.cumsum(counts) - counts
    width = max(int(counts.max(initial=0)), 1)
    if n_segments * width <= 4 * max(pos.size, 1):
        groups = [np.arange(n_segments)]
    else:
        w = np.maximum(1, 1 << np.ceil(np.log2(np.maximum(counts, 1)))
                       .astype(np.int64))
        groups = [np.nonzero(w == v)[0] for v in np.unique(w)]
    rank = np.arange(order.size) - first[sorted_keys]
    tables = []
    for rows in groups:
        t = np.full((rows.size, max(int(counts[rows].max(initial=0)), 1)), E)
        where = np.full(n_segments, -1)
        where[rows] = np.arange(rows.size)
        sel = where[sorted_keys] >= 0
        t[where[sorted_keys[sel]], rank[sel]] = order[sel]
        tables.append(torch.as_tensor(t, device=device))
    inverse = None
    if len(groups) > 1:
        inv = np.empty(n_segments, np.int64)
        inv[np.concatenate(groups)] = np.arange(n_segments)
        inverse = torch.as_tensor(inv, device=device)
    return SegmentTable(tables=tuple(tables), inverse=inverse)


def segment_sum_ordered(values: torch.Tensor,
                        st: SegmentTable) -> torch.Tensor:
    """``values`` [E, ...] summed into segments -> [n_segments, ...] in the
    fixed order of ``st`` (:func:`segment_table`): bit-repeatable on the
    card."""
    padded = torch.cat([values, values.new_zeros(1, *values.shape[1:])])
    outs = [padded[t].sum(dim=1) for t in st.tables]
    if st.inverse is None:
        return outs[0]
    return torch.cat(outs)[st.inverse]


# ---------------------------------------------------------------------------
# Block CSR (6x6 node blocks)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BCSRPattern:
    """Block sparsity pattern of the global K (built on the host once per
    mesh; index arrays on the model's device, int64).

    block_rows / block_cols [n_blocks]  block row / column of each block
    row_ptr [n_nodes + 1]               CSR row pointers (all zeros for the
                                        direct-write [diag | ij | ji] order)
    elem_slot [M, 4]                    destination block of each element's
                                        (ii, ij, ji, jj) quadrant
    diag_block [n_nodes]                each node's (i, i) block (n_blocks
                                        where it has none)
    row_sum                             fixed-order plan of the mat-vec's
                                        row sums (blocks -> rows)
    slot_sum                            fixed-order plan of assembly
                                        (quadrants -> blocks)
    """

    block_rows: torch.Tensor
    block_cols: torch.Tensor
    row_ptr: torch.Tensor
    elem_slot: torch.Tensor
    diag_block: torch.Tensor
    row_sum: SegmentTable
    slot_sum: SegmentTable
    n_nodes: int
    n_blocks: int


def _pattern(block_rows, block_cols, row_ptr, elem_slot, n_nodes: int,
             device) -> BCSRPattern:
    """A :class:`BCSRPattern` from host arrays, with its sum plans."""
    nb = int(block_rows.shape[0])
    diag_block = np.full(n_nodes, nb)
    on_diag = np.nonzero(np.asarray(block_rows) == np.asarray(block_cols))[0]
    diag_block[np.asarray(block_rows)[on_diag]] = on_diag

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)
    return BCSRPattern(
        block_rows=dev(block_rows), block_cols=dev(block_cols),
        row_ptr=dev(row_ptr), elem_slot=dev(elem_slot),
        diag_block=dev(diag_block),
        row_sum=segment_table(block_rows, n_nodes, device),
        # contributions in assemble_bcsr's (ii | ij | ji | jj)-major order
        slot_sum=segment_table(np.asarray(elem_slot).T.reshape(-1), nb,
                               device),
        n_nodes=int(n_nodes), n_blocks=nb)


def build_bcsr_pattern(conn, n_nodes: int, device=None) -> BCSRPattern:
    """Pattern of the element connectivity ``conn`` [M, 2] (numpy or a
    tensor; runs on the host once per mesh): blocks sorted by (row, col).
    Uses the native mesh kit (an O(M) hash map) when built, otherwise a
    numpy sort over the 4M block keys; both give the same integers.
    ``device`` defaults to ``conn``'s (the CPU for numpy input)."""
    if device is None:
        device = conn.device if isinstance(conn, torch.Tensor) else "cpu"
    conn = np.asarray(torch.as_tensor(conn).cpu())
    from .. import native
    out = native.bcsr_pattern_native(conn, n_nodes)
    if out is None:
        out = _bcsr_pattern_numpy(conn, n_nodes)
    return _pattern(*out, n_nodes, device)


def _bcsr_pattern_numpy(conn: np.ndarray, n_nodes: int):
    """(block_rows, block_cols, row_ptr, elem_slot) by a numpy sort."""
    i, j = conn[:, 0].astype(np.int64), conn[:, 1].astype(np.int64)
    br = np.concatenate([i, i, j, j])
    bc = np.concatenate([i, j, i, j])
    uniq, inverse = np.unique(br * n_nodes + bc, return_inverse=True)
    block_rows = (uniq // n_nodes).astype(np.int32)
    block_cols = (uniq % n_nodes).astype(np.int32)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(row_ptr, block_rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    elem_slot = inverse.reshape(4, -1).T.astype(np.int32)   # [M, 4]
    return block_rows, block_cols, row_ptr, elem_slot


class BCSRMatrix(NamedTuple):
    pattern: BCSRPattern
    blocks: torch.Tensor          # [n_blocks, 6, 6]


def assemble_bcsr(K_elems: torch.Tensor, pattern: BCSRPattern) -> BCSRMatrix:
    """Assemble element matrices (the stacked [M, 12, 12] or the quadrant
    stack [4M, 6, 6] of :func:`.beams.global_stiffness_quadrants`) into
    BCSR blocks: one fixed-order segment sum of the 4M quadrants into
    their pattern slots."""
    if K_elems.shape[-2:] == (12, 12):
        K_elems = quadrant_stack(K_elems)
    contrib = K_elems.reshape(-1, 36)
    blocks = segment_sum_ordered(contrib, pattern.slot_sum)
    return BCSRMatrix(pattern=pattern, blocks=blocks.reshape(-1, 6, 6))


def bcsr_matvec(A: BCSRMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = K @ x with x of shape [n_dof] or [n_dof, B] (multi-RHS): gather
    the x blocks of each block's column, one batched 6x6 product, and the
    fixed-order row sums."""
    n = A.pattern.n_nodes
    xg = x.reshape(n, 6, -1)[A.pattern.block_cols]         # [nb, 6, B]
    y = segment_sum_ordered(A.blocks @ xg, A.pattern.row_sum)
    return y.reshape(6 * n, -1) if x.ndim == 2 else y.reshape(-1)


def bcsr_block_diagonal(A: BCSRMatrix) -> torch.Tensor:
    """The 6x6 diagonal blocks [n_nodes, 6, 6] (for block-Jacobi PCG): the
    pattern's (i, i) block of each node (a row has at most one), zero
    where a node has none."""
    padded = torch.cat([A.blocks, A.blocks.new_zeros(1, 6, 6)])
    return padded[A.pattern.diag_block]


def bcsr_to_dense(A: BCSRMatrix) -> torch.Tensor:
    """Densify (tests only)."""
    n = A.pattern.n_nodes
    K = A.blocks.new_zeros(n, 6, n, 6)
    K[A.pattern.block_rows, :, A.pattern.block_cols, :] = A.blocks
    return K.reshape(6 * n, 6 * n)


# ---------------------------------------------------------------------------
# Direct-write assembly
# ---------------------------------------------------------------------------
#
# With blocks ordered [diag | ij | ji], the off-diagonal blocks in
# key-sorted member order ARE the assembled result (a duplicate-free edge
# has exactly one contribution), and the diagonal is a padded [2N] list of
# member ends summed pairwise.  So the element quadrants are emitted in
# assembled order directly from member geometry permuted into that order
# at prepare time; hub nodes' 3rd+ diagonal contributions and duplicate
# edges (the "extras") add into their blocks through one fixed-order sum.
# The JAX package packs the same plan into TPU lane layouts (its
# ``_lane_*`` / ``_entry_key`` helpers); here every emitted block is one
# lane of a single batch of 6x6 quadrants, the lanes in block order
# [diag (2 a node) | ij | ji | extras], each lane with its quadrant code.
# End releases are not supported (use the generic path); new coordinates
# need a new prepare, a uniform scale does not.

@dataclasses.dataclass(frozen=True)
class DirectAssembly:
    """Prepared direct-write assembly for one (mesh, coords).

    ``pattern`` stores the blocks in [diag | ij | ji] order (every BCSR
    consumer keys on block_rows / block_cols and is order-agnostic);
    ``row_ptr`` is all zeros and ``elem_slot`` holds each element's four
    destination blocks in this order.  The lanes, in the order above:
    member end coordinates c1 / c2 [L, 3] (m), section ids and quadrant
    codes [L] (0 ii, 1 ij, 2 ji, 3 jj)."""

    pattern: BCSRPattern
    c1: torch.Tensor
    c2: torch.Tensor
    sect: torch.Tensor
    quad: torch.Tensor
    diag_mask: torch.Tensor      # [2N] 0.0 on the diagonal's padding lanes
    n_ij: int
    n_ji: int
    ex_slots: torch.Tensor       # [n_slots] distinct blocks the extras hit
    ex_sum: SegmentTable         # extras -> ex_slots, fixed order


def _direct_plan(conn: np.ndarray, n_nodes: int) -> dict:
    """Host-side direct-write plan: block order, the lanes' members and
    quadrant codes (0 ii, 1 ij, 2 ji, 3 jj) in block order, and the
    extras (hub 3rd+ diagonal contributions and duplicate edges) with
    their blocks; the JAX package's plan in another layout."""
    i = conn[:, 0].astype(np.int64)
    j = conn[:, 1].astype(np.int64)
    M = i.shape[0]

    def offdiag(rows, cols):
        key = rows * n_nodes + cols
        order = np.argsort(key, kind="stable")
        k_sorted = key[order]
        uniq, first = np.unique(k_sorted, return_index=True)
        dup = np.ones(M, bool)
        dup[first] = False
        return (uniq, order[first], order[dup],
                np.searchsorted(uniq, k_sorted[dup]))

    ij_keys, ij_members, ij_dup_m, ij_dup_s = offdiag(i, j)
    ji_keys, ji_members, ji_dup_m, ji_dup_s = offdiag(j, i)

    nodes = np.concatenate([i, j])
    member = np.concatenate([np.arange(M), np.arange(M)])
    end = np.concatenate([np.zeros(M, np.int64),      # ii quadrant
                          np.full(M, 3, np.int64)])    # jj quadrant
    order = np.argsort(nodes, kind="stable")
    member_s, end_s = member[order], end[order]
    counts = np.bincount(nodes, minlength=n_nodes)
    starts = np.cumsum(counts) - counts
    diag_member = np.zeros(2 * n_nodes, np.int64)
    diag_quad = np.zeros(2 * n_nodes, np.int64)
    diag_mask = np.zeros(2 * n_nodes)
    for c in range(2):
        sel = counts > c
        pos = 2 * np.nonzero(sel)[0] + c
        diag_member[pos] = member_s[starts[sel] + c]
        diag_quad[pos] = end_s[starts[sel] + c]
        diag_mask[pos] = 1.0
    ex_m, ex_quad, ex_slot = [], [], []
    for c in range(2, int(counts.max(initial=0))):
        sel = np.nonzero(counts > c)[0]
        ex_m.append(member_s[starts[sel] + c])
        ex_quad.append(end_s[starts[sel] + c])
        ex_slot.append(sel)
    n_ij = ij_keys.shape[0]
    ex_m += [ij_dup_m, ji_dup_m]
    ex_quad += [np.full(ij_dup_m.shape, 1), np.full(ji_dup_m.shape, 2)]
    ex_slot += [n_nodes + ij_dup_s, n_nodes + n_ij + ji_dup_s]

    block_rows = np.concatenate([np.arange(n_nodes), ij_keys // n_nodes,
                                 ji_keys // n_nodes])
    block_cols = np.concatenate([np.arange(n_nodes), ij_keys % n_nodes,
                                 ji_keys % n_nodes])
    elem_slot = np.stack([
        i, n_nodes + np.searchsorted(ij_keys, i * n_nodes + j),
        n_nodes + n_ij + np.searchsorted(ji_keys, j * n_nodes + i), j],
        axis=1)
    return dict(
        block_rows=block_rows, block_cols=block_cols, elem_slot=elem_slot,
        members=np.concatenate([diag_member, ij_members, ji_members,
                                *ex_m]).astype(np.int64),
        quad=np.concatenate([diag_quad, np.full(ij_members.size, 1),
                             np.full(ji_members.size, 2),
                             *ex_quad]).astype(np.int64),
        diag_mask=diag_mask, n_ij=int(ij_members.size),
        n_ji=int(ji_members.size),
        ex_slot=np.concatenate(ex_slot).astype(np.int64))


def prepare_direct_assembly(coords, conn, sect_id,
                            n_nodes: int) -> DirectAssembly:
    """The direct-write plan of one mesh and its coordinates (host numpy
    once, then one copy to ``coords``' device)."""
    device = coords.device if isinstance(coords, torch.Tensor) else "cpu"
    coords_t = torch.as_tensor(coords)
    conn = np.asarray(torch.as_tensor(conn).cpu())
    sect = np.asarray(torch.as_tensor(sect_id).cpu()).astype(np.int64)
    plan = _direct_plan(conn, n_nodes)
    members = plan["members"]
    c = coords_t.cpu()[torch.as_tensor(conn[members])]          # [L, 2, 3]
    slots, slot_of = np.unique(plan["ex_slot"], return_inverse=True)
    pattern = _pattern(plan["block_rows"], plan["block_cols"],
                       np.zeros(n_nodes + 1, np.int64), plan["elem_slot"],
                       n_nodes, device)
    return DirectAssembly(
        pattern=pattern, c1=c[:, 0].to(device), c2=c[:, 1].to(device),
        sect=torch.as_tensor(sect[members], device=device),
        quad=torch.as_tensor(plan["quad"], device=device),
        diag_mask=torch.as_tensor(plan["diag_mask"], dtype=coords_t.dtype,
                                  device=device),
        n_ij=plan["n_ij"], n_ji=plan["n_ji"],
        ex_slots=torch.as_tensor(slots, device=device),
        ex_sum=segment_table(slot_of, slots.size, device))


def assemble_bcsr_direct(prep: DirectAssembly, sections, E, G,
                         scale=None) -> BCSRMatrix:
    """The global K in BCSR from a prepared direct-write plan: every
    lane's quadrant in one batch (:func:`.beams.lane_quadrants`), in the
    block order it lands in; the diagonal lanes summed pairwise, the
    off-diagonal ones are their blocks, and the extras add in a fixed
    order.  ``scale``: optional uniform geometry scale at call time (the
    one coordinate change that needs no new prepare)."""
    n = prep.pattern.n_nodes
    Q = lane_quadrants(prep.c1, prep.c2, scale, sections, prep.sect, E, G,
                       prep.quad)
    off = 2 * n + prep.n_ij + prep.n_ji
    diag = (Q[:2 * n] * prep.diag_mask[:, None, None]).reshape(
        n, 2, 6, 6).sum(1)
    blocks = torch.cat([diag, Q[2 * n:off]])
    if prep.ex_slots.shape[0]:
        add = segment_sum_ordered(Q[off:], prep.ex_sum)
        blocks = blocks.index_put((prep.ex_slots,),
                                  blocks[prep.ex_slots] + add)
    return BCSRMatrix(pattern=prep.pattern, blocks=blocks)
