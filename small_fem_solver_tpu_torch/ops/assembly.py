"""Dense global stiffness assembly (PyTorch counterpart of
``small_fem_solver_tpu/ops/assembly.py::assemble_dense``) and the
fixed-order nodal sum of member-end values.

Block-sparse (BCSR) assembly is not ported yet (ROADMAP.md, Queue A
item 5).
"""
from __future__ import annotations

import numpy as np
import torch


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
