"""Dense global stiffness assembly (PyTorch counterpart of
``small_fem_solver_tpu/ops/assembly.py::assemble_dense``).

Block-sparse (BCSR) assembly is not ported yet (ROADMAP.md, Queue A
item 5).
"""
from __future__ import annotations

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
