"""Case batches, case- and row-sharded runs on ``torch.distributed``
(PyTorch counterpart of ``small_fem_solver_tpu/parallel``): ``sweep``,
``comm`` (the collectives), ``multihost`` and ``pcg_dist``."""
