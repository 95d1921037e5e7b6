"""Case batches for design envelopes (PyTorch counterpart of
``small_fem_solver_tpu/parallel``)."""
