"""Numerical operators: waves, loads, beams, assembly, solvers, kernels."""
