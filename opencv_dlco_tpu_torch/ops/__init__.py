"""Numerical ops: patch transform, pooling regions, ring distances, hinge, ROC,
and the wrappers of the CUDA kernels."""
