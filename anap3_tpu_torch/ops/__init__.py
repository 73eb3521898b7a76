"""Kernel wrappers and plain-torch numerics: the SG CUDA kernels and the
separable Poisson solver."""
