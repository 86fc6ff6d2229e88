"""Tensor ops and the CUDA kernel wrappers of the port."""
