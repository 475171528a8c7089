"""Fused matmul + epilogue: plain version, CUDA kernel, wrapper."""
