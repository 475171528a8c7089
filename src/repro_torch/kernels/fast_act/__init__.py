"""Fast activations (paper §3.4): plain version, CUDA kernel, wrapper."""
