"""The port's kernels: each TPU kernel of ``repro.kernels`` as a
hand-written CUDA kernel for Hopper (``csrc/``), beside its plain torch
version.  Nothing here builds or loads CUDA code at import time."""
