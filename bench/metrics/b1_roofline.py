"""Kernels: B1 (``fused_matmul``) on the dense layers: their bytes (f32
weights and biases, each layer's input and output, counted once) at
3.35 TB/s, over B1's device time a call in the traced slice.  Read
only where B1 runs every dense layer."""

from bench.counts import PEAK_BYTES_PER_S, dense_bytes
from bench.trace import kernel_time

B1_KERNELS = ("fm_gemv_kernel", "fm_tiled_kernel")


def read(ctx):
    tr, calls = ctx.get("trace"), len(ctx.get("slice_latency_s") or ())
    cfg = ctx.get("config")
    if not tr or not calls or not cfg:
        return None
    if ctx["dense_kernels"] != ["cuda.fused_matmul"] * len(cfg["dense"]):
        return None
    t = kernel_time(tr, B1_KERNELS) / calls
    if t <= 0:
        return None
    bound = dense_bytes(cfg, ctx["batch"]) / PEAK_BYTES_PER_S
    return 100.0 * bound / t
