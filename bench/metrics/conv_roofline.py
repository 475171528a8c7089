"""Kernels: the convolutions: their multiply-adds (x2) at the
configuration's f32 peak, over the convolution kernels' device time a
call in the traced slice."""

from bench.counts import vgg_conv_flops
from bench.trace import CONV_KERNELS, kernel_time


def read(ctx):
    tr, calls = ctx.get("trace"), len(ctx.get("slice_latency_s") or ())
    cfg = ctx.get("config")
    if not tr or not calls or not cfg:
        return None
    t = kernel_time(tr, CONV_KERNELS) / calls
    if t <= 0:
        return None
    bound = vgg_conv_flops(cfg) * ctx["batch"] / ctx["peak_flops"]
    return 100.0 * bound / t
