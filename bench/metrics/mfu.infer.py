"""Device: the configuration's FLOPs an image (every convolution and
dense layer) times the images of the window, over the window, over the
configuration's peak."""

from bench.counts import vgg_conv_flops, vgg_dense_flops


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["images"]:
        return None
    cfg = ctx["config"]
    flops = (vgg_conv_flops(cfg) + vgg_dense_flops(cfg)) * ctx["images"]
    return 100.0 * flops / ctx["window_s"] / ctx["peak_flops"]
