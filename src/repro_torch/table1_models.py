"""The paper's Table-1 network suite, re-created in the graph IR.

Same families/topologies as the paper's six benchmarks; spatial sizes
and widths are reduced where noted so the *interpreted* baseline stays
CPU-tractable (the paper ran 2019-era C++ on a NAO; our oracle is a
Python-stepped interpreter).  Reductions are applied uniformly to both
the compiled and interpreted runs, so the compiled/interpreted ratio —
the paper's claim — is preserved.

The port's copy of ``benchmarks/table1_models.py``: the same builders,
seeds, widths and inputs, so both packages build ``structure_hash``-
identical graphs with equal weights.  These are the full widths the
repository defines, and the port's main path.
"""

from __future__ import annotations

from .core import Graph, ModelBuilder


def htwk_classifier() -> Graph:
    """Nao-Team HTWK's small patch classifier (C-HTWK)."""
    mb = ModelBuilder().seed(1)
    x = mb.input((16, 16, 1))
    h = mb.conv2d(x, 4, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 8, (3, 3), strides=(2, 2), activation="relu")
    h = mb.flatten(h)
    h = mb.dense(h, 16, activation="relu")
    h = mb.dense(h, 4)
    h = mb.softmax(h)
    return mb.build([h])


def bhuman_ball() -> Graph:
    """B-Human's ball candidate classifier (C-BH)."""
    mb = ModelBuilder().seed(2)
    x = mb.input((32, 32, 1))
    h = mb.conv2d(x, 8, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 16, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 16, (3, 3), activation="relu")
    h = mb.maxpool(h)
    h = mb.flatten(h)
    h = mb.dense(h, 32, activation="relu")
    h = mb.dense(h, 2)
    h = mb.softmax(h)
    return mb.build([h])


def jetnet_detector() -> Graph:
    """JET-Net-style full-image robot detector (grid of box predictions).
    Input reduced 160×120 -> 80×60."""
    mb = ModelBuilder().seed(3)
    x = mb.input((60, 80, 1))
    h = mb.conv2d(x, 8, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 16, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 24, (3, 3), strides=(2, 2), activation="relu")
    h = mb.conv2d(h, 24, (3, 3), activation="relu")
    h = mb.conv2d(h, 10, (1, 1))          # per-cell box + confidence
    return mb.build([h])


def field_segmenter() -> Graph:
    """80×80 field/non-field semantic segmentation (enc-dec with
    upsampling), as in the paper."""
    mb = ModelBuilder().seed(4)
    x = mb.input((80, 80, 1))
    h = mb.conv2d(x, 8, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 16, (3, 3), strides=(2, 2), activation="relu")
    h = mb.batchnorm(h)
    h = mb.conv2d(h, 16, (3, 3), activation="relu")
    h = mb.upsample(h, 2)
    h = mb.conv2d(h, 8, (3, 3), activation="relu")
    h = mb.upsample(h, 2)
    h = mb.conv2d(h, 2, (3, 3))
    h = mb.softmax(h)
    return mb.build([h])


def _inverted_residual(mb, x, cin, cout, stride, expand):
    h = mb.conv2d(x, cin * expand, (1, 1), use_bias=False)
    h = mb.batchnorm(h)
    h = mb.activation(h, "relu6")
    h = mb.depthwise_conv2d(h, (3, 3), strides=(stride, stride),
                            use_bias=False)
    h = mb.batchnorm(h)
    h = mb.activation(h, "relu6")
    h = mb.conv2d(h, cout, (1, 1), use_bias=False)
    h = mb.batchnorm(h)
    if stride == 1 and cin == cout:
        h = mb.add(h, x)
    return h


def mobilenet_v2() -> Graph:
    """MobileNetV2 topology (inverted residuals, relu6, BN everywhere);
    96×96 input and α≈0.25 widths for oracle tractability."""
    mb = ModelBuilder().seed(5)
    x = mb.input((96, 96, 3))
    h = mb.conv2d(x, 8, (3, 3), strides=(2, 2), use_bias=False)
    h = mb.batchnorm(h)
    h = mb.activation(h, "relu6")
    h = _inverted_residual(mb, h, 8, 8, 1, 1)
    h = _inverted_residual(mb, h, 8, 12, 2, 6)
    h = _inverted_residual(mb, h, 12, 12, 1, 6)
    h = _inverted_residual(mb, h, 12, 16, 2, 6)
    h = _inverted_residual(mb, h, 16, 16, 1, 6)
    h = _inverted_residual(mb, h, 16, 24, 2, 6)
    h = _inverted_residual(mb, h, 24, 24, 1, 6)
    h = _inverted_residual(mb, h, 24, 32, 2, 6)
    h = mb.conv2d(h, 64, (1, 1), use_bias=False)
    h = mb.batchnorm(h)
    h = mb.activation(h, "relu6")
    h = mb.global_avg_pool(h)
    return mb.build([h])


def vgg19_style() -> Graph:
    """VGG19's conv/pool pattern at 64×64 and 1/8 widths (the paper's
    'particularly large model' regime relative to the rest)."""
    mb = ModelBuilder().seed(6)
    x = mb.input((64, 64, 3))
    h = x
    for block, (width, convs) in enumerate(
            [(8, 2), (16, 2), (32, 4), (64, 4), (64, 4)]):
        for _ in range(convs):
            h = mb.conv2d(h, width, (3, 3), activation="relu")
        h = mb.maxpool(h)
    h = mb.flatten(h)
    h = mb.dense(h, 128, activation="relu")
    h = mb.dense(h, 128, activation="relu")
    h = mb.dense(h, 10)
    h = mb.softmax(h)
    return mb.build([h])


SUITE = {
    "C-HTWK": htwk_classifier,
    "C-BH": bhuman_ball,
    "Detector": jetnet_detector,
    "Segmenter": field_segmenter,
    "MobileNetV2": mobilenet_v2,
    "VGG19": vgg19_style,
}
