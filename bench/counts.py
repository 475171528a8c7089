"""Operations and bytes worked out from a configuration's shapes, and the
card's published peaks: the yardstick the roofline and ``mfu`` readers
divide by.  Nothing here reads the program.

Peaks: NVIDIA's H100 SXM data sheet, dense rates without sparsity, at
the full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


# -- the dense decoder (configs/*.json "run") --------------------------------
def _heads(arch: Dict) -> Tuple[int, int, int]:
    hd = arch.get("head_dim") or arch["d_model"] // arch["n_heads"]
    return arch["n_heads"], arch["n_kv_heads"], hd


def layer_matmul_params(arch: Dict) -> int:
    """Weights one decoder layer multiplies by (attention and gated MLP)."""
    d, f = arch["d_model"], arch["d_ff"]
    h, hkv, hd = _heads(arch)
    return d * hd * (2 * h + 2 * hkv) + 3 * d * f


def decoder_params(arch: Dict) -> int:
    """Every parameter: the embedding (the head too where tied), the
    layers with their two norms, the final norm, an untied head."""
    d, v, n = arch["d_model"], arch["vocab"], arch["num_layers"]
    total = v * d + n * (layer_matmul_params(arch) + 2 * d) + d
    if not arch.get("tie_embeddings"):
        total += d * v
    return total


def kv_bytes_per_token(arch: Dict, itemsize: int = 2) -> int:
    """K and V of one token over every layer."""
    _, hkv, hd = _heads(arch)
    return 2 * arch["num_layers"] * hkv * hd * itemsize


def token_flops(arch: Dict, context: int) -> int:
    """Multiply-adds (x2) of one token through every layer, attending
    ``context`` positions (its own included); the head not counted."""
    h, _, hd = _heads(arch)
    per_layer = 2 * layer_matmul_params(arch) + 4 * context * h * hd
    return arch["num_layers"] * per_layer


def prompt_flops(arch: Dict, start: int, stop: int) -> int:
    """``token_flops`` of positions ``[start, stop)``, each attending
    itself and every earlier position."""
    n = stop - start
    h, _, hd = _heads(arch)
    ctx_sum = (start + 1 + stop) * n // 2       # sum of (p + 1)
    return arch["num_layers"] * (2 * layer_matmul_params(arch) * n
                                 + 4 * ctx_sum * h * hd)


def head_flops(arch: Dict) -> int:
    """The vocabulary projection of one token."""
    return 2 * arch["d_model"] * arch["vocab"]


# -- the VGG family (configs/vgg*.json) --------------------------------------
def vgg_convs(cfg: Dict) -> List[Tuple[int, int, int, int]]:
    """(height, width, in channels, out channels) of every 3x3
    convolution, in order ("same" padding, stride 1)."""
    h, w, c = cfg["input"]
    out = []
    for width, convs in cfg["blocks"]:
        for _ in range(convs):
            out.append((h, w, c, width))
            c = width
        h, w = h // 2, w // 2
    return out


def vgg_denses(cfg: Dict) -> List[Tuple[int, int]]:
    """(in, out) of every dense layer, in order."""
    h, w, _ = cfg["input"]
    for _ in cfg["blocks"]:
        h, w = h // 2, w // 2
    k = h * w * cfg["blocks"][-1][0]
    out = []
    for n in cfg["dense"]:
        out.append((k, n))
        k = n
    return out


def vgg_conv_flops(cfg: Dict) -> int:
    """Multiply-adds (x2) of one image's convolutions."""
    return sum(2 * h * w * ci * co * 9 for h, w, ci, co in vgg_convs(cfg))


def vgg_dense_flops(cfg: Dict) -> int:
    return sum(2 * k * n for k, n in vgg_denses(cfg))


def vgg_params(cfg: Dict) -> int:
    return (sum(9 * ci * co + co for _, _, ci, co in vgg_convs(cfg))
            + sum(k * n + n for k, n in vgg_denses(cfg)))


def dense_bytes(cfg: Dict, batch: int, itemsize: int = 4) -> int:
    """Bytes the dense layers move at ``batch``, each counted once: the
    weights and biases, each layer's input and output."""
    return sum((k * n + n + batch * (k + n)) * itemsize
               for k, n in vgg_denses(cfg))
