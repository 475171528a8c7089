"""The plain reference of the VGG family (``configs/vgg19.json``):
plain PyTorch in float32 with TF32 off, NHWC inputs as the graph IR
takes them, nothing of the program.

Blocks of 3x3 "same" convolutions (stride 1) with bias and ReLU, a 2x2
max-pool after each block, the activations flattened in (H, W, C)
order, dense layers with bias (ReLU after all but the last) and a
softmax.

``make_weights`` draws the weights both sides get, on the device, from
the seed: one call for every kernel, one for every bias.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ..counts import vgg_convs, vgg_denses
from .decoder import full_f32

MASK64 = (1 << 64) - 1
BIAS_STD = 0.01


def make_weights(cfg: Dict, seed: int, device) -> List[Tuple]:
    """[(kind, kernel, bias)] in order: conv kernels (3, 3, in, out) and
    dense kernels (in, out), He-normal (sqrt(2 / fan_in)), biases
    N(0, BIAS_STD^2), float32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & MASK64)
    shapes = [("conv", (3, 3, ci, co), 9 * ci) for _, _, ci, co in
              vgg_convs(cfg)]
    shapes += [("dense", (k, n), k) for k, n in vgg_denses(cfg)]
    sizes = [torch.Size(s).numel() for _, s, _ in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    bias = torch.randn(sum(s[-1] for _, s, _ in shapes), generator=gen,
                       device=device).mul_(BIAS_STD)
    out, at, bt = [], 0, 0
    for (kind, shape, fan_in), n in zip(shapes, sizes):
        kernel = flat[at:at + n].view(shape).mul_((2.0 / fan_in) ** 0.5)
        out.append((kind, kernel, bias[bt:bt + shape[-1]]))
        at, bt = at + n, bt + shape[-1]
    return out


@torch.no_grad()
def forward(cfg: Dict, weights: List[Tuple], x: torch.Tensor,
            tf32: bool = False, rows: int = 64) -> torch.Tensor:
    """Softmax outputs (B, classes) of NHWC images ``x``, ``rows`` images
    at a time; ``tf32`` computes the products in TF32 (the control)."""
    with full_f32(tf32):
        return torch.cat([_forward(cfg, weights, x[i:i + rows])
                          for i in range(0, x.shape[0], rows)])


def _forward(cfg, weights, x):
    h = x.float().permute(0, 3, 1, 2)
    convs = iter(w for w in weights if w[0] == "conv")
    for _, n in cfg["blocks"]:
        for _ in range(n):
            _, k, b = next(convs)
            h = F.relu(F.conv2d(h, k.permute(3, 2, 0, 1), b, padding=1))
        h = F.max_pool2d(h, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    denses = [w for w in weights if w[0] == "dense"]
    for i, (_, k, b) in enumerate(denses):
        h = h @ k + b
        if i < len(denses) - 1:
            h = F.relu(h)
    return torch.softmax(h, -1)


def max_log_error(out: torch.Tensor, ref: torch.Tensor,
                  floor: float = 1e-30) -> float:
    """The widest gap between the log of an output and the log of the
    reference's, over every output the reference puts at ``floor`` or
    above: a relative error, which a saturated softmax does not hide
    (its small outputs carry the logits' error whole).  An output of 0
    where the reference's is not reads about 34 or more."""
    keep = ref >= floor
    tiny = torch.finfo(torch.float32).tiny * 2 ** -23      # smallest f32
    err = (out.float().clamp_min(tiny).log()
           - ref.float().clamp_min(tiny).log()).abs()
    return float(err[keep].max())
