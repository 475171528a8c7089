"""The plain reference of the dense decoder, as the configuration's
``run`` block defines it (``configs/minicpm-2b.json``): plain PyTorch in
float32, TF32 off, one layer at a time, no cache, no batching and
nothing of the program.

The model: token embedding scaled by sqrt(d_model) (``scale_embed``);
``num_layers`` pre-norm layers of RMSNorm scaled by (1 + gamma), grouped
query attention with rotary embeddings (the two halves of each head
rotated, ``rope_theta``), causal softmax at 1/sqrt(head_dim), a SiLU-gated
MLP, each added to the residual; a final RMSNorm and the embedding,
transposed, as the head (``tie_embeddings``).  The norms' scales are
applied where they stand: the program folds them into the next
projection, which this file does not do.

``make_weights`` draws the weights both sides get, on the device, from
the seed, in the type the configuration serves them in.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch

MASK64 = (1 << 64) - 1
NORM_SCALE_STD = 0.1     # the norms' gammas: a fold that is wrong shows


def make_weights(arch: Dict, seed: int, device, dtype=torch.bfloat16,
                 embed_scale: float = 1.0) -> Dict:
    """Every weight, in the program's tree (layers stacked on a leading
    dim), from one generator on ``device`` seeded with ``seed``: one
    call a stacked leaf.  Projections are N(0, 1/fan_in), the embedding
    N(0, (embed_scale / sqrt(d_model))^2), the norms' gammas
    N(0, NORM_SCALE_STD^2)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & MASK64)
    L, D, F, V = (arch["num_layers"], arch["d_model"], arch["d_ff"],
                  arch["vocab"])
    H, Hkv, hd = arch["n_heads"], arch["n_kv_heads"], _head_dim(arch)

    def normal(shape, std):
        w = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return w.mul_(std)

    return {
        "embed": normal((V, D), embed_scale * D ** -0.5),
        "layers": {
            "ln1": normal((L, D), NORM_SCALE_STD),
            "ln2": normal((L, D), NORM_SCALE_STD),
            "attn": {"wq": normal((L, D, H * hd), D ** -0.5),
                     "wk": normal((L, D, Hkv * hd), D ** -0.5),
                     "wv": normal((L, D, Hkv * hd), D ** -0.5),
                     "wo": normal((L, H * hd, D), (H * hd) ** -0.5)},
            "ffn": {"wi_gate": normal((L, D, F), D ** -0.5),
                    "wi_up": normal((L, D, F), D ** -0.5),
                    "wo": normal((L, F, D), F ** -0.5)},
        },
        "ln_f": normal((D,), NORM_SCALE_STD),
    }


def _head_dim(arch: Dict) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["n_heads"]


@contextlib.contextmanager
def full_f32(tf32: bool = False):
    """float32 products in full precision (TF32 off), or in TF32 for
    the control; the previous settings restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (amax to 448), back in float32: the control's precision."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _rms(x, gamma, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1 + gamma)


def _rope(x, pos, theta):
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = pos.float()[:, None] * inv                        # (T, half)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


@torch.no_grad()
def logits(arch: Dict, w: Dict, tokens: torch.Tensor, rows: torch.Tensor,
           control: bool = False) -> torch.Tensor:
    """float32 logits (len(rows), vocab) at positions ``rows`` of the
    sequence ``tokens`` (T,).  ``control``: every projection's operands
    in float8 (the nearest precision below the served bfloat16)."""
    lin = ((lambda x, m: fp8(x, -1) @ fp8(m, 0)) if control
           else (lambda x, m: x @ m))
    L, D = arch["num_layers"], arch["d_model"]
    H, Hkv, hd = arch["n_heads"], arch["n_kv_heads"], _head_dim(arch)
    eps, theta = arch.get("norm_eps", 1e-6), arch.get("rope_theta", 1e4)
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    x = w["embed"][tokens.long()].float()
    if arch.get("scale_embed"):
        x = x * math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    lw = w["layers"]
    for i in range(L):
        h = _rms(x, lw["ln1"][i].float(), eps)
        a = lw["attn"]
        q = lin(h, a["wq"][i].float()).view(T, H, hd)
        k = lin(h, a["wk"][i].float()).view(T, Hkv, hd)
        v = lin(h, a["wv"][i].float()).view(T, Hkv, hd)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        g = H // Hkv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) * hd ** -0.5
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = torch.einsum("hqk,khd->qhd", p, v).reshape(T, H * hd)
        x = x + lin(o, a["wo"][i].float())
        h = _rms(x, lw["ln2"][i].float(), eps)
        f = lw["ffn"]
        gate = lin(h, f["wi_gate"][i].float())
        up = lin(h, f["wi_up"][i].float())
        x = x + lin(gate * torch.sigmoid(gate) * up, f["wo"][i].float())
    x = _rms(x[rows], w["ln_f"].float(), eps)
    head = w["embed"].float().t() if arch.get("tie_embeddings") \
        else w["head"].float()
    return lin(x, head)


def gaps(arch: Dict, w: Dict, served: Sequence, control: bool = False
         ) -> List[float]:
    """For each ``(prompt, tokens)`` served greedily: the widest gap by
    which a served token's reference logit lies below the reference's
    best at its position.  With ``control`` the token at each position
    is the one the float8 control puts first, not the served one."""
    out = []
    with full_f32():
        for prompt, toks in served:
            dev = w["embed"].device
            seq = torch.as_tensor(list(prompt) + list(toks)[:-1],
                                  dtype=torch.long, device=dev)
            rows = torch.arange(len(prompt) - 1, seq.shape[0], device=dev)
            ref = logits(arch, w, seq, rows)
            if control:
                pick = logits(arch, w, seq, rows, control=True).argmax(-1)
            else:
                pick = torch.as_tensor(list(toks), device=dev)
            best = ref.max(-1).values
            got = ref.gather(1, pick[:, None].long())[:, 0]
            out.append(float((best - got).max()))
    return out
