"""Shared building blocks for the LM-family model zoo.

The port of ``repro.models.common``: plain functions on torch tensors
over the reference's param tree.

Conventions (the reference's)
-----------------------------
* params are nested dicts of tensors; per-layer params are stacked on a
  leading ``L`` dim.  Where the reference scans a layer body with
  ``lax.scan``, the port loops over layers in Python and takes a view
  of each layer (:func:`layer_view`).
* the compute dtype is ``cfg.dtype`` (bf16 in every published config),
  params are kept in ``cfg.param_dtype``; every projection is
  ``x @ w.to(x.dtype)`` with an output in ``x``'s dtype; norms, rope,
  the softmax statistics and the logits run in f32, as the reference's.
* the reference's logical-axis annotations and its ``shard_map``
  branches (``tp_psum``) are sharding only: with no mesh it takes the
  plain branch, which is what the port computes.  The sharded forms are
  ROADMAP A.14.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int32": torch.int32,
           "int64": torch.int64}


def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype`` (the reference casts its constants
    to the operand's dtype), as a Python float: a scalar operand needs
    no tensor on the device, whose copy would stall the host."""
    return float(torch.tensor(float(value), dtype=torch.float64)
                 .to(torch_dtype(dtype)))


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``"bfloat16"``)."""
    return str(dtype).split(".")[1]


# ---------------------------------------------------------------------------
# Param trees: nested dicts, flattened depth first in sorted-key order (the
# order ``jax.tree_util`` flattens the reference's dicts in)
# ---------------------------------------------------------------------------
def tree_flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` depth first, keys sorted; paths are
    ``"/"``-joined keys."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_flatten(tree[k], f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(paths: List[str], leaves: List[Any]) -> Dict[str, Any]:
    """Inverse of :func:`tree_flatten`."""
    out: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        *parents, last = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_view(stacked, i: int):
    """Layer ``i`` of an ``L``-stacked param (or cache) tree, as views."""
    return tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# Parameter initialization helpers
# ---------------------------------------------------------------------------
class Init(NamedTuple):
    """Where params are drawn: a ``torch.Generator`` on ``device`` (None on
    the meta device, which allocates nothing)."""
    gen: Optional[torch.Generator]
    device: torch.device

    @classmethod
    def make(cls, seed: int, device) -> "Init":
        device = torch.device(device)
        if device.type == "meta":
            return cls(None, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        return cls(gen, device)


def dense_init(init: Init, shape, fan_in, dtype) -> torch.Tensor:
    """A standard normal drawn in f32, scaled by ``1/sqrt(fan_in)`` and
    cast to ``dtype`` (the reference's ``dense_init``)."""
    dtype = torch_dtype(dtype)
    if init.gen is None:
        return torch.empty(shape, dtype=dtype, device=init.device)
    w = torch.randn(shape, generator=init.gen, dtype=torch.float32,
                    device=init.device)
    w.mul_(float(1.0 / np.sqrt(max(1, fan_in))))
    return w.to(dtype)


def zeros_init(init: Init, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=init.device)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------
def rms_norm(x, gamma, eps):
    """RMSNorm in f32 accumulation, scaled by ``(1 + gamma)``."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps):
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(rounded(theta, torch.float32), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions.float()[..., None] * inv             # (..., S, d/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([(x1 * cos - x2 * sin).to(x.dtype),
                      (x1 * sin + x2 * cos).to(x.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# Attention — flash-style chunked attention in plain torch
# ---------------------------------------------------------------------------
def _cdt(compute_dtype: str) -> torch.dtype:
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def _window(window: int, window_arr) -> int:
    """The reference's traced per-layer ``window_arr`` is a host int in
    the port (layer patterns are static); it wins over ``window``."""
    return int(window_arr) if window_arr is not None else int(window)


def chunked_attention(
    q: torch.Tensor,           # (B, Sq, H, D)
    k: torch.Tensor,           # (B, Sk, Hkv, D)
    v: torch.Tensor,           # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: int = 0,           # 0 = global; >0 = sliding window width
    window_arr=None,           # per-layer window; wins over `window`
    q_offset: int = 0,         # absolute position of q[0] (prefill chunks)
    kv_chunk: int = 1024,
    q_chunk: int = 512,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    compute_dtype: str = "float32",
    causal_skip: bool = False,
) -> torch.Tensor:
    """The reference's ``chunked_attention``: for each block of
    ``q_chunk`` queries, an online softmax over chunks of ``kv_chunk``
    keys in the reference's order, so the working set is bounded by the
    two chunk sizes and the (Sq, Sk) score matrix never exists.

    The reference pads queries and keys to chunk multiples and masks the
    pad; the port cuts the last chunk short, which leaves out the same
    zeros.  A row that no key is visible to gives 0, as the reference's.
    ``causal_skip`` skips on the host the kv chunks that no query of the
    block can see, where the reference branches them away with
    ``lax.cond``: a skipped chunk would have left (m, l, acc) exactly as
    they were."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    w = _window(window, window_arr)
    kv_chunk = min(kv_chunk, sk)
    q_chunk = min(q_chunk, sq)
    cdt = _cdt(compute_dtype)
    # Operands are rounded to the compute dtype, then multiplied in f32:
    # the reference's preferred_element_type=f32 products.
    qg = (q.reshape(b, sq, hkv, g, d).to(cdt) * rounded(scale, cdt)).float()
    out = torch.empty((b, sq, hkv, g, dv), device=q.device)
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        out[:, q0:q1] = _online_softmax(
            qg[:, q0:q1], k, v, q_offset + q0, kv_chunk, causal, w,
            softcap, cdt, causal_skip)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _online_softmax(qg, k, v, q_lo, kv_chunk, causal, w, softcap, cdt,
                    causal_skip):
    """One block of queries (B, C, Hkv, G, D) at absolute positions
    ``q_lo...`` over every kv chunk: the normalized (B, C, Hkv, G, Dv)."""
    b, c, hkv, g, _ = qg.shape
    sk, dv, dev = k.shape[1], v.shape[-1], qg.device
    q_pos = q_lo + torch.arange(c, device=dev)
    q_hi = q_lo + c - 1
    m = torch.full((b, c, hkv, g), float("-inf"), device=dev)
    l = torch.zeros((b, c, hkv, g), device=dev)
    acc = torch.zeros((b, c, hkv, g, dv), device=dev)
    for start in range(0, sk, kv_chunk):
        stop = min(start + kv_chunk, sk)
        if causal_skip and causal:
            visible = start <= q_hi
            if w > 0:
                visible &= not (start + kv_chunk - 1 < q_lo - w + 1)
            if not visible:
                continue
        kc = k[:, start:stop].to(cdt).float()
        vc = v[:, start:stop].to(cdt).float()
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kc)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        k_pos = torch.arange(start, stop, device=dev)
        mask = torch.ones((c, stop - start), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if w > 0:
            mask &= q_pos[:, None] - k_pos[None, :] < w
        mask = mask[None, :, None, None, :]
        s = torch.where(mask, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # rows with no valid key yet keep m = -inf; guard the exp
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        # The row sums of p come out of the same product as p.V (a column
        # of ones beside V): a product's sums do not change with the
        # masked zeros at a chunk's end, where torch.sum's grouping does,
        # and prefill_chunk's chunks end elsewhere than prefill's.
        pv = torch.einsum("bqhgk,bkhd->bqhgd", p,
                          torch.cat([vc, torch.ones_like(vc[..., :1])], -1))
        l = l * alpha + pv[..., dv]
        if cdt != torch.float32:
            pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(cdt).float(), vc)
        acc = acc * alpha[..., None] + pv[..., :dv]
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return acc / l[..., None]


def decode_attention_jnp(
    q: torch.Tensor,         # (B, H, D) — one new token per sequence
    k_cache: torch.Tensor,   # (B, S, Hkv, D)
    v_cache: torch.Tensor,   # (B, S, Hkv, Dv)
    lengths: torch.Tensor,   # (B,) valid context length per sequence
    *,
    window: int = 0,
    window_arr=None,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Single-token attention against a KV cache: the reference's
    ``decode_attention_jnp`` (its name kept), one softmax over the whole
    cache.  The products run one batch row at a time, so the cache is
    read in place (a (B, Hkv) batch of it is not a strided matrix
    batch) and only one row's copy in the compute dtype exists at once."""
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    w = _window(window, window_arr)
    cdt = _cdt(compute_dtype)
    qg = (q.reshape(b, hkv, g, d).to(cdt) * rounded(scale, cdt)).float()
    # K as (Hkv, S, D) times q as (Hkv, D, G): S is the long side of the
    # product and each key row is read whole.
    scores = torch.stack([
        torch.bmm(k_cache[i].to(cdt).float().permute(1, 0, 2),
                  qg[i].transpose(1, 2)).transpose(1, 2)
        for i in range(b)])                               # (B, Hkv, G, S)
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if w > 0:
        valid &= pos >= (lengths[:, None] - w)
    scores = torch.where(valid[:, None, None, :], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(cdt).float()
    out = torch.stack([_pv(p[i], v_cache[i].to(cdt).float())
                       for i in range(b)])                # (B, Hkv, G, Dv)
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


#: Keys per part of a long p.V product (see :func:`_pv`).
PV_SPLIT = 1024


def _pv(p, v):
    """p (Hkv, G, S) times v (S, Hkv, Dv) -> (Hkv, G, Dv).  A product
    over S keys for G (2-16) rows is one long dot per output, which
    cuBLAS runs at a small share of an H100's bandwidth (at qwen2.5-14b's
    widths and S=32768: ``benchmarks/engine_attention_torch.py``); cut
    into parts of PV_SPLIT keys, each part one matrix of a batched
    product, and the parts summed, it runs at several times that."""
    hkv, g, s = p.shape
    v = v.permute(1, 0, 2)                                # (Hkv, S, Dv)
    if s <= PV_SPLIT or s % PV_SPLIT:
        return torch.bmm(p, v)
    n, dv = s // PV_SPLIT, v.shape[-1]
    pp = p.reshape(hkv, g, n, PV_SPLIT).transpose(1, 2)
    parts = torch.bmm(pp.reshape(hkv * n, g, PV_SPLIT),
                      v.reshape(hkv * n, PV_SPLIT, dv))
    return parts.reshape(hkv, n, g, dv).sum(dim=1)


def ring_insert(cache: torch.Tensor, new: torch.Tensor,
                pos: torch.Tensor, mode: str = "where") -> torch.Tensor:
    """Write ``new`` (B, ...) into ``cache`` (B, S, ...) at slot
    ``pos % S`` per batch element, in place, and return ``cache``.  When
    S covers the whole context the slot equals the absolute position;
    when S is a sliding window the ring overwrite is the eviction.

    mode="where" rewrites the whole cache through a select (the
    reference's baseline: a cache-sized read and write); mode="scatter"
    writes only the row.  The values are equal."""
    b, s = cache.shape[:2]
    slot = torch.remainder(pos.long(), s)
    new = new.to(cache.dtype)
    if mode == "scatter":
        cache[torch.arange(b, device=cache.device), slot] = new
        return cache
    oh = torch.arange(s, device=cache.device)[None, :] == slot[:, None]
    oh = oh.reshape(b, s, *([1] * (cache.ndim - 2)))
    torch.where(oh, new[:, None], cache, out=cache)
    return cache


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    return F.embedding(tokens.long(), table).to(torch_dtype(dtype))


def lm_logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """x: (B,S,D) @ head: (D,V) -> (B,S,V); f32 logits."""
    return torch.matmul(x.float(), head.float())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) f32, labels (B,S) int."""
    m = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(m, -1, labels.long().clamp(min=0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ---------------------------------------------------------------------------
# Projections (the reference's single-device branch)
# ---------------------------------------------------------------------------
def row_parallel_out(h, w):
    """y = h @ w in h's dtype."""
    return torch.matmul(h, w.to(h.dtype))


def col_parallel_in(x, weights):
    """[x @ w for w in weights], each in x's dtype."""
    return [torch.matmul(x, w.to(x.dtype)) for w in weights]


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU family)
# ---------------------------------------------------------------------------
def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, with the sigmoid as XLA expands
    it, ``1 / (1 + exp(-x))``, one op at a time in x's dtype (in bf16
    each op rounds, as the reference's does)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def gelu_tanh(x):
    """``jax.nn.gelu(approximate=True)``, its formula op by op in x's
    dtype, with its constants in that dtype."""
    c = rounded(np.sqrt(2 / np.pi), x.dtype)
    a = rounded(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x))))
    return x * cdf


def activation(name: str):
    if name == "silu":
        return silu
    if name == "gelu":
        return gelu_tanh
    raise NotImplementedError(name)


def gated_mlp(x, wi_gate, wi_up, wo, act: str = "silu"):
    """x: (B,S,D); wi_*: (D,F); wo: (F,D)."""
    h_gate, h_up = col_parallel_in(x, (wi_gate, wi_up))
    h = activation(act)(h_gate) * h_up
    return row_parallel_out(h, wo)


def mlp_init(init: Init, lead, d_model, d_ff, dtype):
    """Gated-MLP params, each with ``lead`` (e.g. ``(L,)``) in front."""
    return {
        "wi_gate": dense_init(init, (*lead, d_model, d_ff), d_model, dtype),
        "wi_up": dense_init(init, (*lead, d_model, d_ff), d_model, dtype),
        "wo": dense_init(init, (*lead, d_ff, d_model), d_ff, dtype),
    }
