"""Shared building blocks for the LM-family model zoo.

The port of ``repro.models.common``: plain functions on torch tensors
over the reference's param tree.

Conventions (the reference's)
-----------------------------
* params are nested dicts of tensors; per-layer params are stacked on a
  leading ``L`` dim.  Where the reference scans a layer body with
  ``lax.scan``, the port loops over layers in Python over views of each
  layer (:func:`layer_views`), the body under :func:`maybe_remat` where
  the reference's scan has it.
* the compute dtype is ``cfg.dtype`` (bf16 in every published config),
  params are kept in ``cfg.param_dtype``; every projection is
  ``x @ w.to(x.dtype)`` with an output in ``x``'s dtype; norms, rope,
  the softmax statistics and the logits run in f32, as the reference's.
* the reference's logical-axis annotations split compute where they
  would let GSPMD split it, written out: in the mesh train step on a
  mesh with a ``model`` axis (``distributed.sharding.model_part``) the
  projections take this rank's heads, MLP columns or vocab rows
  (:func:`col_parallel_in`, :func:`row_parallel_out`,
  :func:`gated_mlp`, :func:`embed_tokens`, :func:`lm_logits`,
  :func:`cross_entropy`), the params it holds in part gathered at use
  (:func:`layer_views`).  In serving the reference's ``shard_map``
  branches are written out: under ``tp_psum`` on a live mesh with a
  ``model`` axis the row- and column-parallel projections contract this
  rank's part of the ``mlp``/``heads`` dim and combine the parts over
  ``model``.  With no mesh every product is the plain one;
* a row's result must not depend on how many rows share the call: a
  serve decode step runs at its batch bucket's row count, and on the
  H100 the norms' f32 reductions and the f32 head product round some
  rows differently at fewer rows (the bf16 projections do not:
  ``chip_smoke.py``'s ``row_probe`` and ``step_probe``).  Under
  :func:`step_rows` the norms and the logits run at a fixed row count
  (zero rows padded, their results dropped), so every bucket rounds as
  the full-slots step does.
"""

from __future__ import annotations

import contextlib
import math
import threading
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


def layer_views(stacked, n: int):
    """The ``n`` layers of an ``L``-stacked param (or cache) tree, in
    order, each a tree of views.  A leaf that autograd records is split
    by one ``torch.unbind``, whose backward stacks the layers' gradients
    once; ``t[i]``'s backward would add a zero-filled ``(L, ...)``
    gradient for every layer.  Any other leaf is indexed: a cache is
    written in place, which unbind's views refuse under autograd.  In the
    mesh train step a leaf the rank holds in part gives its layers'
    parts, which :func:`maybe_remat` gathers inside each layer's body
    (``distributed.sharding.current_gather``); in the partitioned serving
    program (no autograd) layer ``i`` is gathered when it is indexed, so
    one layer's gathered params live at a time."""
    from ..distributed.sharding import current_gather
    gather = current_gather()
    owned = []

    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        if gather is not None and gather.owns(t):
            owned.append(t)
            return gather.layers(t, n)
        if torch.is_grad_enabled() and t.requires_grad:
            return torch.unbind(t, 0)
        return [t[i] for i in range(n)]

    parts = split(stacked)
    if owned and not torch.is_grad_enabled():
        return _LayersAtUse(parts, n, gather)
    return [_pick(parts, i) for i in range(n)]


def _pick(parts, i):
    if isinstance(parts, dict):
        return {k: _pick(v, i) for k, v in parts.items()}
    return parts[i]


class _LayersAtUse:
    """The layers of :func:`layer_views` where no autograd records (the
    partitioned serving program): layer ``i``'s parts gathered whole when
    it is indexed.  A layer's tree holds its params until the next layer
    is indexed, which empties it, so the layer loop's variable does not
    keep one layer's gathered params alive while the next is gathered."""

    def __init__(self, parts, n: int, gather) -> None:
        self.parts, self.n, self.gather = parts, n, gather
        self._last = None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        if not 0 <= i < self.n:
            raise IndexError(i)
        _clear(self._last)
        self._last = self.gather.at_use(_pick(self.parts, i))
        return self._last


def _clear(tree) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _clear(v)
        tree.clear()


def maybe_remat(cfg, fn):
    """The activation-checkpoint policy of a layer body (training), the
    reference's ``maybe_remat``: ``"full"`` recomputes the body in
    backward, ``"dots"`` saves the outputs of its matrix products and
    recomputes the rest, ``"none"`` (or anything else) saves all.  Only
    while autograd records: serving and the captured decode steps run
    ``fn`` itself.  In the mesh train step the body first gathers the
    layer's params from the rank's parts (:func:`layer_views`), so a
    recompute gathers them again rather than keep them."""
    remat = cfg.remat in ("full", "dots")

    def run(*args):
        from ..distributed.sharding import (current_context, current_gather,
                                            use_context)
        gather = current_gather()
        if not torch.is_grad_enabled() or not (remat or gather):
            return fn(*args)
        from torch.utils.checkpoint import checkpoint
        ctx = current_context()

        def body(*a):
            # the recompute may run on autograd's device thread: it sees
            # the mesh (and the rows' placement) of the forward
            with use_context(ctx):
                return fn(*(a if gather is None else gather.at_use(a)))
        if not remat:
            return body(*args)
        kw = {"context_fn": _save_dots} if cfg.remat == "dots" else {}
        # the layers draw no random numbers, so no RNG state is kept
        return checkpoint(body, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return run


def _save_dots():
    """Selective checkpointing that saves matrix products' outputs."""
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.bmm.default, aten.matmul.default])


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


def ones_init(init: Init, shape, dtype) -> torch.Tensor:
    return torch.ones(shape, dtype=torch_dtype(dtype), device=init.device)


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------
_ROWS = threading.local()


@contextlib.contextmanager
def step_rows(rows: int):
    """Within the block, the norms and :func:`lm_logits` run on at
    least ``rows`` rows (the leading dims flattened): fewer are padded
    with zero rows, whose results are dropped.  Per thread, so a bucket
    captured in the background sets its own."""
    prev = getattr(_ROWS, "n", 0)
    _ROWS.n = int(rows)
    try:
        yield
    finally:
        _ROWS.n = prev


def _at_rows(fn, x, *rest):
    """``fn(x, *rest)``, with x's rows padded to :func:`step_rows`'
    count and the result cut back (fn maps rows to rows)."""
    want = getattr(_ROWS, "n", 0)
    lead = x.shape[:-1]
    m = math.prod(lead)
    if m >= want:
        return fn(x, *rest)
    y = fn(F.pad(x.reshape(m, x.shape[-1]), (0, 0, 0, want - m)), *rest)
    return y[:m].reshape(*lead, y.shape[-1])


def rms_norm(x, gamma, eps):
    """RMSNorm in f32 accumulation, scaled by ``(1 + gamma)``."""
    return _at_rows(_rms_norm, x, gamma, eps)


def _rms_norm(x, gamma, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps):
    """LayerNorm in f32 accumulation (at :func:`step_rows`' row count,
    like :func:`rms_norm`)."""
    return _at_rows(_layer_norm, x, gamma, beta, eps)


def _layer_norm(x, gamma, beta, eps):
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
    q_offset=0,                # absolute position of q[0] (prefill chunks)
    kv_chunk: int = 1024,
    q_chunk: int = 512,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    compute_dtype: str = "float32",
    causal_skip: bool = False,
    visible_chunks: Optional[int] = None,
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
    they were.

    ``q_offset`` may be a 0-d integer tensor on the device (the captured
    chunk program's ``start``, the reference's traced scalar): the query
    positions are then made on the device, and nothing depends on its
    value on the host.  Skipping does, so ``causal_skip`` with such an
    offset takes ``visible_chunks``, the count of leading kv chunks the
    call's last query can see, which the caller works out on the host:
    every chunk after them is skipped, every one of them visited, for
    all query blocks.  A visited chunk that no query sees leaves (m, l,
    acc) exactly as they were too (its p is 0), so the result is the
    unskipped pass's bit for bit.  Given with a host offset, the count
    replaces the per-block rule."""
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
    skip = causal_skip and causal
    if skip and visible_chunks is None and isinstance(q_offset,
                                                      torch.Tensor):
        raise ValueError("causal_skip with a device q_offset needs "
                         "visible_chunks, worked out on the host")
    qg = (q.reshape(b, sq, hkv, g, d).to(cdt) * rounded(scale, cdt)).float()
    out = torch.empty((b, sq, hkv, g, dv), device=q.device)
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        out[:, q0:q1] = _online_softmax(
            qg[:, q0:q1], k, v, q_offset + q0, kv_chunk, causal, w,
            softcap, cdt, skip, visible_chunks)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _online_softmax(qg, k, v, q_lo, kv_chunk, causal, w, softcap, cdt,
                    skip, visible_chunks):
    """One block of queries (B, C, Hkv, G, D) at absolute positions
    ``q_lo...`` (a host int or a device scalar) over every kv chunk it
    may see: the normalized (B, C, Hkv, G, Dv)."""
    b, c, hkv, g, _ = qg.shape
    sk, dv, dev = k.shape[1], v.shape[-1], qg.device
    q_pos = q_lo + torch.arange(c, device=dev)
    m = torch.full((b, c, hkv, g), float("-inf"), device=dev)
    l = torch.zeros((b, c, hkv, g), device=dev)
    acc = torch.zeros((b, c, hkv, g, dv), device=dev)
    for start in range(0, sk, kv_chunk):
        stop = min(start + kv_chunk, sk)
        if skip and visible_chunks is not None:
            if start >= visible_chunks * kv_chunk:
                break
        elif skip:
            visible = start <= q_lo + c - 1
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
    heads=None,
    seq=None,
) -> torch.Tensor:
    """Single-token attention against a KV cache: the reference's
    ``decode_attention_jnp`` (its name kept), one softmax over the whole
    cache.  The products run one batch row at a time, so the cache is
    read in place (a (B, Hkv) batch of it is not a strided matrix
    batch) and only one row's copy in the compute dtype exists at once.

    In the partitioned serving program ``heads`` is this rank's range of
    the query heads (``sharding.Part``; q holds those heads, and so does
    the output) and ``seq`` the range of positions the rank's cache part
    holds (``sharding.held_range``; None: the whole sequence).  With
    ``seq`` it is the reference's flash-decoding layout, which GSPMD
    makes of the cache's ``kv_seq`` constraint: q gathered whole over
    ``model``, the rank's part scored, the softmax's max and its f32 sum
    reduced over ``model``, and the f32 partial ``p·v`` summed over it
    (:func:`_flash_decode`).  Without, the rank's heads attend the whole
    cache, or the KV heads it holds of it (``kv_heads`` over ``model``),
    with no collective."""
    if seq is not None:
        return _flash_decode(q, k_cache, v_cache, lengths, heads, seq,
                             _window(window, window_arr), scale, softcap,
                             compute_dtype)
    if heads is not None:
        k_cache, v_cache = _kv_of(heads, k_cache, v_cache)
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    w = _window(window, window_arr)
    cdt = _cdt(compute_dtype)
    qg = (q.reshape(b, hkv, g, d).to(cdt) * rounded(scale, cdt)).float()
    scores = _scores(k_cache, qg, cdt, softcap)           # (B, Hkv, G, S)
    valid = _valid(torch.arange(s, device=q.device)[None, :], lengths, w)
    scores = torch.where(valid[:, None, None, :], scores, float("-inf"))
    p = torch.softmax(scores, dim=-1).to(cdt).float()
    out = torch.stack([_pv(p[i], v_cache[i].to(cdt).float())
                       for i in range(b)])                # (B, Hkv, G, Dv)
    return out.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


def _scores(k_cache, qg, cdt, softcap):
    """The f32 scores (B, Hkv, G, S) of qg (B, Hkv, G, D) against each
    row's keys.  K as (Hkv, S, D) times q as (Hkv, D, G): S is the long
    side of the product and each key row is read whole."""
    scores = torch.stack([
        torch.bmm(k_cache[i].to(cdt).float().permute(1, 0, 2),
                  qg[i].transpose(1, 2)).transpose(1, 2)
        for i in range(qg.shape[0])])
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    return scores


def _valid(pos, lengths, w):
    """(B, S) whether the positions ``pos`` (1, S) are context: before
    ``lengths`` and, for a sliding window ``w``, within it."""
    valid = pos < lengths[:, None]
    if w > 0:
        valid &= pos >= (lengths[:, None] - w)
    return valid


def _kv_of(heads, k, v):
    """The KV heads (dim 2) of ``k`` and ``v`` that the query heads
    ``heads`` read, laid out as :func:`grouped_kv` lays them: k and v as
    they are where they hold only this rank's KV heads already (the
    cache's ``kv_heads`` over ``model``), else those of every KV head."""
    from ..distributed.sharding import held_range, kv_ranges
    if held_range(k, 2) is not None:
        return k, v
    hkv = k.shape[2]
    lo, hi = kv_ranges(heads.n, hkv, heads.k)[heads.i]
    return grouped_kv(heads, heads.n // hkv, k.narrow(2, lo, hi - lo),
                      v.narrow(2, lo, hi - lo))


def grouped_kv(heads, g: int, k, v):
    """k and v (B, S, Hkv_local, D), the KV heads the query heads
    ``heads`` (a ``sharding.Part``, ``g`` to a KV head) read, laid out
    for them: as they are where the query heads fall into whole groups
    of their KV heads, else one KV head per query head (the one it
    reads)."""
    kv_lo = heads.lo // g
    idx = [(heads.lo + j) // g - kv_lo for j in range(heads.size)]
    n_kv = k.shape[2]
    per = heads.size // n_kv
    if heads.size % n_kv == 0 and idx == [j // per
                                          for j in range(heads.size)]:
        return k, v
    from ..dist.collectives import take
    return take(k, 2, idx), take(v, 2, idx)


def _flash_decode(q, k_cache, v_cache, lengths, heads, seq, w, scale,
                  softcap, compute_dtype):
    """:func:`decode_attention_jnp` over the rank's part ``seq`` of the
    cache's positions (every KV head), as the reference's GSPMD program
    partitions it: q (this rank's ``heads``, or every head) gathered
    over ``model``, the part's scores masked at their absolute
    positions, the max and the f32 sum of ``exp`` reduced over
    ``model``, p normalised here and rounded to the compute dtype, the
    f32 ``p·v`` partials summed over ``model``; the rank's heads of the
    result, in q's dtype."""
    from ..dist.collectives import all_max, all_reduce, gather_part
    from ..distributed.sharding import current_mesh
    mesh, ax = current_mesh(), ("model",)
    if heads is not None:
        q = gather_part(q, ax, mesh, 1, heads.n)
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    cdt = _cdt(compute_dtype)
    qg = (q.reshape(b, hkv, g, d).to(cdt) * rounded(scale, cdt)).float()
    scores = _scores(k_cache, qg, cdt, softcap)           # (B, Hkv, G, S)
    pos = seq.lo + torch.arange(s, device=q.device)[None, :]
    valid = _valid(pos, lengths, w)[:, None, None, :]
    scores = torch.where(valid, scores, float("-inf"))
    m = all_max(scores.amax(dim=-1, keepdim=True), ax, mesh)
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.where(valid, torch.exp(scores - m), 0.0)
    total = all_reduce(e.sum(dim=-1, keepdim=True), ax, mesh)
    p = (e / total).to(cdt).float()
    out = torch.stack([_pv(p[i], v_cache[i].to(cdt).float())
                       for i in range(b)])                # (B, Hkv, G, Dv)
    out = all_reduce(out, ax, mesh).reshape(b, h, v_cache.shape[-1])
    if heads is not None:
        out = out.narrow(1, heads.lo, heads.size)
    return out.to(q.dtype)


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
    when S is a sliding window the ring overwrite is the eviction.  In
    the partitioned serving program a cache that holds only this rank's
    part of the positions (``sharding.held_range``) is written only on
    the rank whose part holds the slot.

    mode="where" rewrites the whole cache through a select (the
    reference's baseline: a cache-sized read and write); mode="scatter"
    writes only the row.  The values are equal."""
    from ..distributed.sharding import held_range
    b, s = cache.shape[:2]
    part = held_range(cache, 1)
    lo, n = (0, s) if part is None else (part.lo, part.n)
    slot = torch.remainder(pos.long(), n) - lo
    new = new.to(cache.dtype)
    if mode == "scatter":
        rows = torch.arange(b, device=cache.device)
        if part is None:
            cache[rows, slot] = new
            return cache
        inside = ((slot >= 0) & (slot < s)).reshape(
            b, *([1] * (new.ndim - 1)))
        at = slot.clamp(0, s - 1)
        cache[rows, at] = torch.where(inside, new, cache[rows, at])
        return cache
    oh = torch.arange(s, device=cache.device)[None, :] == slot[:, None]
    oh = oh.reshape(b, s, *([1] * (cache.ndim - 2)))
    torch.where(oh, new[:, None], cache, out=cache)
    return cache


def whole_len(cache) -> int:
    """The positions of a layer's cache (B, S, ...): S, or the whole
    sequence's where the cache holds this rank's part of it."""
    from ..distributed.sharding import whole_dim
    return whole_dim(cache, 1)


def cache_seq(cache):
    """This rank's range of a layer's cache positions (B, S, ...) where
    it holds only that part (``kv_seq`` over ``model``), else None."""
    from ..distributed.sharding import held_range
    return held_range(cache, 1)


def kv_insert(cache, new, pos, mode, heads=None):
    """:func:`ring_insert` of one token's K or V (B, Hkv_local, D) into a
    layer's cache.  In the partitioned serving program ``new`` holds the
    KV heads of this rank's query heads ``heads`` (a ``sharding.Part`` of
    query heads; None: every KV head): they are gathered over
    ``model`` first unless the cache holds only those (``kv_heads`` over
    ``model``)."""
    if heads is not None:
        from ..distributed.sharding import held_range
        if held_range(cache, 2) is None:
            new = gather_heads(new, heads, cache.shape[2], 1)
    return ring_insert(cache, new, pos, mode)


def gather_heads(t, heads, n_kv: int, dim: int):
    """Every one of ``n_kv`` KV heads along ``dim`` from each rank's
    (``sharding.kv_ranges`` of the query heads' split ``heads``), this
    rank's ``t``."""
    from ..dist.collectives import gather_units
    from ..distributed.sharding import current_mesh, kv_ranges
    return gather_units(t, ("model",), current_mesh(), dim,
                        kv_ranges(heads.n, n_kv, heads.k), n_kv)


def kv_fill(dst, t, fit, heads=None):
    """Fill a layer's cache ``dst`` (B, S, Hkv, D) from a prompt's K or V
    ``t`` (B, s, Hkv_local, D) with ``fit(dst, t)`` (the family's rule
    for a prompt shorter or longer than the cache).  In the partitioned
    serving program ``t`` holds the KV heads of this rank's query heads
    ``heads`` (None: every KV head) and ``dst`` what the cache's
    placement gives the rank: its part of the positions (``kv_seq``),
    filled from every rank's heads by an all-to-all
    (``collectives.exchange``), its KV heads (``kv_heads``), or the whole,
    the heads gathered over ``model``."""
    from ..distributed.sharding import held_range
    seq = held_range(dst, 1)
    if held_range(dst, 2) is not None or (seq is None and heads is None):
        fit(dst, t)
        return dst
    whole = t.new_empty((t.shape[0], seq.n if seq else dst.shape[1],
                         *t.shape[2:]))
    fit(whole, t)
    if seq is None:
        dst.copy_(gather_heads(whole, heads, dst.shape[2], 2))
    elif heads is None:
        dst.copy_(whole.narrow(1, seq.lo, seq.size))
    else:
        from ..dist.collectives import exchange
        from ..distributed.sharding import current_mesh, kv_ranges
        dst.copy_(exchange(whole, ("model",), current_mesh(), 1, 2,
                           kv_ranges(heads.n, dst.shape[2], heads.k),
                           dst.shape[2]))
    return dst


def read_channels(state, part=None):
    """A recurrent state ``state`` (its channels last) for a computation
    over the channels ``part`` (a ``sharding.Part``; None: every
    channel): ``state`` as it is where it holds those already, its part
    of a whole state, or the whole gathered from each rank's equal part
    (the placement's ``mlp`` over ``model``) where the computation needs
    every channel."""
    from ..distributed.sharding import held_range
    held = held_range(state, -1)
    if held is None:
        return state if part is None else state.narrow(-1, part.lo,
                                                       part.size)
    if part is not None:
        return state
    from ..dist.collectives import all_gather
    from ..distributed.sharding import current_mesh
    return all_gather(state, ("model",), current_mesh(), -1)


def store_channels(dst, value, part=None):
    """Write ``value``, the channels ``part`` of a recurrent state (None:
    every channel), into the cache view ``dst``: its equal part where
    ``dst`` holds only that, else the whole, gathered from each rank's
    range over ``model``."""
    from ..distributed.sharding import held_range
    held = held_range(dst, -1)
    if held is not None:
        if part is None:
            value = value.narrow(-1, held.lo, held.size)
        elif part != held:
            raise ValueError(f"a state held as {held} cannot take {part}")
    elif part is not None:
        from ..dist.collectives import gather_part
        from ..distributed.sharding import current_mesh
        value = gather_part(value, ("model",), current_mesh(), -1, part.n)
    dst.copy_(value)
    return dst


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    """The rows of ``table`` (V, D) the tokens name, in ``dtype``.  Where
    compute is split over ``model`` each rank looks up the tokens in its
    vocab rows (zero elsewhere) and the rows are summed over ``model``:
    one nonzero term each, so the result is the whole lookup's."""
    from ..distributed.sharding import model_part, whole_dim
    part = model_part(whole_dim(table, 0))
    if part is None:
        return F.embedding(tokens.long(), table).to(torch_dtype(dtype))
    from ..dist.collectives import reduce_from_model
    from ..distributed.sharding import current_mesh, split_param
    t = tokens.long() - part.lo
    inside = ((t >= 0) & (t < part.size))[..., None]
    rows = F.embedding(t.clamp(0, part.size - 1),
                       split_param(table, 0, part)).to(torch_dtype(dtype))
    return reduce_from_model(torch.where(inside, rows, 0.0), ("model",),
                             current_mesh())


def lm_logits(x: torch.Tensor, head: torch.Tensor,
              tied: bool = False) -> torch.Tensor:
    """x: (B,S,D) @ head: (D,V) -> (B,S,V); f32 logits.  ``tied``: head
    is the embedding table (V, D), used transposed.  Where compute is
    split over ``model`` the logits are this rank's vocab columns
    (:func:`cross_entropy` takes them so)."""
    from ..distributed.sharding import model_part, whole_dim
    part = model_part(whole_dim(head, 0 if tied else -1))
    if part is not None:
        from ..dist.collectives import copy_to_model
        from ..distributed.sharding import current_mesh, split_param
        head = split_param(head, 0 if tied else -1, part)
        x = copy_to_model(x, ("model",), current_mesh())
    if tied:
        head = head.T
    return _at_rows(lambda a: torch.matmul(a.float(), head.float()), x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1, count=None, vocab=None
                  ) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) f32, labels (B,S) int.
    ``count``: the number of unmasked labels to divide by (default:
    these labels'; the mesh train step gives its global batch's share).
    ``vocab``: V, where compute may be split over ``model``; then the
    logits are this rank's vocab columns (:func:`lm_logits`) and the
    softmax is vocab-parallel: the max over ``model`` (no gradient), the
    sum of ``exp`` and the label's logit, from the rank that holds it,
    summed over ``model``."""
    from ..distributed.sharding import model_part
    part = None if vocab is None else model_part(vocab)
    mask = (labels != ignore_id).float()
    if count is None:
        count = torch.clamp(torch.sum(mask), min=1.0)
    if part is None:
        m = torch.log_softmax(logits, dim=-1)
        ll = torch.gather(m, -1, labels.long().clamp(min=0)[..., None])[..., 0]
        return -torch.sum(ll * mask) / count
    from ..dist.collectives import all_max, reduce_from_model
    from ..distributed.sharding import current_mesh
    mesh, ax = current_mesh(), ("model",)
    z = logits - all_max(logits.amax(dim=-1, keepdim=True), ax, mesh)
    total = reduce_from_model(torch.sum(torch.exp(z), dim=-1), ax, mesh)
    t = labels.long() - part.lo
    inside = (t >= 0) & (t < part.size)
    mine = torch.gather(z, -1, t.clamp(0, part.size - 1)[..., None])[..., 0]
    label = reduce_from_model(torch.where(inside, mine, 0.0), ax, mesh)
    ll = label - torch.log(total)
    return -torch.sum(ll * mask) / count


# ---------------------------------------------------------------------------
# Row- and column-parallel projections
# ---------------------------------------------------------------------------
def row_parallel_out(h, w, tp_psum: bool = False, part=None):
    """y = h @ w in h's dtype, where h's last dim is the model-sharded
    one (row-parallel).  This rank contracts its range ``part`` of that
    dim with the same rows of ``w``, and the partial products (each in
    h's dtype) are summed over ``model``: in h's dtype under ``tp_psum``
    (the reference's ``shard_map`` pins it), else in f32 and rounded
    once (the reference's GSPMD program sinks the reduce past the norm's
    f32 convert).  Under autograd the sum passes the output's gradient on
    to every rank's part.

    ``part`` is the mesh train step's (``sharding.model_part``), h this
    rank's range.  Without it, under ``tp_psum`` on a live mesh (serving)
    the range is the rank's equal part (``sharding.psum_parts``), h whole
    or already that part, as :func:`col_parallel_in` gives it; else the
    plain product."""
    from ..distributed.sharding import (current_mesh, psum_parts, split_param,
                                        whole_dim)
    n = whole_dim(w, 0)
    if part is None:
        parts = psum_parts(tp_psum, (n,))
        if parts is None:
            return torch.matmul(h, w.to(h.dtype))
        part, = parts
    from ..dist.collectives import reduce_from_model, split_to_model
    mesh = current_mesh()
    if h.shape[-1] == n:
        h = split_to_model(h, ("model",), mesh, -1)
    y = torch.matmul(h, split_param(w, 0, part).to(h.dtype))
    if tp_psum:
        return reduce_from_model(y, ("model",), mesh)
    return reduce_from_model(y.float(), ("model",), mesh).to(h.dtype)


def col_parallel_in(x, weights, tp_psum: bool = False, parts=None):
    """[x @ w for w in weights], each in x's dtype (column-parallel): each
    output is this rank's range of its weight's columns, and only
    :func:`row_parallel_out` reduces.  Under autograd x's gradient, each
    range's part of it, is summed over ``model``.

    ``parts`` (the mesh train step): for each weight, this rank's range
    of its columns (``sharding.model_part``), or None for every column.
    Without a range, under ``tp_psum`` on a live mesh (serving) each
    output is this rank's equal part of its columns
    (``sharding.psum_parts``), as the reference's ``out_specs`` keep it:
    a consumer that needs the outputs whole calls it without
    ``tp_psum``; else the plain products."""
    from ..distributed.sharding import (current_mesh, psum_parts, split_param,
                                        whole_dim)
    if parts is None or all(p is None for p in parts):
        parts = psum_parts(tp_psum, [whole_dim(w, -1) for w in weights])
        if parts is None:
            return [torch.matmul(x, w.to(x.dtype)) for w in weights]
    from ..dist.collectives import copy_to_model
    xs = copy_to_model(x, ("model",), current_mesh())
    return [torch.matmul(x, w.to(x.dtype)) if p is None else
            torch.matmul(xs, split_param(w, -1, p).to(x.dtype))
            for w, p in zip(weights, parts)]


def column_part(t, part):
    """The range ``part`` of ``t``'s last dim (a column-parallel output's
    bias, a per-channel weight), recorded as a cut; ``t`` with no
    ``part``."""
    if part is None:
        return t
    from ..distributed.sharding import split_param
    return split_param(t, -1, part)


def shared_part(t):
    """``t``, a tensor every ``model`` rank holds whole, as the input of
    a computation that compute split over ``model`` reads per rank (a
    norm's scale over a rank's heads): its gradient is summed over
    ``model``.  ``t`` itself where compute is not split."""
    from ..distributed.sharding import current_mesh, model_split
    if model_split() is None:
        return t
    from ..dist.collectives import copy_to_model
    return copy_to_model(t, ("model",), current_mesh())


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


def gated_mlp(x, wi_gate, wi_up, wo, act: str = "silu",
              tp_psum: bool = False):
    """x: (B,S,D); wi_*: (D,F); wo: (F,D).  In the mesh train step each
    rank computes its range of the ``mlp`` columns."""
    from ..distributed.sharding import model_part, whole_dim
    part = model_part(whole_dim(wi_gate, -1))
    h_gate, h_up = col_parallel_in(x, (wi_gate, wi_up), tp_psum,
                                   parts=(part, part))
    h = activation(act)(h_gate) * h_up
    return row_parallel_out(h, wo, tp_psum, part)


def mlp_init(init: Init, lead, d_model, d_ff, dtype):
    """Gated-MLP params, each with ``lead`` (e.g. ``(L,)``) in front."""
    return {
        "wi_gate": dense_init(init, (*lead, d_model, d_ff), d_model, dtype),
        "wi_up": dense_init(init, (*lead, d_model, d_ff), d_model, dtype),
        "wo": dense_init(init, (*lead, d_ff, d_model), d_ff, dtype),
    }


def mlp_axes():
    """Logical axes of :func:`mlp_init`'s params (per layer)."""
    return {
        "wi_gate": ("fsdp", "mlp"),
        "wi_up": ("fsdp", "mlp"),
        "wo": ("mlp", "fsdp"),
    }


def stack_axes(tree):
    """``tree`` of logical-axis tuples with ``"layers"`` in front of
    each (the axes of an ``L``-stacked param tree)."""
    return tree_map(lambda ax: ("layers",) + ax, tree)
