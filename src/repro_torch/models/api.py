"""Model API — one surface over the architecture families.

The port of ``repro.models.api``.  ``get_model(cfg)`` returns a
``Model`` whose methods dispatch to the family implementation:

    init(seed, device)                  -> params (nested dict of tensors)
    forward(params, batch)              -> (logits, extras)
    init_cache(batch, max_len, device)  -> cache
    prefill(params, batch, cache)       -> (logits, cache)
    decode_step(params, cache, tokens)  -> (logits, cache)
    prefill_chunk(params, tokens, cache, start, length) -> (logits, cache)
    loss(params, batch)                 -> scalar loss   [train]

All six families are ported: ``dense``, ``moe`` and ``vlm``
(``transformer``), ``ssm`` (``ssm``, mamba2), ``hybrid`` (``rglru``,
recurrentgemma) and ``audio`` (``whisper``, whose ``forward`` and
``prefill`` take the ``frames`` input).  ``param_axes()`` and
``cache_axes()`` give the reference's logical-axis trees.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import common as C
from . import rglru, ssm, transformer, whisper

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": ssm,
    "hybrid": rglru,
    "audio": whisper,
}


def _as_tensor(v, device):
    return v if v is None else torch.as_tensor(v, device=device)


def _batch_share(labels, ignore_id: int = -1):
    """In the mesh train step (each rank holds its rows of the batch):
    the global batch's unmasked labels over the number of row parts, so
    that the mean over ranks of each rank's cross-entropy is the global
    batch's mean (each rank's own count where the counts are equal);
    else None (these labels' count)."""
    from ..distributed.sharding import BATCH_AXES, local_batch
    split = local_batch()
    if split is None:
        return None
    from ..dist.collectives import reduce_from_model
    mesh, k, _ = split
    n = torch.sum((labels != ignore_id).float()).detach()
    return torch.clamp(reduce_from_model(n, BATCH_AXES, mesh), min=1.0) / k


class _FirstShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        from ..dist.collectives import broadcast
        from ..distributed.sharding import BATCH_AXES
        return broadcast(x.detach(), BATCH_AXES, mesh, 0)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _first_shard(aux):
    """The MoE aux loss as the mesh train step reports it where each row
    part routes its rows alone (a mesh with a ``model`` axis): the first
    ``batch`` part's value on every rank, with each rank's own value's
    gradient.  The reference's expert-parallel ``shard_map`` declares
    its aux output replicated, so its loss holds the first data shard's
    aux while its gradient averages every shard's.  Elsewhere (one
    device, serving, or the whole microbatch routed on a mesh without
    ``model``) the aux loss is the same on every rank, as it is."""
    from ..distributed.sharding import local_batch, mesh_axis_names
    split = local_batch()
    if split is None or "model" not in mesh_axis_names(split[0]) or \
            not isinstance(aux, torch.Tensor):
        return aux
    return _FirstShard.apply(aux, split[0])


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    mod: Any

    # -- params --------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Params drawn from a ``torch.Generator`` on ``device`` seeded
        with ``seed`` (shapes only on ``"meta"``)."""
        return self.mod.init_params(self.cfg, C.Init.make(seed, device))

    def param_axes(self):
        """The logical-axis tree of :meth:`init`'s params (same keys,
        a tuple of logical axis names per leaf)."""
        return self.mod.param_axes(self.cfg)

    def _extra(self, batch, device) -> Dict[str, Any]:
        """The family's non-token input: ``patches`` (vlm) or ``frames``
        (audio), on ``device``."""
        if self.cfg.family == "audio":
            return {"frames": _as_tensor(batch.get("frames"), device)}
        patches = batch.get("patches") if self.cfg.family == "vlm" else None
        return {"patches": _as_tensor(patches, device)}

    # -- forward -------------------------------------------------------
    def forward(self, params, batch: Dict[str, Any]):
        device = params["embed"].device
        return self.mod.forward(self.cfg, params,
                                _as_tensor(batch["tokens"], device),
                                **self._extra(batch, device))

    def loss(self, params, batch: Dict[str, Any]) -> torch.Tensor:
        """Mean token cross-entropy of :meth:`forward`'s logits against
        ``batch["labels"]``, plus the MoE's aux loss, plus 0.1 x the
        multi-token-prediction head's cross-entropy against the labels
        one step on where the config has one (the reference's
        ``Model.loss``).  In the mesh train step ``batch`` is this
        rank's rows: the cross-entropies divide by the global batch's
        share of unmasked labels, and the aux loss is the whole
        microbatch's or, where each row part routes alone, the first
        part's (:func:`_first_shard`); the mean over the ``batch`` ranks
        is then the reference's loss.  Where compute is split over
        ``model`` the logits are each rank's vocab columns and the
        cross-entropies are vocab-parallel, so the loss is the same on
        every ``model`` rank."""
        device = params["embed"].device
        logits, extras = self.forward(params, batch)
        labels = _as_tensor(batch["labels"], device)
        count = _batch_share(labels)
        vocab = self.cfg.vocab
        loss = C.cross_entropy(logits, labels, count=count, vocab=vocab)
        aux = extras.get("aux_loss", 0.0)
        loss = loss + (_first_shard(aux) if self.cfg.n_experts else aux)
        if self.cfg.mtp and "mtp_hidden" in extras:
            mtp = self.mod.mtp_logits(
                self.cfg, params, extras["mtp_hidden"],
                _as_tensor(batch["tokens"], device))
            loss = loss + 0.1 * C.cross_entropy(
                mtp, torch.roll(labels, -1, dims=1), count=count,
                vocab=vocab)
        return loss

    # -- serving -------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self.mod.init_cache(self.cfg, batch, max_len, device)

    def cache_axes(self):
        """The logical axes of :meth:`init_cache`'s leaves."""
        return self.mod.cache_axes(self.cfg)

    def prefill(self, params, batch: Dict[str, Any], cache):
        device = params["embed"].device
        return self.mod.prefill(self.cfg, params,
                                _as_tensor(batch["tokens"], device), cache,
                                **self._extra(batch, device))

    def decode_step(self, params, cache, tokens):
        return self.mod.decode_step(
            self.cfg, params, cache,
            _as_tensor(tokens, params["embed"].device))

    def supports_chunked_prefill(self) -> bool:
        """True when the family implements incremental ``prefill_chunk``:
        transformer-family models unless they use an MLA latent cache or
        need extra prefill inputs (vlm patches).  Callers must also check
        that the cache is full-context (not a ring)."""
        if not hasattr(self.mod, "prefill_chunk"):
            return False
        if self.cfg.mla:
            return False
        if self.cfg.family in ("vlm", "audio"):
            return False
        return True

    def prefill_chunk(self, params, tokens, cache, start, length,
                      visible=None):
        """Prefill one fixed-size chunk of a prompt at absolute offset
        ``start`` (see ``transformer.prefill_chunk``): ``start`` and
        ``length`` host ints or device scalars, passed through."""
        return self.mod.prefill_chunk(
            self.cfg, params, _as_tensor(tokens, params["embed"].device),
            cache, start, length, visible)

    def check_chunk(self, cache, chunk: int, start: int,
                    length: int) -> None:
        """Raise ``ValueError`` unless a chunk of ``chunk`` rows at host
        ``start`` with ``length`` real tokens fits ``cache`` (see
        ``transformer.check_chunk``)."""
        self.mod.check_chunk(cache, chunk, start, length)

    def visible_chunks(self, cache, chunk: int, start: int):
        """The kv chunks a chunk at host ``start`` can see under
        ``causal_skip`` (None without it): the chunk program keys one
        graph on it (see ``transformer.visible_chunks``)."""
        return self.mod.visible_chunks(self.cfg, cache, chunk, start)


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"unknown family {cfg.family!r}")
    return Model(cfg, _FAMILY_MODULES[cfg.family])
