"""Model API — one surface over the architecture families.

The port of ``repro.models.api``.  ``get_model(cfg)`` returns a
``Model`` whose methods dispatch to the family implementation:

    init(seed, device)                  -> params (nested dict of tensors)
    forward(params, batch)              -> (logits, extras)
    init_cache(batch, max_len, device)  -> cache
    prefill(params, batch, cache)       -> (logits, cache)
    decode_step(params, cache, tokens)  -> (logits, cache)
    prefill_chunk(params, tokens, cache, start, length) -> (logits, cache)

The transformer families (``dense``, ``moe``, ``vlm``) are ported; the
other three (``ssm``, ``hybrid``, ``audio``) are ROADMAP A.12b and
raise.  ``loss`` waits for training (A.15), ``param_axes`` and
``cache_axes`` for distribution (A.14).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig
from . import common as C
from . import transformer

_FAMILY_MODULES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
}

#: Families of the reference whose modules are not ported yet.
_UNPORTED_FAMILIES = {
    "ssm": "models/ssm.py (mamba2)",
    "hybrid": "models/rglru.py (recurrentgemma)",
    "audio": "models/whisper.py (whisper)",
}


def _as_tensor(v, device):
    return v if v is None else torch.as_tensor(v, device=device)


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
        raise NotImplementedError(
            "logical param axes serve sharding, which is not ported yet "
            "(ROADMAP A.14: distribution)")

    # -- forward -------------------------------------------------------
    def forward(self, params, batch: Dict[str, Any]):
        patches = None
        if self.cfg.family == "vlm":
            patches = batch.get("patches")
        device = params["embed"].device
        return self.mod.forward(self.cfg, params,
                                _as_tensor(batch["tokens"], device),
                                patches=_as_tensor(patches, device))

    def loss(self, params, batch):
        raise NotImplementedError(
            "the training loss is not ported yet (ROADMAP A.15: training)")

    # -- serving -------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        return self.mod.init_cache(self.cfg, batch, max_len, device)

    def cache_axes(self):
        raise NotImplementedError(
            "logical cache axes serve sharding, which is not ported yet "
            "(ROADMAP A.14: distribution)")

    def prefill(self, params, batch: Dict[str, Any], cache):
        device = params["embed"].device
        patches = batch.get("patches") if self.cfg.family == "vlm" else None
        return self.mod.prefill(self.cfg, params,
                                _as_tensor(batch["tokens"], device), cache,
                                patches=_as_tensor(patches, device))

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

    def prefill_chunk(self, params, tokens, cache, start, length):
        """Prefill one fixed-size chunk of a prompt at absolute offset
        ``start`` (see ``transformer.prefill_chunk``)."""
        return self.mod.prefill_chunk(
            self.cfg, params, _as_tensor(tokens, params["embed"].device),
            cache, start, length)


def get_model(cfg: ArchConfig) -> Model:
    if cfg.family in _UNPORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_UNPORTED_FAMILIES[cfg.family]} is ROADMAP A.12b")
    if cfg.family not in _FAMILY_MODULES:
        raise KeyError(f"unknown family {cfg.family!r}")
    return Model(cfg, _FAMILY_MODULES[cfg.family])
