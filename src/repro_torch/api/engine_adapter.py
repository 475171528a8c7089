"""The "engine" target: framework-scale models behind the same API.

The port of ``repro.api.engine_adapter``.
``repro_torch.compile(cfg_or_model, CompileOptions(target="engine"))``
wraps ``repro_torch.models.Model`` in the Executable protocol, so the LLM
stack and the paper's CNN compiler are driven the same way:

    exe = repro_torch.compile(get_config("qwen2.5-14b"),
                              CompileOptions(target="engine"))
    exe(tokens=toks)["logits"]          # the forward, on the card

Params are made on ``options.device`` from ``init_seed``, or carried in
with ``params=`` (e.g. :func:`repro_torch.weights.params_from_reference`)
and moved there.  Execution is eager: capturing the decode step as a
CUDA graph belongs to the serve scheduler (ROADMAP A.13), as does
``serve()``.
"""

from __future__ import annotations

import dataclasses
import io
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, extra_input_specs
from ..core.graph import Signature
from ..core.lowering import resolve_device
from ..models import common as C
from ..models.api import Model, get_model
from .executable import Executable, pack
from .options import CompileOptions

#: Leaf dtypes an ``.npz`` holds as they are; others (bf16) are widened
#: to f32, losslessly, and narrowed back on load.
_NPZ_DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64,
               torch.uint8, torch.bool)


def _to_device(leaf, device) -> torch.Tensor:
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    return leaf.to(device)


def _cast_f32_leaves(tree: Dict[str, Any], dtype: torch.dtype) -> None:
    """Cast every f32 leaf of ``tree`` to ``dtype``, in this dict, one
    leaf at a time: each f32 leaf is released as soon as its copy exists
    (unless a caller still holds it), so the f32 and the cast trees never
    coexist whole."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _cast_f32_leaves(v, dtype)
        elif v.dtype == torch.float32:
            tree[k] = v.to(dtype)


class ModelExecutable(Executable):
    """Executable over a registered model architecture (the ``"engine"``
    target): ``model.forward`` over params held on the executable's
    device, with the first call of each unseen input signature timed
    into ``compile_time``."""

    def __init__(self, model_or_cfg, options: CompileOptions, *,
                 params=None, init_seed: int = 0) -> None:
        if isinstance(model_or_cfg, Model):
            self.model = model_or_cfg
        elif hasattr(model_or_cfg, "cfg") and hasattr(model_or_cfg,
                                                      "forward"):
            self.model = get_model(model_or_cfg.cfg)
        else:
            self.model = get_model(model_or_cfg)
        self.cfg = self.model.cfg
        self.options = options
        # The graph quantize pass does not route through framework-scale
        # models, so the engine target supports the storage-level subset:
        # a weight-only bf16 cast.  Calibrated int8 needs the graph
        # pipeline and is rejected rather than served at full precision.
        if options.precision in ("int8", "mixed"):
            raise ValueError(
                f"precision={options.precision!r} is not supported by "
                "the 'engine' target: calibrated int8 routes through "
                "the graph quantize pass, which framework-scale models "
                "bypass — use precision='bf16' (weight-only storage "
                "cast) for served models")
        self.device = resolve_device(options.device)
        if params is None:
            params = self.model.init(init_seed, self.device)
        else:
            params = C.tree_map(lambda t: _to_device(t, self.device), params)
        self.quant_report: Optional[dict] = None
        if options.precision == "bf16":
            _cast_f32_leaves(params, torch.bfloat16)
            leaves = C.tree_leaves(params)
            n_bf16 = sum(1 for l in leaves if l.dtype == torch.bfloat16)
            self.quant_report = {
                "mode": "bf16",
                "decisions": {"bf16": n_bf16,
                              "f32": len(leaves) - n_bf16}}
        self.params = params
        self.compile_time: Optional[float] = None
        self._seen_shapes = set()
        # Shapes are dynamic at this scale (prefill length, batch), so
        # the signature carries names and order but no static specs.
        self.signature = Signature(
            inputs=(("tokens", None),) + tuple(
                (n, None) for n in extra_input_specs(self.cfg)),
            outputs=(("logits", None),),
        )

    # ------------------------------------------------------------------
    def __call__(self, *pos, **batch) -> Dict[str, Any]:
        batch = self.signature.bind(pos, batch)
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in batch.items()))
        with torch.inference_mode():
            if sig in self._seen_shapes:
                return {"logits": self.model.forward(self.params, batch)[0]}
            t0 = time.perf_counter()
            logits = self.model.forward(self.params, batch)[0]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._seen_shapes.add(sig)
        self.compile_time = ((self.compile_time or 0.0)
                             + time.perf_counter() - t0)
        return {"logits": logits}

    def serve(self, options=None, **kw):
        raise NotImplementedError(
            "serving an engine executable needs the scheduler, which is "
            "not ported yet (ROADMAP A.13: serve)")

    # ------------------------------------------------------------------
    def cost_summary(self):
        """Model-level cost facts: parameter count and byte footprint
        (engine executables have no pass pipeline to report)."""
        leaves = C.tree_leaves(self.params)
        out = {
            "target": "engine",
            "arch": self.cfg.name,
            "family": self.cfg.family,
            "params": int(sum(l.numel() for l in leaves)),
            "param_bytes": int(sum(l.numel() * l.element_size()
                                   for l in leaves)),
        }
        if self.quant_report is not None:
            out["quant"] = dict(self.quant_report)
        return out

    def serialize(self) -> bytes:
        """Pack the cfg (JSON) and the param leaves (an ``.npz``, no
        pickle) into the port's container.  Leaf ``i`` is stored as
        ``leaf::i`` in the flatten order of
        :func:`repro_torch.models.common.tree_flatten`: depth first, keys
        sorted, the order ``jax.tree_util`` flattens the reference's
        dicts in.  The tree itself is not stored: it is derived from the
        cfg again at load time."""
        arrays = {}
        dtypes = []
        for i, leaf in enumerate(C.tree_leaves(self.params)):
            t = leaf.detach().cpu()
            dtypes.append(C.dtype_name(t.dtype))
            if t.dtype not in _NPZ_DTYPES:
                t = t.float()           # bf16 etc: widen losslessly
            arrays[f"leaf::{i}"] = t.numpy()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        extra = {"cfg": dataclasses.asdict(self.cfg), "leaf_dtypes": dtypes}
        return pack("engine", self.options, buf.getvalue(), extra=extra)


def deserialize_engine(meta: dict, body: bytes,
                       options: CompileOptions) -> ModelExecutable:
    """Rebuild a ``ModelExecutable`` from a packed artifact: the cfg from
    the metadata, the leaf structure from an init of that cfg on the meta
    device (nothing allocated), the leaves from the npz body (no
    pickle)."""
    try:
        cfg = ArchConfig(**meta["cfg"])
        dtypes = list(meta["leaf_dtypes"])
    except (KeyError, TypeError):
        raise ValueError("engine container without a valid cfg and "
                         "leaf_dtypes") from None
    template = C.tree_flatten(get_model(cfg).init(device="meta"))
    if len(dtypes) != len(template):
        raise ValueError(
            f"param leaf count mismatch: container has {len(dtypes)}, "
            f"cfg {cfg.name!r} expects {len(template)}")
    data = np.load(io.BytesIO(body), allow_pickle=False)
    leaves = []
    for i, ((path, want), dt) in enumerate(zip(template, dtypes)):
        a = data[f"leaf::{i}"]
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i} ({path}) has shape {a.shape}; cfg "
                             f"{cfg.name!r} expects {tuple(want.shape)}")
        leaves.append(torch.from_numpy(a).to(C.torch_dtype(dt)))
    params = C.tree_unflatten([p for p, _ in template], leaves)
    return ModelExecutable(cfg, options, params=params)
