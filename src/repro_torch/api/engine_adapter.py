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
and moved there.  Where the reference jits ``model.forward`` once per
input signature, the port runs one :class:`ForwardProgram` per
signature: on a CUDA device the forward captured as one CUDA graph over
static input tensors, all of an executable's programs in one
:class:`~repro_torch.core.program.GraphPool` (a larger signature lays it
out again, :meth:`~repro_torch.core.program.GraphPool.place`); on the
CPU the same forward run eagerly.  ``exe.serve(...)`` hands the
executable to the serve scheduler (:mod:`repro_torch.serve`), which
captures its own serving programs.
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
from ..core.program import GraphPool, capture, replay
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


class ForwardProgram:
    """``model.forward(params, batch)[0]`` of one input signature over
    static input tensors: captured on a CUDA device into ``pool`` as one
    CUDA graph that reads ``params`` where they lie (a call copies its
    inputs in, replays, and returns a copy of the static logits, which
    the pool's next replay may overwrite), run eagerly on the CPU.
    ``order`` is the inputs' element count (the pool's size key)."""

    def __init__(self, model: Model, params, batch: Dict[str, torch.Tensor],
                 pool: Optional[GraphPool] = None) -> None:
        self.model = model
        self.params = params
        self.pool = pool
        self.device = next(iter(batch.values())).device
        self.order = sum(t.numel() for t in batch.values())
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        #: Bytes the latest capture added to the pool (CUDA only).
        self.pool_bytes = 0
        self.inputs: Dict[str, torch.Tensor] = {}
        if self.device.type != "cuda":
            return
        with torch.inference_mode():
            self.inputs = {k: v.clone() for k, v in batch.items()}
        self.recapture()

    @property
    def captured(self) -> bool:
        """True when each call is a replay of a CUDA graph."""
        return self.graph is not None

    def eager(self, batch: Optional[Dict[str, torch.Tensor]] = None):
        """The forward run op by op, over ``batch`` or the static inputs
        (what the graph recorded): its logits."""
        with torch.inference_mode():
            return self.model.forward(
                self.params, self.inputs if batch is None else batch)[0]

    def recapture(self) -> None:
        """Capture the forward into the pool on the static inputs it
        already has (again, after :meth:`release`)."""
        self.graph, self.logits, self.pool_bytes = capture(
            self.eager, self.device, self.pool)

    def release(self) -> None:
        """Drop the graph and its static logits."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.logits = None

    def __call__(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.device.type != "cuda":
            return self.eager(batch)
        if self.graph is None:            # its recapture failed
            self.recapture()

        def copy_in():
            for name, t in self.inputs.items():
                t.copy_(batch[name])

        with torch.inference_mode():
            return replay(self.pool, self.graph, self.device, copy_in,
                          self.logits.clone)


class ModelExecutable(Executable):
    """Executable over a registered model architecture (the ``"engine"``
    target): ``model.forward`` over params held on the executable's
    device, one :class:`ForwardProgram` per input signature, the first
    call of each unseen signature timed into ``compile_time`` (on a CUDA
    device its warm-up, capture and replay).  The programs read
    :attr:`params` where they lie, so replacing them drops the programs
    (the reference passes the params to its jitted forward as an
    argument).  ``options.mesh`` and ``sharding_rules`` ride along: a
    call runs unsharded (as the reference's does), and :meth:`serve`
    takes the mesh as its serving placement."""

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
        self._programs: Dict[tuple, ForwardProgram] = {}
        self._pool: Optional[GraphPool] = None
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

    @property
    def params(self):
        """The param tree every program reads; setting it drops them."""
        return self._params

    @params.setter
    def params(self, value) -> None:
        for prog in self._programs.values():
            prog.release()
        self._programs = {}
        self._pool = None     # a fresh pool id for the next captures
        self._params = value

    @property
    def programs(self) -> Dict[str, Any]:
        """The forward programs (one per input signature called since
        the params were set): their count, whether each is a CUDA graph
        (``captured``), and the bytes their pool holds."""
        progs = list(self._programs.values())
        return {"programs": len(progs),
                "captured": bool(progs) and all(p.captured for p in progs),
                "pool_bytes": self._pool.bytes if self._pool else 0}

    def _program(self, sig: tuple, batch) -> ForwardProgram:
        """``sig``'s program, built (and on the card captured) now if
        it has none."""
        prog = self._programs.get(sig)
        if prog is None:
            if self.device.type != "cuda":
                prog = ForwardProgram(self.model, self.params, batch)
            else:
                if self._pool is None:
                    self._pool = GraphPool(self.device)
                prog = self._pool.place(
                    lambda: ForwardProgram(self.model, self.params, batch,
                                           self._pool),
                    sum(t.numel() for t in batch.values()),
                    list(self._programs.values()))
            self._programs[sig] = prog
        return prog

    # ------------------------------------------------------------------
    def __call__(self, *pos, **batch) -> Dict[str, Any]:
        batch = self.signature.bind(pos, batch)
        batch = {k: _to_device(v, self.device) for k, v in batch.items()}
        sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                           for k, v in batch.items()))
        if sig in self._seen_shapes:
            return {"logits": self._program(sig, batch)(batch)}
        t0 = time.perf_counter()
        logits = self._program(sig, batch)(batch)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._seen_shapes.add(sig)
        self.compile_time = ((self.compile_time or 0.0)
                             + time.perf_counter() - t0)
        return {"logits": logits}

    def serve(self, options=None, **kw):
        """A continuous-batching :class:`repro_torch.serve.Scheduler`
        over this executable (``repro_torch.serve(self, options,
        **kw)``)."""
        from .serve import serve
        return serve(self, options, **kw)

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
