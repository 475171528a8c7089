"""CompileOptions — the one options surface for ``repro_torch.compile``.

The reference's field names, plus ``device``, which torch needs and
JAX did not: the ``torch.device`` the compiled program runs on.
Options are frozen, comparable and JSON-serializable, so they double as
part of the persistent executable-cache key.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

from ..dist.mesh import MeshSpec
from ..runtime.buckets import BucketPolicy

PRECISIONS = ("exact", "fast", "f32", "bf16", "int8", "mixed")
#: Precisions that go through the calibrated quantize pass.
QUANT_PRECISIONS = ("f32", "bf16", "int8", "mixed")
AUTOTUNE_MODES = ("off", "cached", "full")



def _normalize_rules(rules) -> Tuple[Tuple[str, object], ...]:
    """Canonical, hashable form of a sharding-rules override: sorted
    ``(logical, axes-tuple-or-None)`` pairs.  Accepts a mapping or a
    pair sequence (the ``from_dict`` round trip)."""
    items = rules.items() if hasattr(rules, "items") else rules
    out = []
    for k, v in items:
        if v is None or isinstance(v, str):
            out.append((str(k), v))
        else:
            out.append((str(k), tuple(str(a) for a in v)))
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Every compile-time choice, in one place.

    target:        ``"interpret"`` (SimpleNN oracle), ``"jit"`` (pass
                   pipeline + generic ATen rules), ``"cuda"`` (``jit`` plus
                   the hand-written CUDA kernels; CPU or a Hopper card).
    precision:     ``"exact"`` (default) and ``"fast"`` (paper §3.4
                   approximate activations) are the f32 pipelines.  The
                   low-precision family routes through the calibrated
                   quantize pass: ``"f32"`` (bit-identical to
                   ``"exact"``), ``"bf16"`` (operands rounded to bfloat16,
                   f32 accumulation) and ``"int8"`` (calibrated symmetric
                   int8 dense sites, exact int32 sums, f32 dequant).
                   ``"mixed"`` measures f32/bf16/int8 per site on the
                   compile's device and keeps the fastest within
                   ``precision_budget`` (winners in the tactic cache);
                   it measures unless ``autotune="cached"``.
    device:        where the program runs: ``"cuda"`` (default; compiling
                   raises when ``torch.cuda.is_available()`` is false) or
                   ``"cpu"``, where every kernel wrapper runs its plain
                   version (what the CPU tests compare).
    embed_weights: kept for the reference's surface; eager torch holds the
                   weights as device tensors either way.
    passes:        explicit pass pipeline; ``None`` = DEFAULT_PIPELINE.
    donate_inputs: kept for the reference's surface; no effect in eager
                   torch, which never frees a caller's tensor.
    dump_ir:       dump the IR between passes: a directory or ``"-"``.
    calibrate:     seeded sample batches of the quantize pass's
                   calibration walk; ``None`` = 4 under a quantizing
                   precision, ignored otherwise.
    precision_budget: the accuracy budget of ``"mixed"``: max abs error of
                   a site's int8/bf16 output against its f32 output on
                   the first calibration batch; ``None`` = 0.05.
    autotune_budget_ms: wall-clock budget of ``"full"`` measurement
                   (builds, warm-ups and captures included); what it
                   does not reach keeps the heuristic.  The graph
                   decisions take at most half of it, once, when the
                   executable is built; each batch size's kernel tactics
                   then get what the decisions left, afresh for every
                   batch size (as in the reference).  ``None`` = no limit
                   for both.  ``"mixed"``'s per-site measurement has a
                   budget of its own of the same size, spent once in the
                   pass pipeline; there ``None`` means 1000 ms.
    autotune:      ``"off"`` (default: the heuristic selector and
                   passes), ``"cached"`` (winners from the tactic cache
                   only, no measurement) or ``"full"`` (measure what the
                   cache lacks, store the winners): kernel plans of B1,
                   B2 and B4 per node and graph decisions (fusion,
                   layout, pipeline).  On the card the candidates are
                   timed on the device (``repro_torch.autotune``).  The
                   tactic cache lives under ``<cache_dir>/tactics``.
    batch_buckets: optional ascending batch sizes to specialize for; a
                   call with batch B runs the smallest bucket >= B (input
                   padded with zero rows, output sliced).  Empty =
                   specialize exactly.  Prepares lazily and synchronously
                   (the legacy spelling; prefer ``buckets=``).
    buckets:       a :class:`repro_torch.runtime.BucketPolicy` (or its
                   ``to_dict`` form); the compile returns a
                   :class:`~repro_torch.runtime.BucketedExecutable`: one
                   warm program per batch bucket, cold buckets captured in
                   the background, pre-warmed from the executable cache.
                   On a CUDA device a capture under way makes CUDA refuse
                   a device-wide ``torch.cuda.synchronize()`` on any
                   thread, and the refused call can fail that capture.
                   While buckets may still be cold, synchronise the
                   current stream instead
                   (``torch.cuda.current_stream().synchronize()``), or
                   call ``warm_up(block=True)`` first.  A capture that
                   failed is not kept: the bucket's next call captures it
                   again.
    cache_dir:     directory of the persistent executable cache (the pass
                   pipeline's output graph, its report and the kernel
                   selection per batch); None falls back to
                   ``$REPRO_TORCH_CACHE_DIR``, and if that is unset the
                   disk cache is off.
    capture:       a directory: the ``jit``/``cuda`` compile records a
                   capture bundle there (``repro_torch.api.capture``: the
                   input graph, options, per-pass IR, every tactic-cache
                   entry it used, and per batch size the selection and
                   the outputs of seeded inputs), which ``python -m
                   repro_torch.replay <dir>`` reproduces in a fresh
                   process; None falls back to
                   ``$REPRO_TORCH_CAPTURE_DIR`` (a root, one bundle per
                   compile), and if that is unset nothing is recorded.
                   Under capture the pass pipeline always runs (for its
                   IR dumps and report): the executable cache's graph
                   entry is not read, only stored.  A bundle is not a
                   captured CUDA graph (``core/program.py``), though on
                   a CUDA device the outputs it records are its replay's.
    mesh:          a :class:`repro_torch.dist.MeshSpec` (or any spelling
                   its ``coerce`` accepts: ``"data=2,model=2"``, a dict of
                   sizes) making device placement a compile-time input.
                   The ``"jit"``/``"cuda"`` targets then produce a
                   :class:`repro_torch.dist.ShardedExecutable`: its graph
                   carries per-tensor partition specs and explicit
                   collective nodes, and it runs over the default
                   ``torch.distributed`` process group, one rank a device
                   (a single-device mesh needs none and stays
                   bit-identical to the unsharded path).  The ``engine``
                   target carries it: its calls run unsharded and its
                   ``serve()`` serves on the mesh.  ``None`` = the
                   unsharded compile.
    sharding_rules: overrides on the logical-axis rules table
                   (``repro_torch.distributed.sharding.DEFAULT_RULES``)
                   the propagation pass reads — a mapping or pairs of
                   ``logical axis -> mesh axis (or axes, or None to force
                   replication)``.  Only meaningful with ``mesh=``.  Both
                   fields are part of the persistent cache key.
    """

    target: str = "jit"
    precision: str = "exact"
    calibrate: Optional[int] = None
    precision_budget: Optional[float] = None
    embed_weights: bool = True
    passes: Optional[Tuple[str, ...]] = None
    batch_buckets: Tuple[int, ...] = ()
    buckets: Optional[BucketPolicy] = None
    donate_inputs: bool = False
    cache_dir: Optional[str] = None
    dump_ir: Optional[str] = None
    autotune: str = "off"
    autotune_budget_ms: Optional[float] = 1000.0
    capture: Optional[str] = None
    mesh: Optional[MeshSpec] = None
    sharding_rules: Optional[Tuple[Tuple[str, object], ...]] = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.calibrate is not None and int(self.calibrate) <= 0:
            raise ValueError(
                f"calibrate must be a positive batch count or None, "
                f"got {self.calibrate!r}")
        if self.precision_budget is not None and self.precision_budget <= 0:
            raise ValueError(
                f"precision_budget must be a positive max_abs_err or "
                f"None, got {self.precision_budget!r}")
        if self.autotune not in AUTOTUNE_MODES:
            raise ValueError(f"autotune must be one of {AUTOTUNE_MODES}, "
                             f"got {self.autotune!r}")
        if (self.autotune_budget_ms is not None
                and self.autotune_budget_ms <= 0):
            raise ValueError(f"autotune_budget_ms must be positive or None, "
                             f"got {self.autotune_budget_ms!r}")
        buckets = tuple(sorted(int(b) for b in self.batch_buckets))
        if any(b <= 0 for b in buckets):
            raise ValueError(f"batch_buckets must be positive: {buckets}")
        object.__setattr__(self, "batch_buckets", buckets)
        if isinstance(self.buckets, dict):      # from_dict round trip
            object.__setattr__(self, "buckets",
                               BucketPolicy.from_dict(self.buckets))
        if self.buckets is not None and not isinstance(self.buckets,
                                                       BucketPolicy):
            raise ValueError(
                f"buckets must be a repro_torch.runtime.BucketPolicy or "
                f"None, got {type(self.buckets).__name__}")
        if self.buckets is not None and self.batch_buckets:
            raise ValueError(
                "batch_buckets (legacy, lazy) and buckets (runtime "
                "engine cache) are mutually exclusive")
        if self.mesh is not None and not isinstance(self.mesh, MeshSpec):
            object.__setattr__(self, "mesh", MeshSpec.coerce(self.mesh))
        if self.sharding_rules is not None:
            object.__setattr__(self, "sharding_rules",
                               _normalize_rules(self.sharding_rules))
        if self.passes is not None:
            object.__setattr__(self, "passes", tuple(self.passes))
        object.__setattr__(self, "device", str(self.device))

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "CompileOptions":
        """Copy with the given fields replaced (options are frozen)."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """Plain-dict form for JSON artifacts; invert with ``from_dict``."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "CompileOptions":
        """Rebuild options from ``to_dict`` output (re-tuplifying the
        fields JSON round-trips as lists)."""
        d = dict(d)
        if d.get("passes") is not None:
            d["passes"] = tuple(d["passes"])
        d["batch_buckets"] = tuple(d.get("batch_buckets") or ())
        return cls(**d)

    def cache_token(self) -> str:
        """Stable string of every field that affects the compiled program.
        Where it is cached and how it is dumped do not, nor how a caller
        buckets batches: the batch size is a key part of its own, so a
        bucketed executable shares entries with exact compiles.  Nor do
        the ``autotune`` fields: what they change, the decided graph and
        pipeline and the resolved kernel selection, are key parts of
        their own (``api/targets.py``), so a tuned compile that resolves
        to the heuristic's choices shares its entries."""
        d = self.to_dict()
        for k in ("cache_dir", "batch_buckets", "buckets", "dump_ir",
                  "autotune", "autotune_budget_ms", "capture"):
            d.pop(k)
        return json.dumps(d, sort_keys=True, default=str)
