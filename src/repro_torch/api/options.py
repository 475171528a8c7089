"""CompileOptions — the one options surface for ``repro_torch.compile``.

The reference's field names, plus ``device``, which torch needs and
JAX did not: the ``torch.device`` the compiled program runs on.  Fields
whose feature the port has not reached yet raise ``NotImplementedError``
naming the ROADMAP item that ports them, instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

PRECISIONS = ("exact", "fast", "f32", "bf16", "int8", "mixed")
#: Precisions that need the calibrated quantize pass (ROADMAP A.5).
QUANT_PRECISIONS = ("f32", "bf16", "int8", "mixed")
AUTOTUNE_MODES = ("off", "cached", "full")

#: Field that must stay unset -> the ROADMAP item that ports the feature.
_UNPORTED = {
    "batch_buckets": "A.11: runtime buckets",
    "buckets": "A.11: runtime buckets",
    "cache_dir": "A.7: executable cache and serialization",
    "capture": "A.10: capture and replay",
    "mesh": "A.14: distribution",
    "sharding_rules": "A.14: distribution",
}


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Every compile-time choice, in one place.

    target:        ``"interpret"`` (SimpleNN oracle), ``"jit"`` (pass
                   pipeline + generic ATen rules), ``"cuda"`` (``jit`` plus
                   the hand-written CUDA kernels; CPU or a Hopper card).
    precision:     ``"exact"`` (default) or ``"fast"`` (paper §3.4
                   approximate activations).  The low-precision family
                   (``f32``/``bf16``/``int8``/``mixed``) is ROADMAP A.5.
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
    calibrate, precision_budget, autotune_budget_ms: read only by the
                   unported quantize pass and autotuner.
    autotune:      only ``"off"`` (ROADMAP A.8: autotune).
    batch_buckets, buckets, cache_dir, capture, mesh, sharding_rules:
                   must stay unset (ROADMAP A.11, A.7, A.10, A.14); the
                   targets prepare one program per batch size seen.
    """

    target: str = "jit"
    precision: str = "exact"
    calibrate: Optional[int] = None
    precision_budget: Optional[float] = None
    embed_weights: bool = True
    passes: Optional[Tuple[str, ...]] = None
    batch_buckets: Tuple[int, ...] = ()
    buckets: Optional[object] = None
    donate_inputs: bool = False
    cache_dir: Optional[str] = None
    dump_ir: Optional[str] = None
    autotune: str = "off"
    autotune_budget_ms: Optional[float] = 1000.0
    capture: Optional[str] = None
    mesh: Optional[object] = None
    sharding_rules: Optional[Tuple[Tuple[str, object], ...]] = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        if self.precision not in PRECISIONS:
            raise ValueError(
                f"precision must be one of {PRECISIONS}, got {self.precision!r}")
        if self.precision in QUANT_PRECISIONS:
            raise NotImplementedError(
                f"precision={self.precision!r} is not ported yet "
                f"(ROADMAP A.5: precision modes)")
        if self.autotune not in AUTOTUNE_MODES:
            raise ValueError(f"autotune must be one of {AUTOTUNE_MODES}, "
                             f"got {self.autotune!r}")
        if self.autotune != "off":
            raise NotImplementedError(
                f"autotune={self.autotune!r} is not ported yet "
                f"(ROADMAP A.8: autotune)")
        object.__setattr__(self, "batch_buckets", tuple(self.batch_buckets))
        for field, item in _UNPORTED.items():
            value = getattr(self, field)
            if value is not None and value != ():
                raise NotImplementedError(
                    f"CompileOptions.{field} is not ported yet (ROADMAP {item})")
        if self.passes is not None:
            object.__setattr__(self, "passes", tuple(self.passes))
        object.__setattr__(self, "device", str(self.device))

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "CompileOptions":
        """Copy with the given fields replaced (options are frozen)."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """Plain-dict form for JSON artifacts."""
        return dataclasses.asdict(self)

    def cache_token(self) -> str:
        """Stable string of every field that affects the compiled program
        (where it is cached and how it is dumped do not)."""
        d = self.to_dict()
        for k in ("cache_dir", "batch_buckets", "buckets", "dump_ir",
                  "autotune", "autotune_budget_ms", "capture"):
            d.pop(k)
        return json.dumps(d, sort_keys=True, default=str)
