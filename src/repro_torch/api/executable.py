"""The Executable protocol — what ``repro_torch.compile`` returns.

    exe(**inputs)        -> dict of named output tensors
    exe.compile_time     -> seconds spent compiling
    exe.cost_summary()   -> static cost/report dict
    exe.serialize()      -> self-contained bytes
    deserialize(blob)    -> an equivalent Executable (recompiled, the pass
                            pipeline skipped where the executable cache
                            holds its output)

The port of ``repro.api.executable``.  The serialized form is a small
framed container: a magic line, a JSON meta line (kind + CompileOptions)
and an ``.npz`` body holding the source graph.  It is source-level by
design, as the reference's: a CUDA graph cannot be serialized, and the
pipeline's output lives in the executable cache keyed from the same
bytes.  The magic line is the port's own, so neither package misreads
the other's bytes.
"""

from __future__ import annotations

import abc
import io
import json
from typing import Any, Dict, Optional

from ..core.graph import Signature
from .options import CompileOptions

MAGIC = b"REPROTORCHEXE1"
#: The reference's magic line (``repro.api.executable.MAGIC``), named in
#: the error a reference blob gets.
REFERENCE_MAGIC = b"REPROEXE1"
FORMAT = "repro-torch-executable"
VERSION = 1


class Executable(abc.ABC):
    """Abstract base for all compiled artifacts."""

    options: CompileOptions
    compile_time: Optional[float]
    #: The model's public I/O contract: ordered, named inputs and
    #: outputs.  ``__call__`` binds arguments against it (positional or
    #: keyword) and keys the output dict by its output names.
    signature: Optional[Signature] = None

    @abc.abstractmethod
    def __call__(self, *args, **inputs) -> Dict[str, Any]:
        """Run inference; inputs bind positionally (signature order) or
        by keyword; returns a dict keyed by the signature's output
        names."""

    @abc.abstractmethod
    def cost_summary(self) -> Dict[str, Any]:
        """Static summary: nodes/params/memory plan/kernel selection."""

    @abc.abstractmethod
    def serialize(self) -> bytes:
        """Self-contained bytes; invert with :func:`deserialize`."""


# ---------------------------------------------------------------------------
def pack(kind: str, options: CompileOptions, body: bytes,
         extra: Optional[dict] = None) -> bytes:
    """Frame ``body`` in the artifact container: magic line, one JSON
    metadata line (format/version/kind/options + ``extra``), then the
    raw payload bytes."""
    meta = {"format": FORMAT, "version": VERSION, "kind": kind,
            "options": options.to_dict(), **(extra or {})}
    return MAGIC + b"\n" + json.dumps(meta, default=str).encode() + b"\n" + body


def unpack(data: bytes):
    """Split container bytes into ``(meta, body)``, validating magic,
    format and version; raises ``ValueError`` on anything malformed."""
    try:
        magic, meta_line, body = data.split(b"\n", 2)
    except ValueError:
        raise ValueError("not a repro_torch executable container") from None
    if magic == REFERENCE_MAGIC:
        raise ValueError(
            "this is an executable of the JAX package (repro.serialize); "
            "deserialize it with repro.deserialize, or compile its graph "
            "with repro_torch.compile after "
            "repro_torch.weights.from_reference")
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic[:32]!r}; expected {MAGIC!r}")
    try:
        meta = json.loads(meta_line.decode())
    except (UnicodeDecodeError, ValueError):
        meta = None
    if not isinstance(meta, dict):
        raise ValueError("corrupt executable container metadata")
    if meta.get("format") != FORMAT:
        raise ValueError(f"unknown container format {meta.get('format')!r}")
    if meta.get("version", 0) > VERSION:
        raise ValueError(f"container version {meta['version']} too new")
    return meta, body


def deserialize(data: bytes) -> Executable:
    """Reconstruct an Executable from :meth:`Executable.serialize` bytes.

    The bytes may be untrusted: an embedded ``cache_dir``, ``dump_ir``
    or ``capture`` directory is dropped (``cache_dir`` then falls back
    to the local ``$REPRO_TORCH_CACHE_DIR``), as the reference does."""
    meta, body = unpack(data)
    try:
        options = CompileOptions.from_dict(meta["options"])
    except (KeyError, TypeError):
        raise ValueError("executable container without valid options") \
            from None
    options = options.replace(cache_dir=None, dump_ir=None, capture=None)
    kind = meta.get("kind")
    if kind in ("graph", "bucketed"):
        from ..frontends.container import load_model
        from . import compile as api_compile
        # A bucketed manifest's options carry its policy, so the compile
        # re-wraps it; the per-bucket entries live in the executable
        # cache, and buckets present there pre-warm at construction.
        return api_compile(load_model(io.BytesIO(body)), options)
    if kind == "sharded":
        raise NotImplementedError(
            "sharded executables are not ported yet (ROADMAP A.14: "
            "distribution)")
    if kind == "engine":
        from .engine_adapter import deserialize_engine
        return deserialize_engine(meta, body, options)
    raise ValueError(f"unknown executable kind {kind!r}")
