"""Host spans of the serving and inference hot paths, live only while a
profiler records.

``with span("decode"): ...`` marks a region of host code as a
``torch.profiler.record_function`` named ``repro.decode``: an event in
the profiler's own trace, on the same clock as the card's kernels and
copies, so a reader of the trace can say which host phase the card
waited on.  With no profiler recording, :func:`span` returns one shared
``contextlib.nullcontext()`` and does nothing else: a span site then
costs one ``torch.autograd._profiler_enabled()`` check (a
``record_function`` costs ~13 µs even with no profiler).  There is no
switch: a span is live exactly when someone profiles.

Spans wrap host code and graph replays only, never a function that a
CUDA graph capture records, and never read the scheduler's clock.

The spans (each on the thread that calls ``Scheduler.step`` or an
executable):

* ``repro.step`` — one scheduler iteration (``Scheduler.step``): in a
  profile of a serving process it bounds the iteration, and the idle
  time under it and no inner span is the scheduler's own Python;
* ``repro.admit`` — admission: queue pop, prefix-cache take, a new
  single-row cache, the snapshot plan (with whole-prompt or padded
  prefill, the prefill and its first token too);
* ``repro.chunk`` — one prefill chunk: staging and the chunk program;
* ``repro.prefill`` — one padded or whole-prompt prefill program call;
* ``repro.decode`` — the decode step: compaction, the token copy, the
  step (its replay), the logits slice;
* ``repro.sample`` — a step's per-slot sampling loop, or a request's
  first token: the host reads each token back;
* ``repro.call`` — one call of a compiled graph
  (``JitExecutable.__call__``): input gathering, the bucket's choice
  and the pool's ordering, around the three spans below;
* ``repro.input`` / ``repro.replay`` / ``repro.output`` — a captured
  program's static-input copies, its graph launch, its output clones.

``chunk``, ``prefill`` and a first token's ``sample`` belong to one
request and carry its id in their names: ``repro.chunk uid=7``.  (A
``record_function``'s own ``args`` reach no exported trace, so the id
rides in the name; a reader takes the span's kind from the name up to
its first space.)
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

PREFIX = "repro."
_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str, uid: Optional[int] = None):
    """``repro.<name>`` (``repro.<name> uid=<uid>`` for one request's
    span) as a profiler event while a profiler records, else the shared
    null context."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(
        PREFIX + name if uid is None else f"{PREFIX}{name} uid={uid}")
