"""repro_torch.autotune — profile-guided autotuning, kernel- and graph-level.

The port of ``repro.autotune``.  The static selector
(``repro_torch.core.selection``) and the passes decide from shapes;
this package replaces a guess with a measurement where one is
available.  Two layers share one machinery:

* **kernel tactics** (:mod:`~repro_torch.autotune.tuner`): per node
  (op, shapes, dtype, batch, target, device), the kernel's plan at every
  point of its grid (``kernels/tiles.py``), measured (device time on the
  card), the winner recorded and launched;
* **graph decisions** (:mod:`~repro_torch.autotune.decisions`): per
  graph-region digest, fusion on/off per site, the dense kernel layout
  and whole pass-pipeline variants, measured as captured programs.

Both persist winners in one fingerprinted on-disk tactic cache
(:mod:`~repro_torch.autotune.cache`): a second process with
``CompileOptions(autotune="cached")`` replays every decision without
measuring.  Driven by ``CompileOptions(autotune="off"|"cached"|"full",
autotune_budget_ms=...)``; ``precision="mixed"`` measures its per-site
precision through the same deadline and cache
(``core/passes/quantize.py``).
"""

from .cache import (TACTICS_SUBDIR, TacticCache, environment_fingerprint,
                    open_tactic_cache, tactic_key)
from .decisions import (DecisionSite, GRAPH_BUDGET_FRACTION, enumerate_sites,
                        extract_region, region_digest, tune_graph_decisions)
from .measure import Deadline, bench_min_us
from .tactics import NodeTactics, Tactic, candidates_for_node
from .tuner import AUTOTUNE_MODES, tune_selection

__all__ = [
    "DecisionSite",
    "GRAPH_BUDGET_FRACTION",
    "enumerate_sites",
    "extract_region",
    "region_digest",
    "tune_graph_decisions",
    "AUTOTUNE_MODES",
    "Deadline",
    "NodeTactics",
    "TACTICS_SUBDIR",
    "Tactic",
    "TacticCache",
    "bench_min_us",
    "candidates_for_node",
    "environment_fingerprint",
    "open_tactic_cache",
    "tactic_key",
    "tune_selection",
]
