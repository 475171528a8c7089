"""Activation fusion (paper §3.4).

Elementwise activations following a conv/dense node are removed from the
graph and recorded as the producer's ``epilogue``: the back end applies
them to the accumulator tile before the store to memory ("the activation
function is applied before writing the result of the operation into
memory. This avoids an additional loop with load and store operations").

Softmax is never fused — it needs two passes (§3.4) and always stays a
separate compilation unit.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..graph import ACTIVATIONS, Graph
from .fold_batchnorm import _remove_node
from .manager import register_pass

FUSABLE_PRODUCERS = ("conv2d", "depthwise_conv2d", "dense")

#: Tuning-site hook: when the graph-level autotuner has measured that an
#: activation is better left unfused (``repro.autotune.decisions``), it
#: sets this attr to ``False`` on the activation node and the pass skips
#: that site.  Absent / ``True`` keeps the heuristic (fuse when legal),
#: so ``autotune="off"`` is bit-identical.  The attr is *not* popped:
#: the pass runs twice (base + ``.post_bn``) and both must honor it.
TUNE_FUSE_ATTR = "tune.fuse"


# Registered twice (see passes/__init__): once before BN folding so the
# conv→act→BN pattern can fold as a post-activation affine (§3.5), and
# once after as "fuse_activation.post_bn", because BN removal exposes
# new conv→act adjacencies (conv→BN→act becomes conv→act).
@register_pass("fuse_activation", after=("canonicalize",),
               before=("fold_batchnorm",))
def fuse_activation(graph: Graph) -> Tuple[Graph, Dict]:
    g = graph.copy()
    fused = 0
    changed = True
    while changed:
        changed = False
        for act in list(g.nodes):
            if act.op != "activation":
                continue
            fn = act.attrs["fn"]
            if not ACTIVATIONS.get(fn, False):
                continue  # not fusable (softmax)
            if act.attrs.get(TUNE_FUSE_ATTR) is False:
                continue  # autotuner measured this site faster unfused
            src = g.producer(act.inputs[0])
            if src is None or src.op not in FUSABLE_PRODUCERS:
                continue
            if src.epilogue not in (None, "linear"):
                continue  # already has a fused activation
            if len(g.consumers(src.output)) != 1:
                # The pre-activation value is needed elsewhere; fusing
                # would force recomputation.  CompiledNN only fuses when
                # "deemed beneficial" — skip.
                continue
            src.epilogue = fn
            src.epilogue_attrs = {
                k: v for k, v in act.attrs.items() if k != "fn"
            }
            _remove_node(g, act)
            fused += 1
            changed = True
    g.rebuild_index()
    return g, {"fused_activations": fused}
