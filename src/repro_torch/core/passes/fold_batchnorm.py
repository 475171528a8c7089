"""Batch-norm folding (paper §3.5).

A batchnorm computes ``y = gamma * (x - mean) / sqrt(var + eps) + beta``
which is the affine ``y = s * x + o`` with

    s = gamma / sqrt(var + eps)
    o = beta - s * mean

If the BN is immediately **after** a conv/dense node:

    y = s * (W x + b) + o  =  (s ⊙ W) x + (s*b + o)

so the BN disappears by scaling the producing kernel's output channels.

If the BN is immediately **before** a conv/dense node (and nothing else
consumes the BN output):

    W (s*x + o) + b  =  (W ⊙ s) x + (W o + b)

so the BN disappears by scaling the consuming kernel's input channels and
adjusting its bias.

The paper notes that if an activation sits between the BN and the other
layer, the BN is *still* fused and applied after the activation inside
the same compilation unit; in this IR that is represented by keeping the
BN as an affine epilogue on the producer (epilogue_attrs carries s,o) —
the back end applies activation-then-affine before the store.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..graph import Graph, Node
from .manager import register_pass


def _bn_scale_offset(g: Graph, bn: Node) -> Tuple[np.ndarray, np.ndarray]:
    gamma = g.params[bn.params["gamma"]]
    beta = g.params[bn.params["beta"]]
    mean = g.params[bn.params["mean"]]
    var = g.params[bn.params["var"]]
    eps = bn.attrs["epsilon"]
    s = gamma / np.sqrt(var + eps)
    o = beta - s * mean
    return s.astype(np.float32), o.astype(np.float32)


def _scale_output_channels(g: Graph, node: Node, s: np.ndarray, o: np.ndarray) -> None:
    """Fold y = s*conv(x)+o into the conv/dense weights (BN-after case)."""
    k = g.params[node.params["kernel"]]
    if node.op in ("conv2d", "dense"):
        g.params[node.params["kernel"]] = (k * s).astype(np.float32)  # last axis = cout
    elif node.op == "depthwise_conv2d":
        kh, kw, c, mult = k.shape
        g.params[node.params["kernel"]] = (
            k * s.reshape(c, mult)
        ).astype(np.float32)
    else:  # pragma: no cover - guarded by caller
        raise AssertionError(node.op)
    if "bias" in node.params:
        b = g.params[node.params["bias"]]
        g.params[node.params["bias"]] = (s * b + o).astype(np.float32)
    else:
        bname = f"{node.name}/folded_bias"
        g.params[bname] = o.astype(np.float32)
        node.params["bias"] = bname


def _scale_input_channels(g: Graph, node: Node, s: np.ndarray, o: np.ndarray) -> None:
    """Fold conv(s*x+o) into the conv/dense weights (BN-before case)."""
    k = g.params[node.params["kernel"]]
    if node.op == "dense":
        g.params[node.params["kernel"]] = (k * s[:, None]).astype(np.float32)
        extra = k.T @ o  # (cout,)
    elif node.op == "conv2d":
        g.params[node.params["kernel"]] = (k * s[None, None, :, None]).astype(
            np.float32
        )
        extra = np.einsum("hwio,i->o", k, o)
    else:  # depthwise: each channel independent
        kh, kw, c, mult = k.shape
        g.params[node.params["kernel"]] = (k * s[None, None, :, None]).astype(
            np.float32
        )
        extra = (k.sum(axis=(0, 1)) * o[:, None]).reshape(-1)
    if "bias" in node.params:
        b = g.params[node.params["bias"]]
        g.params[node.params["bias"]] = (b + extra).astype(np.float32)
    else:
        bname = f"{node.name}/folded_bias"
        g.params[bname] = extra.astype(np.float32)
        node.params["bias"] = bname


@register_pass("fold_batchnorm", after=("canonicalize",))
def fold_batchnorm(graph: Graph) -> Tuple[Graph, Dict]:
    g = graph.copy()
    folded_after = folded_before = affine_epilogue = 0

    changed = True
    while changed:
        changed = False
        for bn in list(g.nodes):
            if bn.op != "batchnorm":
                continue
            src = g.producer(bn.inputs[0])
            consumers = g.consumers(bn.output)

            # Case 1: conv/dense -> BN  (fold into producer's output chans)
            if (
                src is not None
                and src.op in ("conv2d", "depthwise_conv2d", "dense")
                and src.epilogue in (None, "linear")
                and len(g.consumers(src.output)) == 1
            ):
                s, o = _bn_scale_offset(g, bn)
                # depthwise conv2d with stride: only valid if padding didn't
                # change channel semantics — always safe for BN-after.
                _scale_output_channels(g, src, s, o)
                _remove_node(g, bn)
                folded_after += 1
                changed = True
                continue

            # Case 1b: conv/dense -> activation -> BN.  Paper: "the batch
            # normalization is still fused into the other layer and
            # applied after the activation".  Represent as an affine
            # epilogue on the producer.
            if (
                src is not None
                and src.op in ("conv2d", "depthwise_conv2d", "dense")
                and src.epilogue not in (None, "linear")
                and len(g.consumers(src.output)) == 1
                and src.epilogue != "softmax"
            ):
                s, o = _bn_scale_offset(g, bn)
                sname = f"{bn.name}/scale"
                oname = f"{bn.name}/offset"
                g.params[sname] = s
                g.params[oname] = o
                src.epilogue_attrs = dict(src.epilogue_attrs)
                src.epilogue_attrs["post_affine"] = (sname, oname)
                _remove_node(g, bn)
                affine_epilogue += 1
                changed = True
                continue

            # Case 2: BN -> conv/dense  (fold into consumer's input chans).
            # For convs this is only exact with 'valid' padding: with
            # 'same' padding the folded bias correction W·o would also be
            # added at taps that originally saw zero padding, not s*x+o.
            if (
                len(consumers) == 1
                and (
                    consumers[0].op == "dense"
                    or (
                        consumers[0].op in ("conv2d", "depthwise_conv2d")
                        and consumers[0].attrs.get("padding") == "valid"
                    )
                )
                and bn.output not in g.outputs
            ):
                s, o = _bn_scale_offset(g, bn)
                _scale_input_channels(g, consumers[0], s, o)
                _remove_node(g, bn)
                folded_before += 1
                changed = True
                continue
    g.rebuild_index()
    return g, {
        "folded_after": folded_after,
        "folded_before": folded_before,
        "affine_epilogue": affine_epilogue,
    }


def _remove_node(g: Graph, node: Node) -> None:
    """Remove a single-input node, rewiring consumers to its input."""
    src_tensor = node.inputs[0]
    for other in g.nodes:
        other.inputs = [src_tensor if t == node.output else t for t in other.inputs]
    g.outputs = [src_tensor if t == node.output else t for t in g.outputs]
    g.nodes.remove(node)
    g.rebuild_index()
