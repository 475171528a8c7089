"""Neural-network graph IR — the compiler's input.

The PyTorch port's copy of the IR, kept identical to the JAX package's
``repro.core.graph`` (it is numpy-only) so that a graph, its
``structure_hash`` and its ``.npz`` container mean the same thing in
both packages.  Every optimization pass in ``repro_torch.core.passes``
consumes and produces this IR; the back end
(``repro_torch.core.lowering``) walks it to emit torch ops, and the
oracle (``repro_torch.core.simple``) interprets it node by node.

Design notes
------------
* Tensors are identified by string names; ``Graph.params`` maps names of
  constant tensors (weights) to host numpy arrays.  Keeping weights as
  named constants is what lets passes rewrite them (BN folding, layout
  transformation) — the paper's "weights are compile-time constants so
  their layout is free" (Eq. 3) is only expressible if weights live in
  the IR.
* Shapes use NHWC for image tensors (TPU-native layout; the paper used
  HWC on x86 for the same streaming-friendliness reason).
* The IR is deliberately small: exactly the ops needed for the paper's
  Table-1 network suite plus generic elementwise/reduction ops.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


def _conv_out_hw(h, w, kh, kw, sh, sw, padding):
    """Output spatial dims for 'same'/'valid'/explicit ((t,b),(l,r)) padding."""
    if padding == "same":
        return -(-h // sh), -(-w // sw)
    if padding == "valid":
        return (h - kh) // sh + 1, (w - kw) // sw + 1
    (t, b), (l, r) = padding
    return (h + t + b - kh) // sh + 1, (w + l + r - kw) // sw + 1


# Ops understood by the IR.  Each entry: op name -> required attrs.
OPS: Dict[str, Tuple[str, ...]] = {
    "input": (),
    "constant": (),
    "conv2d": ("strides", "padding"),          # weights: (kh, kw, cin, cout)
    "depthwise_conv2d": ("strides", "padding"),  # weights: (kh, kw, c, mult)
    "dense": (),                                # weights: (cin, cout)
    "batchnorm": ("epsilon",),                  # params: gamma, beta, mean, var
    "activation": ("fn",),                      # fn in ACTIVATIONS
    "maxpool2d": ("pool_size", "strides", "padding"),
    "avgpool2d": ("pool_size", "strides", "padding"),
    "global_avg_pool": (),
    "upsample2d": ("factor",),                  # nearest-neighbour
    "zero_pad2d": ("padding",),                 # ((t,b),(l,r))
    "add": (),
    "mul": (),
    "concat": ("axis",),
    "reshape": ("shape",),
    "flatten": (),
    "softmax": ("axis",),
    # inputs: q (H,D), k_cache (S,Hkv,D), v_cache (S,Hkv,D)
    # [, lengths () int32]; optional attr "scale" (default D**-0.5)
    "decode_attention": (),
}


def register_op(name: str, required_attrs: Sequence[str] = ()) -> None:
    """Extend the IR vocabulary with a new op (idempotent).  Pair with
    :func:`register_shape_rule` and a ``repro_torch.core.lowering``
    ``@register_lowering`` rule to make it compilable end to end."""
    OPS[name] = tuple(required_attrs)


#: Shape-inference rules for ops registered from outside this module:
#: op -> fn(node, input_specs, graph) -> TensorSpec.  Consulted before
#: the built-in rules, so a plug-in op never edits ``_infer_node``.
SHAPE_RULES: Dict[str, Any] = {}


def register_shape_rule(op: str):
    """Decorator: register the static shape rule for ``op``."""

    def deco(fn):
        SHAPE_RULES[op] = fn
        return fn

    return deco

#: Activation functions the compiler understands.  ``fusable`` means the
#: back end may apply them as an epilogue of a producing matmul/conv
#: (paper §3.4: applied in registers before the store).
ACTIVATIONS = {
    "linear": True,
    "relu": True,
    "relu6": True,
    "leaky_relu": True,
    "sigmoid": True,   # via tanh identity, Eq. 4
    "tanh": True,
    "elu": True,
    "hard_sigmoid": True,
    "softmax": False,  # two-pass, never fusable (paper §3.4)
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape+dtype of an IR tensor (batch dim excluded; the compiler
    specializes on the batch size separately, like the paper specializes
    on the input shape)."""

    shape: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.size * np.dtype(self.dtype).itemsize


@dataclasses.dataclass(frozen=True)
class Signature:
    """First-class model I/O: ordered, named, multi-input *and*
    multi-output.

    ``inputs`` and ``outputs`` are ordered ``(name, spec)`` pairs.  The
    names are the *public* contract — what ``Executable.__call__``
    binds positionally-or-by-keyword and what the output dict is keyed
    by — independent of the SSA tensor names inside the graph.  A
    ``spec`` may be ``None`` for executables whose shapes are not
    statically known (the framework-scale "engine" target).
    """

    inputs: Tuple[Tuple[str, Optional[TensorSpec]], ...]
    outputs: Tuple[Tuple[str, Optional[TensorSpec]], ...]

    @property
    def input_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.inputs)

    @property
    def output_names(self) -> Tuple[str, ...]:
        return tuple(n for n, _ in self.outputs)

    def bind(self, args: Sequence[Any], kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Positional-or-keyword binding of call arguments to input
        names (missing-input checks are left to the caller, which knows
        how to phrase its own diagnostic)."""
        names = self.input_names
        if len(args) > len(names):
            raise TypeError(
                f"got {len(args)} positional inputs; signature takes "
                f"{len(names)}: {list(names)}")
        bound = dict(zip(names, args))
        for k, v in kwargs.items():
            if k in bound:
                raise TypeError(f"got multiple values for input {k!r}")
            bound[k] = v
        return bound

    # -- (de)serialization --------------------------------------------
    @staticmethod
    def _spec_dict(spec: Optional[TensorSpec]):
        if spec is None:
            return None
        return {"shape": list(spec.shape), "dtype": spec.dtype}

    @staticmethod
    def _spec_from(d) -> Optional[TensorSpec]:
        if d is None:
            return None
        return TensorSpec(tuple(d["shape"]), d["dtype"])

    def to_dict(self) -> dict:
        return {
            "inputs": [[n, self._spec_dict(s)] for n, s in self.inputs],
            "outputs": [[n, self._spec_dict(s)] for n, s in self.outputs],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Signature":
        return cls(
            inputs=tuple((n, cls._spec_from(s)) for n, s in d["inputs"]),
            outputs=tuple((n, cls._spec_from(s)) for n, s in d["outputs"]),
        )

    def cache_token(self) -> str:
        """Stable string for the persistent executable-cache key: two
        compilations whose public I/O contract differs (names, order,
        shapes) must never share a cached program."""
        return json.dumps(self.to_dict(), sort_keys=True)


@dataclasses.dataclass
class Node:
    """One IR node.  ``params`` holds names of weight tensors in
    ``Graph.params``; ``attrs`` holds static attributes.

    ``epilogue`` is filled in by the activation-fusion pass: the name of
    an activation to apply to this node's output inside the producing
    kernel (the paper's "before writing the result into memory").
    """

    op: str
    name: str
    inputs: List[str]
    output: str
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    params: Dict[str, str] = dataclasses.field(default_factory=dict)
    epilogue: Optional[str] = None
    epilogue_attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r} in node {self.name!r}")
        for attr in OPS[self.op]:
            if attr not in self.attrs:
                raise ValueError(
                    f"node {self.name!r} (op {self.op}) missing attr {attr!r}"
                )


class Graph:
    """A static NN graph: nodes in insertion order + named weights.

    The graph is SSA-like: every tensor name is produced by exactly one
    node (or is a graph input); nodes may consume any previously
    produced tensor.
    """

    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.inputs: Dict[str, TensorSpec] = {}
        self.outputs: List[str] = []
        self.params: Dict[str, np.ndarray] = {}
        self._producers: Dict[str, Node] = {}
        # Public output names (None = default to the tensor names).
        self._output_names: Optional[List[str]] = None
        # Incrementally-maintained shape specs: add_input/add_node keep
        # it current so construction-time queries (ModelBuilder, the
        # tracer) are O(1) per layer instead of re-inferring the whole
        # graph.  Any mutation outside those two paths invalidates it
        # (None), and infer_shapes() falls back to the full walk.
        self._spec_cache: Optional[Dict[str, TensorSpec]] = {}
        # Distribution annotations (repro.dist): {"mesh", "rules"} set
        # by a sharded compile, {"shardings", "edits"} added by the
        # propagation pass.  None = unsharded; mixed into
        # structure_hash() only when set, so unsharded hashes (and
        # every existing cache key) are unchanged.
        self.dist: Optional[Dict[str, Any]] = None
        # Quantization request (repro.core.passes.quantize): {"mode",
        # "calibrate", "budget", ...} set by a low-precision compile;
        # the pass consumes it and annotates nodes with quant.* attrs.
        # Same contract as `dist`: None = full precision, mixed into
        # structure_hash() only when set so f32 cache keys are
        # unchanged.
        self.quant: Optional[Dict[str, Any]] = None

    # -- construction -------------------------------------------------
    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        if name in self.inputs or name in self._producers:
            raise ValueError(f"duplicate tensor name {name!r}")
        self.inputs[name] = TensorSpec(tuple(shape), dtype)
        if self._spec_cache is not None:
            self._spec_cache[name] = self.inputs[name]
        return name

    def add_param(self, name: str, value: np.ndarray) -> str:
        if name in self.params:
            raise ValueError(f"duplicate param name {name!r}")
        self.params[name] = np.asarray(value, dtype=np.float32)
        return name

    def add_node(
        self,
        op: str,
        name: str,
        inputs: Sequence[str],
        output: Optional[str] = None,
        attrs: Optional[Dict[str, Any]] = None,
        params: Optional[Dict[str, str]] = None,
    ) -> str:
        output = output or f"{name}:out"
        if output in self._producers or output in self.inputs:
            raise ValueError(f"duplicate tensor name {output!r}")
        for t in inputs:
            if t not in self._producers and t not in self.inputs:
                raise ValueError(f"node {name!r} consumes unknown tensor {t!r}")
        node = Node(
            op=op,
            name=name,
            inputs=list(inputs),
            output=output,
            attrs=dict(attrs or {}),
            params=dict(params or {}),
        )
        node.validate()
        for p in node.params.values():
            if p not in self.params:
                raise ValueError(f"node {name!r} references unknown param {p!r}")
        self.nodes.append(node)
        self._producers[output] = node
        if self._spec_cache is not None:
            try:
                self._spec_cache[output] = self._infer_node(
                    node, self._spec_cache)
            except Exception:
                # Not inferable right now (missing input spec, plug-in
                # rule quirk, genuinely invalid graph): drop the cache;
                # infer_shapes() will recompute — and surface the real
                # error where it always has.
                self._spec_cache = None
        return output

    def set_outputs(self, names) -> None:
        """Declare the graph outputs.

        ``names`` is either a sequence of tensor names (public output
        names default to the tensor names) or a mapping of *public name
        -> tensor name*, which gives the outputs user-chosen names —
        the multi-output half of the graph's :class:`Signature`.
        """
        if isinstance(names, dict):
            public, tensors = list(names.keys()), list(names.values())
        else:
            public, tensors = None, list(names)
        for n in tensors:
            if n not in self._producers and n not in self.inputs:
                raise ValueError(f"unknown output tensor {n!r}")
        if public is not None and len(set(public)) != len(public):
            raise ValueError(f"duplicate output names {public}")
        self.outputs = tensors
        self._output_names = public

    @property
    def output_names(self) -> List[str]:
        """Public output names, parallel to ``outputs`` (defaults to
        the tensor names when none were chosen)."""
        if (self._output_names is not None
                and len(self._output_names) == len(self.outputs)):
            return list(self._output_names)
        return list(self.outputs)

    def signature(self) -> Signature:
        """The graph's public I/O contract (names + static specs)."""
        specs = self.infer_shapes()
        return Signature(
            inputs=tuple(self.inputs.items()),
            outputs=tuple((pub, specs[t])
                          for pub, t in zip(self.output_names, self.outputs)),
        )

    # -- queries ------------------------------------------------------
    def producer(self, tensor: str) -> Optional[Node]:
        return self._producers.get(tensor)

    def consumers(self, tensor: str) -> List[Node]:
        return [n for n in self.nodes if tensor in n.inputs]

    def rebuild_index(self) -> None:
        """Recompute the producer index after passes mutate ``nodes``."""
        self._producers = {n.output: n for n in self.nodes}
        self._spec_cache = None

    def toposort(self) -> List[Node]:
        """Nodes are appended in topological order by construction, but
        passes may reorder; verify and return a valid order."""
        available = set(self.inputs)
        order: List[Node] = []
        pending = list(self.nodes)
        while pending:
            progressed = False
            rest: List[Node] = []
            for node in pending:
                if all(t in available for t in node.inputs):
                    order.append(node)
                    available.add(node.output)
                    progressed = True
                else:
                    rest.append(node)
            if not progressed:
                names = [n.name for n in rest]
                raise ValueError(f"graph has a cycle or dangling inputs: {names}")
            pending = rest
        return order

    # -- shape inference ---------------------------------------------
    def infer_shapes(self) -> Dict[str, TensorSpec]:
        """Static shape inference over the whole graph.

        This is the compile-time knowledge the paper exploits: every
        intermediate tensor's shape is known before any code runs.
        """
        if (self._spec_cache is not None
                and len(self._spec_cache) == len(self.inputs) + len(self.nodes)):
            return dict(self._spec_cache)
        specs: Dict[str, TensorSpec] = dict(self.inputs)
        for node in self.toposort():
            specs[node.output] = self._infer_node(node, specs)
        self._spec_cache = dict(specs)
        return specs

    def spec(self, tensor: str) -> TensorSpec:
        """Static spec of one tensor — O(1) during construction (the
        incremental cache), a full inference otherwise."""
        if self._spec_cache is not None and tensor in self._spec_cache:
            return self._spec_cache[tensor]
        return self.infer_shapes()[tensor]

    def _infer_node(self, node: Node, specs: Dict[str, TensorSpec]) -> TensorSpec:
        op = node.op
        ins = [specs[t] for t in node.inputs]
        if op in SHAPE_RULES:
            return SHAPE_RULES[op](node, ins, self)
        if op == "constant":
            return TensorSpec(tuple(self.params[node.params["value"]].shape))
        if op == "conv2d":
            h, w, _ = ins[0].shape
            kh, kw, _, cout = self.params[node.params["kernel"]].shape
            sh, sw = node.attrs["strides"]
            oh, ow = _conv_out_hw(h, w, kh, kw, sh, sw, node.attrs["padding"])
            return TensorSpec((oh, ow, cout))
        if op == "depthwise_conv2d":
            h, w, c = ins[0].shape
            kh, kw, _, mult = self.params[node.params["kernel"]].shape
            sh, sw = node.attrs["strides"]
            oh, ow = _conv_out_hw(h, w, kh, kw, sh, sw, node.attrs["padding"])
            return TensorSpec((oh, ow, c * mult))
        if op == "dense":
            kshape = self.params[node.params["kernel"]].shape
            if node.attrs.get("kernel_layout") == "oi":
                cout, cin = kshape
            else:
                cin, cout = kshape
            # The layout pass may have padded cout; the logical width is
            # the original (the back end slices the padding off).
            cout = node.attrs.get("orig_cout", cout)
            if ins[0].shape[-1] != cin:
                raise ValueError(
                    f"dense {node.name!r}: input {ins[0].shape} vs kernel cin {cin}"
                )
            return TensorSpec(ins[0].shape[:-1] + (cout,))
        if op in ("batchnorm", "activation"):
            return ins[0]
        if op in ("maxpool2d", "avgpool2d"):
            h, w, c = ins[0].shape
            ph, pw = node.attrs["pool_size"]
            sh, sw = node.attrs["strides"]
            oh, ow = _conv_out_hw(h, w, ph, pw, sh, sw, node.attrs["padding"])
            return TensorSpec((oh, ow, c))
        if op == "global_avg_pool":
            return TensorSpec((ins[0].shape[-1],))
        if op == "upsample2d":
            h, w, c = ins[0].shape
            f = node.attrs["factor"]
            return TensorSpec((h * f, w * f, c))
        if op == "zero_pad2d":
            (t, b), (l, r) = node.attrs["padding"]
            h, w, c = ins[0].shape
            return TensorSpec((h + t + b, w + l + r, c))
        if op in ("add", "mul"):
            if ins[0].shape != ins[1].shape:
                raise ValueError(f"{op} {node.name!r}: shape mismatch {ins}")
            return ins[0]
        if op == "concat":
            ax = node.attrs["axis"]
            shape = list(ins[0].shape)
            shape[ax] = sum(s.shape[ax] for s in ins)
            return TensorSpec(tuple(shape))
        if op == "reshape":
            return TensorSpec(tuple(node.attrs["shape"]))
        if op == "flatten":
            return TensorSpec((ins[0].size,))
        if op == "softmax":
            return ins[0]
        if op == "decode_attention":
            h, d = ins[0].shape
            s, hkv, dk = ins[1].shape
            if ins[1].shape != ins[2].shape:
                raise ValueError(
                    f"{op} {node.name!r}: K/V cache shapes differ "
                    f"{ins[1].shape} vs {ins[2].shape}")
            if dk != d or h % hkv:
                raise ValueError(
                    f"{op} {node.name!r}: q (H={h}, D={d}) incompatible "
                    f"with cache (Hkv={hkv}, D={dk}); H must be a "
                    f"multiple of Hkv")
            return ins[0]
        raise NotImplementedError(op)

    # -- hashing (compile-cache key) ----------------------------------
    def structure_hash(self) -> str:
        """Hash of the graph structure + shapes (not weight values).

        Used as the compile-cache key: two models with identical
        architecture share a compiled program when weights are passed as
        arguments (framework mode); in embed_weights mode the weight
        hash is mixed in by the compiler.
        """
        payload = {
            "inputs": {k: (v.shape, v.dtype) for k, v in self.inputs.items()},
            "outputs": self.outputs,
            "output_names": self.output_names,
            "nodes": [
                (
                    n.op,
                    n.name,
                    tuple(n.inputs),
                    n.output,
                    json.dumps(n.attrs, sort_keys=True, default=str),
                    tuple(sorted(n.params.items())),
                    n.epilogue,
                    json.dumps(n.epilogue_attrs, sort_keys=True, default=str),
                )
                for n in self.nodes
            ],
            "param_shapes": {k: v.shape for k, v in sorted(self.params.items())},
        }
        if self.dist:
            payload["dist"] = self.dist
        if self.quant:
            payload["quant"] = self.quant
        blob = json.dumps(payload, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()

    def copy(self) -> "Graph":
        g = Graph()
        g.inputs = dict(self.inputs)
        g.outputs = list(self.outputs)
        g.params = {k: v.copy() for k, v in self.params.items()}
        g.nodes = [
            Node(
                op=n.op,
                name=n.name,
                inputs=list(n.inputs),
                output=n.output,
                attrs=dict(n.attrs),
                params=dict(n.params),
                epilogue=n.epilogue,
                epilogue_attrs=dict(n.epilogue_attrs),
            )
            for n in self.nodes
        ]
        g.rebuild_index()
        g._output_names = (list(self._output_names)
                           if self._output_names is not None else None)
        g._spec_cache = (dict(self._spec_cache)
                         if self._spec_cache is not None else None)
        if self.dist is not None:
            import copy as _copy
            g.dist = _copy.deepcopy(self.dist)
        if self.quant is not None:
            import copy as _copy
            g.quant = _copy.deepcopy(self.quant)
        return g

    def summary(self) -> str:
        specs = self.infer_shapes()
        lines = [f"Graph: {len(self.nodes)} nodes, {len(self.params)} params"]
        for node in self.nodes:
            epi = f" +{node.epilogue}" if node.epilogue else ""
            lines.append(
                f"  {node.name:<24} {node.op:<18}{epi:<12} -> {specs[node.output].shape}"
            )
        return "\n".join(lines)
