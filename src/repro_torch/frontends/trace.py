"""``repro_torch.trace`` — compile plain Python functions.

The port of ``repro.frontends.trace``.  The tracer runs a user callable
once over *abstract* arguments (:class:`TracedTensor`, shape+dtype only,
no data) and records every operation into the graph IR, so a model
written as an ordinary function in this module's small namespace
compiles through the full pass/selection/kernel pipeline on every
target::

    import numpy as np
    import repro_torch
    from repro_torch.frontends import ops as F

    w = np.random.default_rng(0).standard_normal((3, 4), np.float32)

    def model(image):
        h = F.relu(F.dense(F.global_avg_pool(image), w))
        return {"probs": F.softmax(h)}

    graph = repro_torch.trace(model, (8, 8, 3))     # specs exclude batch
    exe = repro_torch.compile(graph, repro_torch.CompileOptions(
        target="cuda"))
    exe(image=x)["probs"]                           # named I/O end to end

Weights are plain numpy arrays closed over (or passed into) the
function; the tracer interns them as graph params — passing the *same*
array object twice shares one param (weight tying).  Input names come
from the function's parameter names; output names from the returned
dict's keys (a bare tensor becomes ``"output"``, a tuple
``"output_0"``, ``"output_1"``, …) — together they form the graph's
:class:`~repro_torch.core.graph.Signature`.

It records *graph-IR* ops (dense/conv2d/…), not torch operators, so the
result is exactly what ``ModelBuilder`` would have built, and what the
reference's ``repro.trace`` records from the same function and weights
(the same node names, params and ``structure_hash()``).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.graph import ACTIVATIONS, Graph, Signature, TensorSpec


class TraceError(TypeError):
    """A traced function did something the tracer cannot record."""


class TracedTensor:
    """Abstract value flowing through a traced function: a tensor name
    plus its static spec.  Supports ``+``, ``*`` (elementwise, against
    tensors or numpy constants) and ``@`` (dense against a numpy
    kernel); everything else goes through the :mod:`ops <.trace>`
    namespace."""

    __slots__ = ("tracer", "name", "spec")

    # Make numpy defer to __radd__/__rmul__ when a TracedTensor is the
    # RIGHT operand of an ndarray (`w * x`): without this, ndarray.__mul__
    # would broadcast elementwise over the abstract tensor and emit one
    # stray node per element instead of a single op.
    __array_ufunc__ = None

    def __init__(self, tracer: "Tracer", name: str, spec: TensorSpec) -> None:
        self.tracer = tracer
        self.name = name
        self.spec = spec

    # -- numpy-ish surface ---------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.spec.shape

    @property
    def dtype(self) -> str:
        return self.spec.dtype

    @property
    def ndim(self) -> int:
        return len(self.spec.shape)

    def reshape(self, shape: Sequence[int]) -> "TracedTensor":
        return reshape(self, shape)

    def flatten(self) -> "TracedTensor":
        return flatten(self)

    def __add__(self, other):
        return add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        return mul(self, other)

    __rmul__ = __mul__

    def __matmul__(self, kernel):
        return dense(self, kernel)

    def __repr__(self) -> str:
        return f"TracedTensor({self.name!r}, shape={self.shape}, dtype={self.dtype})"

    def __bool__(self):
        raise TraceError(
            f"cannot branch on the value of abstract tensor {self.name!r}: "
            f"the tracer records a static graph (shapes are available as "
            f"`.shape` for Python-level control flow)")


class Tracer:
    """Records ops emitted on its :class:`TracedTensor`\\ s into a Graph."""

    def __init__(self) -> None:
        self.graph = Graph()
        self._counts: Dict[str, int] = {}
        self._param_memo: Dict[int, str] = {}

    def _name(self, kind: str) -> str:
        n = self._counts.get(kind, 0) + 1
        self._counts[kind] = n
        return f"{kind}_{n}"

    def add_input(self, name: str, spec: TensorSpec) -> TracedTensor:
        self.graph.add_input(name, spec.shape, spec.dtype)
        return TracedTensor(self, name, spec)

    def intern_param(self, node_name: str, role: str, value) -> str:
        """Register a weight array as a graph param; the same array
        *object* maps to the same param (weight tying)."""
        key = id(value)
        if key in self._param_memo:
            return self._param_memo[key][1]
        arr = np.asarray(value, dtype=np.float32)
        pname = self.graph.add_param(f"{node_name}/{role}", arr)
        # The memo is id()-keyed, so it must keep ``value`` alive: a
        # collected temporary's id could be recycled for a *different*
        # array, which would silently alias two distinct weights.
        self._param_memo[key] = (value, pname)
        return pname

    def emit(self, op: str, kind: str, inputs: Sequence[TracedTensor],
             attrs: Optional[dict] = None,
             params: Optional[Dict[str, Any]] = None) -> TracedTensor:
        """Append one IR node; returns the traced output tensor."""
        for t in inputs:
            if t.tracer is not self:
                raise TraceError(
                    f"tensor {t.name!r} belongs to a different trace")
        name = self._name(kind)
        pnames = {role: self.intern_param(name, role, v)
                  for role, v in (params or {}).items()}
        out = self.graph.add_node(op, name, [t.name for t in inputs],
                                  attrs=attrs, params=pnames)
        return TracedTensor(self, out, self.graph.spec(out))


def _as_spec(s) -> TensorSpec:
    if isinstance(s, TensorSpec):
        return s
    if isinstance(s, (tuple, list)) and all(isinstance(d, int) for d in s):
        return TensorSpec(tuple(s))
    raise TypeError(
        f"input spec must be a TensorSpec or a shape tuple (batch dim "
        f"excluded), got {s!r}")


def _input_names(fn, n: int, given: Optional[Sequence[str]]) -> List[str]:
    if given is not None:
        if len(given) != n:
            raise TypeError(f"{len(given)} input_names for {n} specs")
        return list(given)
    try:
        params = [p.name for p in inspect.signature(fn).parameters.values()
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    except (TypeError, ValueError):
        params = []
    if len(params) >= n:
        return params[:n]
    return [f"input_{i}" if n > 1 else "input" for i in range(n)]


def trace(fn, *specs, input_names: Optional[Sequence[str]] = None) -> Graph:
    """Trace ``fn`` over abstract inputs and return the recorded graph.

    Each spec is a :class:`TensorSpec` or a bare shape tuple (the batch
    dimension is excluded, as everywhere in the IR).  ``fn`` receives
    one :class:`TracedTensor` per spec and must return a traced tensor,
    a tuple of them, or a dict of user-chosen output names to tensors —
    the dict form names the outputs in the resulting
    :class:`~repro_torch.core.graph.Signature`.
    """
    if not specs:
        raise TypeError("trace() needs at least one input spec")
    tracer = Tracer()
    names = _input_names(fn, len(specs), input_names)
    args = [tracer.add_input(n, _as_spec(s)) for n, s in zip(names, specs)]
    result = fn(*args)

    if isinstance(result, TracedTensor):
        outputs: List[Tuple[str, TracedTensor]] = [("output", result)]
    elif isinstance(result, dict):
        outputs = list(result.items())
    elif isinstance(result, (tuple, list)):
        outputs = [(f"output_{i}", t) for i, t in enumerate(result)]
    else:
        raise TraceError(
            f"traced function must return a TracedTensor, tuple, or dict "
            f"of them; got {type(result).__name__}")
    for pub, t in outputs:
        if not isinstance(t, TracedTensor):
            raise TraceError(f"output {pub!r} is {type(t).__name__}, "
                             f"not a TracedTensor")
        if t.tracer is not tracer:
            raise TraceError(f"output {pub!r} belongs to a different trace")
    tracer.graph.set_outputs({pub: t.name for pub, t in outputs})
    return tracer.graph


# ---------------------------------------------------------------------------
# The ops namespace (re-exported as ``repro_torch.frontends.ops``).
# Functions mirror ModelBuilder's layer vocabulary 1:1, so a traced
# function and the equivalent builder model produce the same IR.
# ---------------------------------------------------------------------------
def _tracer_of(*tensors) -> Tracer:
    for t in tensors:
        if isinstance(t, TracedTensor):
            return t.tracer
    raise TraceError("expected at least one TracedTensor argument")


def constant(tracer_or_tensor, value, shape: Optional[Tuple[int, ...]] = None
             ) -> TracedTensor:
    """Materialize a numpy value as a graph constant (broadcast to
    ``shape`` if given — scalars become full tensors so elementwise ops
    see matching shapes)."""
    tracer = (tracer_or_tensor.tracer
              if isinstance(tracer_or_tensor, TracedTensor)
              else tracer_or_tensor)
    v = np.asarray(value, dtype=np.float32)
    if shape is not None and tuple(v.shape) != tuple(shape):
        v = np.ascontiguousarray(np.broadcast_to(v, shape))
    return tracer.emit("constant", "const", [], params={"value": v})


def _coerce(x, like: TracedTensor) -> TracedTensor:
    if isinstance(x, TracedTensor):
        return x
    return constant(like.tracer, x, shape=like.shape)


def add(a, b) -> TracedTensor:
    t = _tracer_of(a, b)
    ref = a if isinstance(a, TracedTensor) else b
    return t.emit("add", "add", [_coerce(a, ref), _coerce(b, ref)])


def mul(a, b) -> TracedTensor:
    t = _tracer_of(a, b)
    ref = a if isinstance(a, TracedTensor) else b
    return t.emit("mul", "mul", [_coerce(a, ref), _coerce(b, ref)])


def dense(x: TracedTensor, kernel, bias=None,
          activation: Optional[str] = None) -> TracedTensor:
    """``x @ kernel (+ bias)``; kernel is a numpy array of (cin, cout)."""
    params = {"kernel": kernel}
    if bias is not None:
        params["bias"] = bias
    out = x.tracer.emit("dense", "dense", [x], params=params)
    return _activation(out, activation) if activation else out


def conv2d(x: TracedTensor, kernel, bias=None, strides=(1, 1),
           padding="same", activation: Optional[str] = None) -> TracedTensor:
    """NHWC conv; kernel is (kh, kw, cin, cout)."""
    params = {"kernel": kernel}
    if bias is not None:
        params["bias"] = bias
    out = x.tracer.emit(
        "conv2d", "conv2d", [x],
        attrs={"strides": tuple(strides), "padding": padding}, params=params)
    return _activation(out, activation) if activation else out


def depthwise_conv2d(x: TracedTensor, kernel, bias=None, strides=(1, 1),
                     padding="same",
                     activation: Optional[str] = None) -> TracedTensor:
    """Depthwise NHWC conv; kernel is (kh, kw, c, mult)."""
    params = {"kernel": kernel}
    if bias is not None:
        params["bias"] = bias
    out = x.tracer.emit(
        "depthwise_conv2d", "dwconv2d", [x],
        attrs={"strides": tuple(strides), "padding": padding}, params=params)
    return _activation(out, activation) if activation else out


def batchnorm(x: TracedTensor, gamma, beta, mean, var,
              epsilon: float = 1e-3) -> TracedTensor:
    return x.tracer.emit(
        "batchnorm", "bn", [x], attrs={"epsilon": epsilon},
        params={"gamma": gamma, "beta": beta, "mean": mean, "var": var})


def _activation(x: TracedTensor, fn: str, **attrs) -> TracedTensor:
    if fn not in ACTIVATIONS:
        raise TraceError(f"unknown activation {fn!r}; "
                         f"known: {sorted(ACTIVATIONS)}")
    return x.tracer.emit("activation", f"act_{fn}", [x],
                         attrs={"fn": fn, **attrs})


activation = _activation


def relu(x):
    return _activation(x, "relu")


def relu6(x):
    return _activation(x, "relu6")


def leaky_relu(x, alpha: float = 0.2):
    return _activation(x, "leaky_relu", alpha=alpha)


def sigmoid(x):
    return _activation(x, "sigmoid")


def tanh(x):
    return _activation(x, "tanh")


def elu(x):
    return _activation(x, "elu")


def hard_sigmoid(x):
    return _activation(x, "hard_sigmoid")


def maxpool(x: TracedTensor, pool_size=(2, 2), strides=None,
            padding="valid") -> TracedTensor:
    return x.tracer.emit(
        "maxpool2d", "maxpool", [x],
        attrs={"pool_size": tuple(pool_size),
               "strides": tuple(strides or pool_size), "padding": padding})


def avgpool(x: TracedTensor, pool_size=(2, 2), strides=None,
            padding="valid") -> TracedTensor:
    return x.tracer.emit(
        "avgpool2d", "avgpool", [x],
        attrs={"pool_size": tuple(pool_size),
               "strides": tuple(strides or pool_size), "padding": padding})


def global_avg_pool(x: TracedTensor) -> TracedTensor:
    return x.tracer.emit("global_avg_pool", "gap", [x])


def upsample(x: TracedTensor, factor: int = 2) -> TracedTensor:
    return x.tracer.emit("upsample2d", "up", [x], attrs={"factor": factor})


def zero_pad(x: TracedTensor, padding=((1, 1), (1, 1))) -> TracedTensor:
    return x.tracer.emit("zero_pad2d", "pad", [x],
                         attrs={"padding": tuple(map(tuple, padding))})


def concat(xs: Sequence[TracedTensor], axis: int = -1) -> TracedTensor:
    t = _tracer_of(*xs)
    axis = axis % len(xs[0].shape)
    return t.emit("concat", "concat", list(xs), attrs={"axis": axis})


def reshape(x: TracedTensor, shape: Sequence[int]) -> TracedTensor:
    return x.tracer.emit("reshape", "reshape", [x],
                         attrs={"shape": tuple(shape)})


def flatten(x: TracedTensor) -> TracedTensor:
    return x.tracer.emit("flatten", "flatten", [x])


def softmax(x: TracedTensor, axis: int = -1) -> TracedTensor:
    return x.tracer.emit("softmax", "softmax", [x], attrs={"axis": axis})


def decode_attention(q: TracedTensor, k_cache: TracedTensor,
                     v_cache: TracedTensor,
                     lengths: Optional[TracedTensor] = None,
                     scale: Optional[float] = None) -> TracedTensor:
    """Single-token GQA decode attention over a KV cache: ``q`` is (H, D),
    the caches (S, Hkv, D), ``lengths`` an optional int32 scalar input of
    valid context lengths.  The ``cuda`` target runs it in the
    ``decode_attention`` kernel."""
    ins = [q, k_cache, v_cache] + ([lengths] if lengths is not None else [])
    attrs = {} if scale is None else {"scale": float(scale)}
    return q.tracer.emit("decode_attention", "attn", ins, attrs=attrs)
