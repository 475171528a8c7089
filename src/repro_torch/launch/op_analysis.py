"""What one call of a program costs, read from its dispatched op stream.

The port's counterpart of ``repro.launch.hlo_analysis``.  The name
differs because there is no HLO to read: the port runs eagerly, one op
at a time, so its program is the stream of ATen and c10d ops a call
dispatches, and a ``TorchDispatchMode`` (:class:`OpCounter`) sees every
one of them, forward, backward and ``remat`` recompute alike.  Over one
traced call it counts, for this process (one rank of a mesh):

* **FLOPs**: the matrix, batched-matrix, convolution and attention
  products (2·M·N·K), through ``torch.utils.flop_counter``'s registry;
* **HBM bytes**, the reference's proxy: the result bytes of each op
  that writes a new buffer.  Views and metadata ops count 0.  An op
  that writes into a tensor it was given counts the bytes it writes
  there: the view it was given (``copy_`` into a narrowed slice of a
  cache counts the slice), or, for the scatters (``index_put_``,
  ``index_copy_``, ...), the rows its update holds.  The reference counts
  such an update 0, since the optimised HLO text does not say how large
  it is (ROADMAP C);
* **collective bytes by kind**: the result-buffer bytes of each c10d
  collective (all-gather, all-reduce, reduce-scatter, all-to-all,
  broadcast), which are also HBM writes;
* **peak live bytes**: the most bytes the storages alive at once held,
  the call's arguments included.

It counts on real tensors and on fake ones (``FakeTensorMode``, no
storage), which dispatch the same ops: a dry-run traces a rank's program
on fake tensors of the rank's shapes and allocates nothing.

**Trip counts.**  The reference's analyzer weights each op by the trip
counts of the ``while`` loops around it, since a scanned layer stack
appears once in its HLO.  Here every layer and microbatch runs and can
be counted, but a trace on fake tensors costs about 110 µs an op on a
host core, and one rank's train step of qwen2.5-14b at train_4k
(48 layers, 8 microbatches) dispatches about 9.6M ops: some 1000 s.  So
a cell is traced at the fewest layers and microbatches that hold every
distinct piece of its program, and :func:`weigh` carries those counts to
the cell's: the counts of a program whose layers of each kind repeat
are affine in how many layers of each kind it has, so traces at enough
depths give the coefficients exactly.  Microbatches need no second
trace: each is a ``torch.profiler.record_function("microbatch")`` region
of the train step, whose counts the counter keeps apart
(:attr:`OpTrace.regions`), so one trace at two microbatches gives what
one more adds.  The optimizer and the head run once a step and are not
multiplied.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from fractions import Fraction
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, \
    Optional, Sequence, Tuple

import torch
from torch._C import DispatchKey
from torch.utils._python_dispatch import TorchDispatchMode

#: The collective kinds, in the order a record lists them.
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "broadcast")

#: c10d op -> its kind.  Each writes its result into the buffers of its
#: first argument.
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}

#: Ops that make a tensor without writing it, or that alias their input
#: without saying so in their schema: 0 bytes.
_NO_WRITE = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "_unsafe_view", "_reshape_alias", "lift_fresh",
    "set_", "resize_", "_local_scalar_dense",
})

#: The region a microbatch of the train step runs in.
MICROBATCH = "microbatch"


@dataclasses.dataclass
class OpCost:
    """Counts of one traced call (or of a region of it): FLOPs, HBM bytes
    and collective bytes by kind (:data:`COLLECTIVES`), all integers, and
    the number of ops dispatched."""

    flops: int = 0
    hbm_bytes: int = 0
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    ops: int = 0

    @property
    def collective_total(self) -> int:
        return sum(self.collective_bytes.values())

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops,
                      self.hbm_bytes + other.hbm_bytes,
                      {k: self.collective_bytes[k] + other.collective_bytes[k]
                       for k in COLLECTIVES},
                      self.ops + other.ops)

    def __sub__(self, other: "OpCost") -> "OpCost":
        return self + other.scaled(-1)

    def scaled(self, w) -> "OpCost":
        """Every count times ``w`` (an int or a ``Fraction``), kept exact:
        a sum of scaled costs is rounded by :func:`weigh` at the end."""
        return OpCost(self.flops * w, self.hbm_bytes * w,
                      {k: v * w for k, v in self.collective_bytes.items()},
                      self.ops * w)

    def counters(self) -> Tuple:
        """The counts :func:`weigh` holds to be affine, as one tuple."""
        return (self.flops, self.hbm_bytes,
                *(self.collective_bytes[k] for k in COLLECTIVES), self.ops)

    def as_dict(self) -> Dict[str, Any]:
        coll = dict(self.collective_bytes)
        coll["total"] = self.collective_total
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": coll, "ops": self.ops}


@dataclasses.dataclass
class OpTrace:
    """One traced call: its whole :class:`OpCost`, the cost of each
    ``microbatch`` region in the order they ran (nested in ``cost``),
    the peak live bytes, the bytes of the call's arguments (the storages
    alive when it started, counted once) and of its outputs that are not
    arguments (a donated argument returned is not), and the trace's wall
    seconds."""

    cost: OpCost
    regions: List[OpCost]
    peak_bytes: int
    argument_bytes: int
    output_bytes: int
    seconds: float


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors in ``tree`` (a tensor, or nested lists, tuples and
    mappings of them)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _bound(func, args, kwargs) -> Dict[str, Any]:
    """The op's arguments by schema name."""
    named = {a.name: v for a, v in zip(func._schema.arguments, args)}
    named.update(kwargs)
    return named


def _index_put_bytes(a) -> int:
    """Bytes ``self[indices] = values`` writes: the indexed elements."""
    self, indices = a["self"], list(a["indices"])
    idx = [i for i in indices if i is not None]
    n = 1
    if idx:
        for d in torch.broadcast_shapes(*(i.shape for i in idx)):
            n *= d
    for d, size in enumerate(self.shape):
        if d >= len(indices) or indices[d] is None:
            n *= size
    return n * self.element_size()


def _scatter_bytes(a) -> int:
    return a["index"].numel() * a["self"].element_size()


def _index_fill_bytes(a) -> int:
    self = a["self"]
    per = self.numel() // max(self.shape[a["dim"]], 1)
    return a["index"].numel() * per * self.element_size()


#: In-place scatters: the bytes their update writes (the rest of the
#: buffer is untouched).
_SCATTERS: Dict[str, Callable[[Dict[str, Any]], int]] = {
    "index_put_": _index_put_bytes,
    "_index_put_impl_": _index_put_bytes,
    "index_copy_": lambda a: _nbytes(a["source"]),
    "index_add_": lambda a: _nbytes(a["source"]),
    "scatter_": _scatter_bytes,
    "scatter_add_": _scatter_bytes,
    "scatter_reduce_": _scatter_bytes,
    "index_fill_": _index_fill_bytes,
}


class _Op(NamedTuple):
    """What the counter needs to know of one op overload, worked out
    once: its collective kind, FLOP function, scatter rule, the names
    of the arguments it writes into, which of its returns are new
    buffers, and whether it writes nothing at all."""

    kind: Optional[str]
    flops: Optional[Callable]
    scatter: Optional[Callable[[Dict[str, Any]], int]]
    mutated: Tuple[str, ...]
    fresh: Tuple[bool, ...]
    no_write: bool
    composite: bool


_OPS: Dict[Any, _Op] = {}


def _classify(func) -> _Op:
    from torch.utils.flop_counter import flop_registry
    name = func._overloadpacket.__name__
    schema = func._schema
    return _Op(
        kind=_C10D_KINDS.get(name) if func.namespace == "c10d" else None,
        flops=flop_registry.get(func._overloadpacket),
        scatter=_SCATTERS.get(name),
        mutated=tuple(a.name for a in schema.arguments
                      if a.alias_info is not None and a.alias_info.is_write),
        fresh=tuple(r.alias_info is None for r in schema.returns),
        no_write=name in _NO_WRITE,
        composite=func.namespace == "aten" and (
            DispatchKey.CompositeImplicitAutograd in func.py_kernels
            or torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), DispatchKey.CompositeImplicitAutograd)))


def _info(func) -> _Op:
    op = _OPS.get(func)
    if op is None:
        op = _OPS[func] = _classify(func)
    return op


def written_bytes(func, args, kwargs, out) -> int:
    """HBM bytes one dispatched op writes (module docstring)."""
    op = _info(func)
    if op.no_write:
        return 0
    if op.mutated:
        named = _bound(func, args, kwargs)
        if op.scatter is not None:
            return op.scatter(named)
        return sum(_nbytes(t) for m in op.mutated
                   for t in _leaves(named.get(m)))
    outs = out if len(op.fresh) > 1 else (out,)
    return sum(_nbytes(t) for fresh, o in zip(op.fresh, outs) if fresh
               for t in _leaves(o))


class _Storages:
    """Live storage bytes, and their peak: each storage is added when an
    op first returns it and taken away when it is freed (a weak
    reference's callback)."""

    def __init__(self) -> None:
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}

    def add(self, t: torch.Tensor) -> int:
        st = t.untyped_storage()
        key = id(st)
        ref = self._refs.get(key)
        if ref is not None and ref() is st:
            return 0
        n = st.nbytes()

        def freed(r, key=key, n=n):
            if self._refs.get(key) is r:
                del self._refs[key]
                self.live -= n
        self._refs[key] = weakref.ref(st, freed)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while it is active (module docstring):
    ``cost`` the whole, ``regions`` the cost of each
    ``torch.profiler.record_function("microbatch")`` block in the order
    they ran, ``storages`` the live and peak bytes.  Ops run on other
    threads for this one (autograd's) are counted too: the mode travels
    with autograd's thread-local state."""

    def __init__(self) -> None:
        super().__init__()
        self.cost = OpCost()
        self.regions: List[OpCost] = []
        self.storages = _Storages()
        self._open: List[Optional[OpCost]] = []
        self._in: Optional[OpCost] = None

    def track(self, tree) -> int:
        """Count the storages of the tensors in ``tree`` (a call's
        arguments) as live; returns their bytes."""
        return sum(self.storages.add(t) for t in _leaves(tree))

    def _profiler(self, func, args) -> None:
        # regions nest, so an exit closes the innermost open one (its
        # handle comes back as another Python object)
        name = func._overloadpacket.__name__
        if name.startswith("_record_function_enter"):
            cost = OpCost() if args and args[0] == MICROBATCH else None
            if cost is not None:
                self.regions.append(cost)
            self._open.append(cost)
        elif name.startswith("_record_function_exit") and self._open:
            self._open.pop()
        self._in = next((c for c in reversed(self._open) if c is not None),
                        None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns = func.namespace
        if ns == "prim":
            return func(*args, **kwargs)
        if ns == "profiler":
            out = func(*args, **kwargs)
            self._profiler(func, args)
            return out
        op = _info(func)
        if op.composite:
            # Outside autograd (inference mode) an op such as einsum or
            # matmul arrives whole; count the ops it decomposes into, as
            # under autograd (``FlopCounterMode`` does the same).
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        flops = coll = 0
        if op.kind is not None:
            coll = sum(_nbytes(t) for t in _leaves(args[0]))
            written = coll
        elif ns == "c10d":
            written = 0
        else:
            if op.flops is not None:
                flops = int(op.flops(*args, **kwargs, out_val=out))
            written = written_bytes(func, args, kwargs, out)
        for cost in (self.cost, self._in):
            if cost is None:
                continue
            cost.flops += flops
            cost.hbm_bytes += written
            cost.ops += 1
            if coll:
                cost.collective_bytes[op.kind] += coll
        for t in _leaves(out):
            self.storages.add(t)
        return out


def analyze_trace(fn: Callable, *args, **kwargs) -> Tuple[Any, OpTrace]:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpCounter`: (its
    result, the :class:`OpTrace`).  On fake tensors (under an active
    ``FakeTensorMode``) nothing is allocated and nothing computed; on
    real ones the call runs as it always does."""
    counter = OpCounter()
    arg_bytes = counter.track((args, kwargs))
    mine = {id(t.untyped_storage()) for t in _leaves((args, kwargs))}
    t0 = time.perf_counter()
    with counter:
        out = fn(*args, **kwargs)
    seconds = time.perf_counter() - t0
    fresh = {id(t.untyped_storage()): t.untyped_storage().nbytes()
             for t in _leaves(out) if id(t.untyped_storage()) not in mine}
    return out, OpTrace(counter.cost, counter.regions,
                        counter.storages.peak, arg_bytes,
                        sum(fresh.values()), seconds)


# ---------------------------------------------------------------------------
# Trip counts: traces at a few depths carried to the full one
# ---------------------------------------------------------------------------
def _solve(rows: List[List[Fraction]], rhs: List[Fraction]
           ) -> List[Fraction]:
    """x with rows @ x = rhs, exactly (Gauss-Jordan over fractions);
    raises ``ValueError`` when the rows are not independent."""
    n = len(rows)
    m = [list(r) + [b] for r, b in zip(rows, rhs)]
    for c in range(n):
        p = next((r for r in range(c, n) if m[r][c] != 0), None)
        if p is None:
            raise ValueError("the traced depths do not determine the "
                             "counts: each kind needs a depth of its own")
        m[c], m[p] = m[p], m[c]
        for r in range(n):
            if r != c and m[r][c] != 0:
                f = m[r][c] / m[c][c]
                m[r] = [a - f * b for a, b in zip(m[r], m[c])]
    return [m[i][n] / m[i][i] for i in range(n)]


def depth_weights(points: Sequence[Mapping[str, int]],
                  target: Mapping[str, int]) -> List[Fraction]:
    """Weights ``w`` such that, for any count affine in the layer counts
    of each kind (``count = c0 + Σ_k c_k·n_k``), the count at ``target``
    is ``Σ_i w_i·count(points[i])``.  ``points`` are the traced depths,
    one more than the kinds, independent."""
    kinds = sorted(target)
    if len(points) != len(kinds) + 1:
        raise ValueError(f"{len(points)} traced depths for {len(kinds)} "
                         f"kinds of layer; need {len(kinds) + 1}")
    basis = lambda p: [Fraction(1)] + [Fraction(p[k]) for k in kinds]
    rows = [basis(p) for p in points]
    # w solves rows^T w = basis(target)
    cols = [[rows[i][j] for i in range(len(rows))] for j in range(len(rows))]
    return _solve(cols, basis(target))


def _exact(value, what: str) -> int:
    if isinstance(value, Fraction):
        if value.denominator != 1:
            raise ValueError(f"{what} weighs to {value}: the traced counts "
                             f"are not affine in the layer counts")
        return int(value)
    return int(value)


def weigh(costs: Sequence[OpCost], weights: Sequence[Fraction]) -> OpCost:
    """``Σ_i weights[i]·costs[i]``, every count an exact integer (raises
    ``ValueError`` otherwise: the counts were not affine in depth)."""
    total = OpCost().scaled(Fraction(0))
    for c, w in zip(costs, weights):
        total = total + c.scaled(w)
    return OpCost(_exact(total.flops, "flops"),
                  _exact(total.hbm_bytes, "hbm_bytes"),
                  {k: _exact(v, k) for k, v in total.collective_bytes.items()},
                  _exact(total.ops, "ops"))


def weigh_value(values: Sequence[int], weights: Sequence[Fraction]) -> int:
    """``Σ_i weights[i]·values[i]`` rounded to an integer: for a count
    that is not exactly affine in depth (a peak), an extrapolation."""
    return int(round(sum(Fraction(v) * w for v, w in zip(values, weights))))
