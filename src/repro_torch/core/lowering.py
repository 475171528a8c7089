"""Graph-IR → torch lowering: a rule registry, one function per op.

The port of ``repro.core.lowering``.  Where the reference walks the
graph once at ``jax.jit`` trace time, the port walks it once at compile
time per batch size: :class:`LoweredGraph` resolves every node's rule
up front, and a call runs the resolved list of eager torch ops.

Ops lower through registered rules::

    @register_lowering("my_op")
    def _lower_my_op(node, ins, ctx):
        return ctx.epilogue(node, some_torch_expression(ins))

A rule may be target-specific: ``register_lowering("dense",
target="cuda")`` shadows the generic rule only on the ``"cuda"``
target, which is how the ``fused_matmul``, ``fused_matmul_q8`` and
``decode_attention`` kernels plug in.  The ``fast_act`` kernel plugs in
through :meth:`LoweringContext.act`, which every rule's fast
activations go through.

Tensors are NHWC between ops; weights arrive as device tensors prepared
once by :func:`device_params` (convolution kernels already OIHW), and
the low-precision dense operands by :func:`quant_params` (int8 weights
and dequant vectors, bf16 weights), so no call quantizes a weight.
"""

from __future__ import annotations

import dataclasses
import hashlib
import sys
import types
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .graph import Graph, Node
from .ops_common import (apply_activation, avgpool2d_nhwc, conv2d_nhwc,
                         fast_activation, maxpool2d_nhwc)
from ..kernels import qmath
from ..kernels.decode_attention import ref as attn_ref
from ..kernels.decode_attention.ops import decode_attention
from ..kernels.fast_act import ops as fast_act_ops
from ..kernels.fused_matmul import kernel as fm_kernel
from ..kernels.fused_matmul import ref as fm_ref
from ..kernels.fused_matmul.ops import fused_matmul, fused_matmul_q8
from .selection import KernelChoice, choice_plan


class UnsupportedOpError(NotImplementedError):
    """No lowering rule for an op — a structured diagnostic instead of a
    bare ``NotImplementedError(op)``."""

    def __init__(self, op: str, target: Optional[str]) -> None:
        self.op = op
        self.target = target
        ops = registered_ops(target)
        super().__init__(
            f"no lowering rule for op {op!r}"
            + (f" (target {target!r})" if target else "")
            + f"; registered ops: {', '.join(ops)}. "
            f"Add one with @register_lowering({op!r})"
            + (f" or @register_lowering({op!r}, target={target!r})"
               if target else "")
        )


@dataclasses.dataclass
class LoweringContext:
    """Static compile-time state threaded through every lowering rule.

    ``params`` are device tensors (:func:`device_params`).  ``batch_size``
    is the batch the program is specialized for.  ``counters`` are the
    split counters its dense kernels reduce K splits through: each
    context holds its own, so a CUDA graph captured from the program
    reads memory the program holds.  ``selection`` is the resolved kernel
    selection (``core/selection.py``, refined by the autotuner): the
    ``cuda`` dense and decode rules launch the plan its choice names.
    """

    params: Mapping[str, torch.Tensor]
    batch_size: int = 1
    precision: str = "exact"
    target: Optional[str] = None
    counters: fm_kernel.SplitCounters = dataclasses.field(
        default_factory=fm_kernel.SplitCounters, compare=False, repr=False)
    selection: Mapping[str, KernelChoice] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    #: Sharded compiles (``repro_torch.dist``): the live mesh
    #: (``dist.collectives.LiveMesh``: the ``DeviceMesh``, this rank's
    #: coordinates, the axes' process groups; None without one or on a
    #: single-device mesh), the resolved per-tensor axis lists of
    #: ``graph.dist["shardings"]``, the mesh's {axis name: size} and
    #: this rank's {axis name: coordinate}.  Empty/None = unsharded.
    mesh: Optional[object] = dataclasses.field(default=None, compare=False,
                                               repr=False)
    shardings: Mapping[str, list] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)
    mesh_axis_sizes: Mapping[str, int] = dataclasses.field(
        default_factory=dict)
    coords: Mapping[str, int] = dataclasses.field(default_factory=dict)

    def split_axes(self, tensor: str) -> Tuple[str, ...]:
        """The live mesh axes that split ``tensor``'s last dim on this
        rank (its local form is this rank's slice); () when whole."""
        entry = self.shardings.get(tensor)
        if self.mesh is None or not entry or len(entry) < 2:
            return ()
        return self.mesh.canonical(entry[-1] or ())

    def plan(self, node: Node, **shape):
        """The plan the tactic of the selection's choice for ``node``
        names, laid out at ``shape``; None when it names the heuristic's
        plan, which the wrapper computes from the shape."""
        return choice_plan(self.selection.get(node.name), **shape)

    def act(self, fn: str, x: torch.Tensor, attrs: Dict) -> torch.Tensor:
        """Activation ``fn`` under the context's precision.  On the
        ``cuda`` target the fast tanh/sigmoid/softmax/elu run every exp,
        tanh and sigmoid in the ``fast_act`` kernel (the reference's
        ``use_pallas=True``); elsewhere the same math in plain torch."""
        if self.precision == "fast":
            if self.target == "cuda" and fn in fast_act_ops.KERNEL_FNS:
                return fast_act_ops.fast_activation(fn, x, attrs)
            return fast_activation(fn, x, attrs)
        return apply_activation(fn, x, attrs)

    def epilogue(self, node: Node, y: torch.Tensor) -> torch.Tensor:
        """Apply the node's fused epilogue: activation, then the folded
        post-activation affine (paper §3.4/§3.5)."""
        if node.epilogue and node.epilogue != "linear":
            y = self.act(node.epilogue, y, node.epilogue_attrs)
        pa = node.epilogue_attrs.get("post_affine")
        if pa:
            y = y * self.params[pa[0]] + self.params[pa[1]]
        return y


LoweringRule = Callable[[Node, List[torch.Tensor], LoweringContext],
                        torch.Tensor]

#: (op, target) -> rule; target=None is the generic rule.
_RULES: Dict[Tuple[str, Optional[str]], LoweringRule] = {}


def register_lowering(
    op: str, *, target: Optional[str] = None
) -> Callable[[LoweringRule], LoweringRule]:
    """Decorator: register the lowering rule for ``op`` (overwrites).
    With ``target=``, the rule only applies when compiling for that
    target and shadows the generic rule."""

    def deco(rule: LoweringRule) -> LoweringRule:
        _RULES[(op, target)] = rule
        return rule

    return deco


def get_lowering(op: str, target: Optional[str] = None) -> LoweringRule:
    """The rule for ``op`` under ``target``: target-specific override
    first, generic rule otherwise."""
    rule = _RULES.get((op, target)) or _RULES.get((op, None))
    if rule is None:
        raise UnsupportedOpError(op, target)
    return rule


def registered_ops(target: Optional[str] = None) -> Tuple[str, ...]:
    """Ops lowerable under ``target`` (generic rules always count)."""
    return tuple(sorted({op for op, t in _RULES if t in (None, target)}))


_FILE_DIGESTS: Dict[str, str] = {}


def _hash_code(h, code) -> None:
    """Recursive, process-stable digest of a code object: bytecode,
    referenced names, and nested code objects."""
    h.update(code.co_code)
    h.update(" ".join(code.co_names).encode())
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            _hash_code(h, c)
        else:
            h.update(repr(c).encode())


def _rule_token(rule) -> str:
    """Per-rule digest: the defining module's source plus the rule's own
    recursive bytecode."""
    h = hashlib.sha256()
    mod = sys.modules.get(getattr(rule, "__module__", ""))
    src_file = getattr(mod, "__file__", None)
    if src_file:
        if src_file not in _FILE_DIGESTS:
            try:
                with open(src_file, "rb") as f:
                    _FILE_DIGESTS[src_file] = hashlib.sha256(
                        f.read()).hexdigest()
            except OSError:
                _FILE_DIGESTS[src_file] = src_file
        h.update(_FILE_DIGESTS[src_file].encode())
    code = getattr(rule, "__code__", None)
    if code is not None:
        _hash_code(h, code)
    return h.hexdigest()


def lowering_fingerprint(target: Optional[str] = None) -> str:
    """Digest of the rule set effective under ``target``: registering,
    removing or editing a rule changes it.  Deterministic across
    processes (the executable cache keys on it)."""
    h = hashlib.sha256()
    for (op, t), rule in sorted(_RULES.items(),
                                key=lambda kv: (kv[0][0], kv[0][1] or "")):
        if t in (None, target):
            h.update(f"{op}/{t}/{_rule_token(rule)}".encode())
    return h.hexdigest()


def resolve_device(name: str) -> torch.device:
    """A device name as a ``torch.device``; a CUDA device without CUDA
    raises — there is no silent fallback to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} but torch.cuda.is_available() is False; pass "
            f"device='cpu' to run on the CPU")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {name!r}; use 'cuda' or 'cpu'")
    return dev


def device_params(graph: Graph, device, names=None) -> Dict[str, torch.Tensor]:
    """The graph's weights as f32 tensors on ``device``, converted once.

    Convolution kernels change layout here, at compile time: HWIO →
    OIHW for ``conv2d``; (kh, kw, c, mult) → (c*mult, 1, kh, kw) for
    ``depthwise_conv2d`` (output channel o reads input channel o // mult,
    as in the reference's grouped ``lax`` conv).  Dense kernels stay as
    stored, "io" or "oi": the kernel reads both.  ``names`` limits the
    conversion to those params.
    """
    conv_kernels = {n.params["kernel"]: n.op for n in graph.nodes
                    if n.op in ("conv2d", "depthwise_conv2d")}
    out: Dict[str, torch.Tensor] = {}
    for name, value in graph.params.items():
        if names is not None and name not in names:
            continue
        t = torch.tensor(np.asarray(value, dtype=np.float32))
        op = conv_kernels.get(name)
        if op == "conv2d":
            t = t.permute(3, 2, 0, 1)
        elif op == "depthwise_conv2d":
            kh, kw, c, mult = t.shape
            t = t.reshape(kh, kw, 1, c * mult).permute(3, 2, 0, 1)
        out[name] = t.contiguous().to(device)
    return out


def quant_key(node: Node, what: str) -> str:
    """Name of a low-precision operand :func:`quant_params` prepares."""
    return f"{node.name}/quant.{what}"


def quant_params(graph: Graph, params: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The low-precision operands of the dense sites, made once from the
    device weights ``params``, on their device:

    * int8: ``wq`` (int8, the stored layout), ``deq`` (f32 ``s_x·s_w``)
      and ``x_scale`` (0-dim f32, so the plain version divides by a
      device tensor).  ``quant.w_scale`` covers the logical out channels
      (the pass runs before layout); the layout pass may have padded the
      kernel to a LANE multiple, whose zero channels take a scale of 1.0.
    * bf16: ``w``, the kernel rounded to bfloat16.
    """
    out: Dict[str, torch.Tensor] = {}
    for node in graph.nodes:
        qm = node.attrs.get("quant.mode")
        if node.op != "dense" or qm not in ("int8", "bf16"):
            continue
        w = params[node.params["kernel"]]
        if qm == "bf16":
            out[quant_key(node, "w")] = w.to(torch.bfloat16)
            continue
        layout = node.attrs.get("kernel_layout", "io")
        ws = np.asarray(node.attrs["quant.w_scale"], dtype=np.float32)
        pn = w.shape[1] if layout == "io" else w.shape[0]
        ws = np.pad(ws, (0, pn - ws.shape[0]), constant_values=1.0)
        xs = node.attrs["quant.x_scale"]
        wq, deq = qmath.quantize_weight(w, xs, ws, layout)
        out[quant_key(node, "wq")] = wq
        out[quant_key(node, "deq")] = deq
        out[quant_key(node, "x_scale")] = qmath.scale_tensor(xs, w.device)
    return out


class LoweredGraph:
    """One specialized program: the graph's rules resolved in
    topological order under a fixed context.  Calling it maps input
    tensors (by graph input name) to the graph's output tensors, one
    eager op at a time; :class:`~repro_torch.core.program.CapturedProgram`
    records one call of it as a CUDA graph."""

    def __init__(self, graph: Graph, ctx: LoweringContext) -> None:
        self.ctx = ctx
        self.outputs = list(graph.outputs)
        self.steps = [(node, get_lowering(node.op, ctx.target))
                      for node in graph.toposort()]

    def __call__(self, env: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        env = dict(env)
        ctx = self.ctx
        for node, rule in self.steps:
            env[node.output] = rule(node, [env[t] for t in node.inputs], ctx)
        return {name: env[name] for name in self.outputs}


# ---------------------------------------------------------------------------
# Generic rules (every target)
# ---------------------------------------------------------------------------
@register_lowering("constant")
def _lower_constant(node, ins, ctx):
    v = ctx.params[node.params["value"]]
    return v.expand((ctx.batch_size,) + tuple(v.shape))


def _dense_impl(node, ins, ctx, use_kernel: bool):
    """A dense node at its ``quant.mode``: on the kernel path every node
    launches ``fused_matmul_q8`` (int8) or ``fused_matmul`` (f32, bf16
    operands), elsewhere their plain versions run the same arithmetic.
    On a live mesh a column-parallel node runs its slice of the output
    channels (its weights were sliced at compile time) as is, and a
    row-parallel one (its input's channels split) runs
    :func:`_row_parallel_dense`."""
    axes = ctx.split_axes(node.inputs[0])
    if axes:
        return _row_parallel_dense(node, ins, ctx, use_kernel, axes)
    w = ctx.params[node.params["kernel"]]
    b, scale, offset, fn, layout = _dense_epilogue(node, ctx)
    kw = dict(fn=fn, fast=ctx.precision == "fast", w_layout=layout,
              attrs=node.epilogue_attrs)
    kernel_kw = dict(kw, counters=ctx.counters)
    x = ins[0]
    qm = node.attrs.get("quant.mode")
    k = x.shape[-1]
    shape = dict(m=x.numel() // max(k, 1), k=k, w_layout=layout,
                 n=w.shape[1] if layout == "io" else w.shape[0])
    if qm == "int8":
        wq = ctx.params[quant_key(node, "wq")]
        deq = ctx.params[quant_key(node, "deq")]
        if use_kernel:
            y = fused_matmul_q8(x.contiguous(), wq, deq, b, scale, offset,
                                x_scale=node.attrs["quant.x_scale"],
                                plan=ctx.plan(node, **shape), **kernel_kw)
        else:
            xq = qmath.quantize_q8(x, ctx.params[quant_key(node, "x_scale")])
            y = fm_ref.fused_matmul_q8_ref(xq, wq, deq, b, scale, offset, **kw)
    else:
        if qm == "bf16":
            x, w = x.to(torch.bfloat16), ctx.params[quant_key(node, "w")]
        if use_kernel:
            y = fused_matmul(x.contiguous(), w, b, scale, offset,
                             plan=ctx.plan(node, itemsize=x.element_size(),
                                             **shape), **kernel_kw)
        else:
            y = fm_ref.fused_matmul_ref(x.float(), w.float(), b, scale,
                                        offset, **kw)
    return _dense_tail(node, ctx, y)


def _dense_epilogue(node, ctx):
    """A dense node's epilogue operands: (bias, scale, offset, fn, kernel
    layout); fn None for linear, and for softmax, which
    :func:`_dense_tail` applies after the product (two-pass, not fusable
    in a kernel)."""
    b = ctx.params[node.params["bias"]] if "bias" in node.params else None
    pa = node.epilogue_attrs.get("post_affine")
    scale = ctx.params[pa[0]] if pa else None
    offset = ctx.params[pa[1]] if pa else None
    fn = node.epilogue if node.epilogue not in (None, "linear",
                                                "softmax") else None
    return b, scale, offset, fn, node.attrs.get("kernel_layout", "io")


def _dense_tail(node, ctx, y):
    """What follows a dense node's epilogue: the padded channels cut
    back, then the softmax epilogue."""
    if "orig_cout" in node.attrs:
        y = y[..., : node.attrs["orig_cout"]]
    if node.epilogue == "softmax":
        y = ctx.act("softmax", y, node.epilogue_attrs)
    return y


def _row_parallel_dense(node, ins, ctx, use_kernel: bool, axes):
    """A dense whose contraction runs over channels split across the
    ranks of ``axes``: this rank's rows of the weight against its slice
    of x with the epilogue off, the partial sums all-reduced over
    ``axes``, then the epilogue once, as the unsharded node applies it
    after its whole sum.  An int8 site sums its exact int32 products
    (each rank quantizes its slice of x with the same ``x_scale``, so
    the integers are the unsharded ones) and dequantizes after the
    reduce: bit-equal to the unsharded node.  An f32 or bf16 site sums
    f32 partial sums, in another order than one product would."""
    from ..dist.collectives import all_reduce
    b, scale, offset, fn, layout = _dense_epilogue(node, ctx)
    x = ins[0]
    qm = node.attrs.get("quant.mode")
    k = x.shape[-1]
    if qm == "int8":
        wq = ctx.params[quant_key(node, "wq")]
        n = wq.shape[1] if layout == "io" else wq.shape[0]
        shape = dict(m=x.numel() // max(k, 1), k=k, n=n, w_layout=layout)
        if use_kernel:
            acc = fused_matmul_q8(
                x.contiguous(), wq, None, x_scale=node.attrs["quant.x_scale"],
                w_layout=layout, sums=True, counters=ctx.counters,
                plan=ctx.plan(node, **shape))
        else:
            acc = fm_ref.q8_sums_ref(
                qmath.quantize_q8(x, ctx.params[quant_key(node, "x_scale")]),
                wq, w_layout=layout)
        y = all_reduce(acc, axes, ctx.mesh).float() \
            * ctx.params[quant_key(node, "deq")]
    else:
        w = ctx.params[node.params["kernel"]]
        if qm == "bf16":
            x, w = x.to(torch.bfloat16), ctx.params[quant_key(node, "w")]
        n = w.shape[1] if layout == "io" else w.shape[0]
        if use_kernel:
            part = fused_matmul(
                x.contiguous(), w, w_layout=layout, counters=ctx.counters,
                plan=ctx.plan(node, itemsize=x.element_size(), m=x.numel()
                              // max(k, 1), k=k, n=n, w_layout=layout))
        else:
            part = fm_ref.fused_matmul_ref(x.float(), w.float(),
                                           w_layout=layout)
        y = all_reduce(part, axes, ctx.mesh)
    return _dense_tail(node, ctx, fm_ref.epilogue_chain(
        y, b, scale, offset, fn, ctx.precision == "fast",
        node.epilogue_attrs))


@register_lowering("dense")
def _lower_dense(node, ins, ctx):
    return _dense_impl(node, ins, ctx, use_kernel=False)


@register_lowering("conv2d")
def _lower_conv2d(node, ins, ctx):
    k = ctx.params[node.params["kernel"]]
    b = ctx.params[node.params["bias"]] if "bias" in node.params else None
    conv = dict(strides=node.attrs["strides"], padding=node.attrs["padding"])
    qm = node.attrs.get("quant.mode")
    if qm == "int8":
        y = qmath.conv2d_q8(ins[0], k, node.attrs["quant.x_scale"],
                            node.attrs["quant.w_scale"], **conv)
    elif qm == "bf16":
        y = qmath.conv2d_bf16(ins[0], k, **conv)
    else:
        return ctx.epilogue(node, conv2d_nhwc(
            ins[0], k, conv["strides"], conv["padding"], bias=b))
    if b is not None:
        y = y + b
    return ctx.epilogue(node, y)


@register_lowering("depthwise_conv2d")
def _lower_depthwise_conv2d(node, ins, ctx):
    b = ctx.params[node.params["bias"]] if "bias" in node.params else None
    y = conv2d_nhwc(ins[0], ctx.params[node.params["kernel"]],
                    node.attrs["strides"], node.attrs["padding"], bias=b,
                    groups=ins[0].shape[-1])
    return ctx.epilogue(node, y)


@register_lowering("batchnorm")
def _lower_batchnorm(node, ins, ctx):
    # Unfolded BN survives only when no adjacent foldable layer existed.
    gamma = ctx.params[node.params["gamma"]]
    beta = ctx.params[node.params["beta"]]
    mean = ctx.params[node.params["mean"]]
    var = ctx.params[node.params["var"]]
    s = gamma * torch.rsqrt(var + node.attrs["epsilon"])
    o = beta - s * mean
    return ctx.epilogue(node, ins[0] * s + o)


@register_lowering("activation")
def _lower_activation(node, ins, ctx):
    return ctx.epilogue(node, ctx.act(node.attrs["fn"], ins[0], node.attrs))


@register_lowering("maxpool2d")
def _lower_maxpool2d(node, ins, ctx):
    return ctx.epilogue(node, maxpool2d_nhwc(
        ins[0], node.attrs["pool_size"], node.attrs["strides"],
        node.attrs["padding"]))


@register_lowering("avgpool2d")
def _lower_avgpool2d(node, ins, ctx):
    return ctx.epilogue(node, avgpool2d_nhwc(
        ins[0], node.attrs["pool_size"], node.attrs["strides"],
        node.attrs["padding"]))


@register_lowering("global_avg_pool")
def _lower_global_avg_pool(node, ins, ctx):
    return ctx.epilogue(node, torch.mean(ins[0], dim=(1, 2)))


@register_lowering("upsample2d")
def _lower_upsample2d(node, ins, ctx):
    f = node.attrs["factor"]
    y = ins[0].repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
    return ctx.epilogue(node, y)


@register_lowering("zero_pad2d")
def _lower_zero_pad2d(node, ins, ctx):
    (t, b), (l, r) = node.attrs["padding"]
    return ctx.epilogue(node, F.pad(ins[0], (0, 0, l, r, t, b)))


@register_lowering("add")
def _lower_add(node, ins, ctx):
    return ctx.epilogue(node, ins[0] + ins[1])


@register_lowering("mul")
def _lower_mul(node, ins, ctx):
    return ctx.epilogue(node, ins[0] * ins[1])


@register_lowering("concat")
def _lower_concat(node, ins, ctx):
    return ctx.epilogue(node, torch.cat(ins, dim=node.attrs["axis"] + 1))


@register_lowering("reshape")
def _lower_reshape(node, ins, ctx):
    return ctx.epilogue(
        node, ins[0].reshape((ins[0].shape[0],) + tuple(node.attrs["shape"])))


@register_lowering("flatten")
def _lower_flatten(node, ins, ctx):
    return ctx.epilogue(node, ins[0].reshape(ins[0].shape[0], -1))


@register_lowering("softmax")
def _lower_softmax(node, ins, ctx):
    return ctx.epilogue(node, ctx.act("softmax", ins[0], node.attrs))


@register_lowering("decode_attention")
def _lower_decode_attention(node, ins, ctx):
    """The one-pass form, as the reference's jit and interpret targets."""
    lengths = ins[3] if len(ins) > 3 else None
    return ctx.epilogue(node, attn_ref.decode_attention_ref(
        ins[0], ins[1], ins[2], lengths, scale=node.attrs.get("scale"),
        fast=ctx.precision == "fast"))


# ---------------------------------------------------------------------------
# CUDA-target overrides: every dense node runs the fused_matmul kernel
# (fused_matmul_q8 for int8 sites), every decode_attention node the
# decode_attention kernel.
# ---------------------------------------------------------------------------
@register_lowering("dense", target="cuda")
def _lower_dense_cuda(node, ins, ctx):
    return _dense_impl(node, ins, ctx, use_kernel=True)


@register_lowering("decode_attention", target="cuda")
def _lower_decode_attention_cuda(node, ins, ctx):
    q, k, v = (t.contiguous() for t in ins[:3])
    lengths = ins[3].contiguous() if len(ins) > 3 else None
    chunks = ctx.plan(node, b=k.shape[0], hkv=k.shape[2], s=k.shape[1])
    return ctx.epilogue(node, decode_attention(
        q, k, v, lengths, scale=node.attrs.get("scale"),
        fast=ctx.precision == "fast",
        tiles_per_chunk=None if chunks is None else chunks[0]))
