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
target, which is how the ``fused_matmul`` kernel plugs in.  The
``fast_act`` kernel plugs in through :meth:`LoweringContext.act`, which
every rule's fast activations go through.

Tensors are NHWC between ops; weights arrive as device tensors prepared
once by :func:`device_params` (convolution kernels already OIHW).
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
from ..kernels.fast_act import ops as fast_act_ops
from ..kernels.fused_matmul import ref as fm_ref
from ..kernels.fused_matmul.ops import fused_matmul

#: Ops in the IR whose lowering is not ported yet -> the ROADMAP item.
PENDING_OPS = {"decode_attention": "ROADMAP A.6"}


class UnsupportedOpError(NotImplementedError):
    """No lowering rule for an op — a structured diagnostic instead of a
    bare ``NotImplementedError(op)``."""

    def __init__(self, op: str, target: Optional[str]) -> None:
        self.op = op
        self.target = target
        ops = registered_ops(target)
        pending = (f" The port has no {op!r} yet ({PENDING_OPS[op]})."
                   if op in PENDING_OPS else "")
        super().__init__(
            f"no lowering rule for op {op!r}"
            + (f" (target {target!r})" if target else "")
            + f"; registered ops: {', '.join(ops)}.{pending} "
            f"Add one with @register_lowering({op!r})"
            + (f" or @register_lowering({op!r}, target={target!r})"
               if target else "")
        )


@dataclasses.dataclass
class LoweringContext:
    """Static compile-time state threaded through every lowering rule.

    ``params`` are device tensors (:func:`device_params`).  ``batch_size``
    is the batch the program is specialized for.
    """

    params: Mapping[str, torch.Tensor]
    batch_size: int = 1
    precision: str = "exact"
    target: Optional[str] = None

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
    processes (the executable cache of ROADMAP A.7 will key on it)."""
    h = hashlib.sha256()
    for (op, t), rule in sorted(_RULES.items(),
                                key=lambda kv: (kv[0][0], kv[0][1] or "")):
        if t in (None, target):
            h.update(f"{op}/{t}/{_rule_token(rule)}".encode())
    return h.hexdigest()


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


class LoweredGraph:
    """One specialized program: the graph's rules resolved in
    topological order under a fixed context.  Calling it maps input
    tensors (by graph input name) to the graph's output tensors."""

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
    w = ctx.params[node.params["kernel"]]
    b = ctx.params[node.params["bias"]] if "bias" in node.params else None
    layout = node.attrs.get("kernel_layout", "io")
    pa = node.epilogue_attrs.get("post_affine")
    scale = ctx.params[pa[0]] if pa else None
    offset = ctx.params[pa[1]] if pa else None
    fn = node.epilogue if node.epilogue not in (None, "linear") else None
    if fn == "softmax":
        fn = None  # handled below (two-pass, not fusable in-kernel)
    x = ins[0]
    if use_kernel:
        y = fused_matmul(x.contiguous(), w, b, scale, offset, fn=fn,
                         fast=ctx.precision == "fast", w_layout=layout,
                         attrs=node.epilogue_attrs)
    else:
        y = fm_ref.fused_matmul_ref(x, w, b, scale, offset, fn=fn,
                                    fast=ctx.precision == "fast",
                                    w_layout=layout,
                                    attrs=node.epilogue_attrs)
    if "orig_cout" in node.attrs:
        y = y[..., : node.attrs["orig_cout"]]
    if node.epilogue == "softmax":
        y = ctx.act("softmax", y, node.epilogue_attrs)
    return y


@register_lowering("dense")
def _lower_dense(node, ins, ctx):
    return _dense_impl(node, ins, ctx, use_kernel=False)


@register_lowering("conv2d")
def _lower_conv2d(node, ins, ctx):
    b = ctx.params[node.params["bias"]] if "bias" in node.params else None
    y = conv2d_nhwc(ins[0], ctx.params[node.params["kernel"]],
                    node.attrs["strides"], node.attrs["padding"], bias=b)
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


# ---------------------------------------------------------------------------
# CUDA-target override: every dense node runs the fused_matmul kernel.
# ---------------------------------------------------------------------------
@register_lowering("dense", target="cuda")
def _lower_dense_cuda(node, ins, ctx):
    return _dense_impl(node, ins, ctx, use_kernel=True)
