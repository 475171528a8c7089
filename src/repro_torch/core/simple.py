"""SimpleNN — the straightforward oracle interpreter, in eager torch.

The port of ``repro.core.simple.SimpleNN`` (the paper's "straightforward,
but slow implementation … as exact in its calculations as possible",
§3.1): it walks the *unoptimized* graph node by node with plain torch
ops — no fusion, no folding, no approximations.  Tensors are NHWC at
every node boundary; convolutions run through ATen/cuDNN with TF32 off
(``ops_common``).  Weights become tensors on ``device`` once, when the
interpreter is built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .graph import Graph, Node
from .ops_common import (apply_activation, avgpool2d_nhwc, conv2d_nhwc,
                         maxpool2d_nhwc)


class SimpleNN:
    """Node-by-node interpreter of a :class:`~repro_torch.core.graph.Graph`.

    Inputs/outputs carry an explicit leading batch dimension; image
    tensors are NHWC.  Inputs may be numpy arrays or tensors; outputs are
    tensors on ``device``.
    """

    def __init__(self, graph: Graph, device="cpu"):
        self.graph = graph
        self.specs = graph.infer_shapes()
        self.device = torch.device(device)
        used = {p for n in graph.nodes for p in n.params.values()}
        for n in graph.nodes:
            used.update(n.epilogue_attrs.get("post_affine") or ())
        # Local import: lowering imports the kernels, which import this
        # module's siblings; the oracle itself only needs the helper.
        from .lowering import device_params
        self.params = device_params(graph, self.device, names=used)

    def __call__(self, **inputs) -> Dict[str, torch.Tensor]:
        env: Dict[str, torch.Tensor] = {}
        for name, spec in self.graph.inputs.items():
            if name not in inputs:
                raise ValueError(f"missing input {name!r}")
            x = torch.as_tensor(inputs[name], dtype=getattr(torch, spec.dtype),
                                device=self.device)
            if tuple(x.shape[1:]) != tuple(spec.shape):
                raise ValueError(
                    f"input {name!r}: expected (batch,)+{spec.shape}, "
                    f"got {tuple(x.shape)}")
            env[name] = x
        batch = next(
            (env[n].shape[0] for n in self.graph.inputs if n in env), 1)
        with torch.inference_mode():
            for node in self.graph.toposort():
                env[node.output] = self._eval(node, env, batch)
                # SimpleNN never fuses: an epilogue a pass attached is
                # applied as a separate elementwise step.
                if node.epilogue and node.epilogue != "linear":
                    env[node.output] = apply_activation(
                        node.epilogue, env[node.output], node.epilogue_attrs)
        return {name: env[name] for name in self.graph.outputs}

    # ------------------------------------------------------------------
    def _eval(self, node: Node, env: Dict[str, torch.Tensor],
              batch: int = 1) -> torch.Tensor:
        p = self.params
        op = node.op
        ins = [env[t] for t in node.inputs]
        if op == "constant":
            v = p[node.params["value"]]
            return v.expand((batch,) + tuple(v.shape))
        if op in ("conv2d", "depthwise_conv2d"):
            groups = ins[0].shape[-1] if op == "depthwise_conv2d" else 1
            y = conv2d_nhwc(ins[0], p[node.params["kernel"]],
                            node.attrs["strides"], node.attrs["padding"],
                            groups=groups)
            if "bias" in node.params:
                y = y + p[node.params["bias"]]
            return y
        if op == "dense":
            y = ins[0] @ p[node.params["kernel"]]
            if "bias" in node.params:
                y = y + p[node.params["bias"]]
            return y
        if op == "batchnorm":
            gamma = p[node.params["gamma"]]
            beta = p[node.params["beta"]]
            mean = p[node.params["mean"]]
            var = p[node.params["var"]]
            eps = node.attrs["epsilon"]
            # Deliberately the two-step textbook formula (the paper notes
            # folding changes associativity; the oracle keeps it unfolded).
            return gamma * (ins[0] - mean) / torch.sqrt(var + eps) + beta
        if op == "activation":
            return apply_activation(node.attrs["fn"], ins[0], node.attrs)
        if op == "maxpool2d":
            return maxpool2d_nhwc(ins[0], node.attrs["pool_size"],
                                  node.attrs["strides"], node.attrs["padding"])
        if op == "avgpool2d":
            return avgpool2d_nhwc(ins[0], node.attrs["pool_size"],
                                  node.attrs["strides"], node.attrs["padding"])
        if op == "global_avg_pool":
            return torch.mean(ins[0], dim=(1, 2))
        if op == "upsample2d":
            f = node.attrs["factor"]
            return ins[0].repeat_interleave(f, dim=1).repeat_interleave(f, dim=2)
        if op == "zero_pad2d":
            (t, b), (l, r) = node.attrs["padding"]
            return torch.nn.functional.pad(ins[0], (0, 0, l, r, t, b))
        if op == "add":
            return ins[0] + ins[1]
        if op == "mul":
            return ins[0] * ins[1]
        if op == "concat":
            # attrs axis excludes batch; +1 for the runtime batch dim.
            return torch.cat(ins, dim=node.attrs["axis"] + 1)
        if op == "reshape":
            return ins[0].reshape((ins[0].shape[0],) + tuple(node.attrs["shape"]))
        if op == "flatten":
            return ins[0].reshape(ins[0].shape[0], -1)
        if op == "softmax":
            return torch.softmax(ins[0], dim=node.attrs["axis"])
        # Plug-in ops (register_op + @register_lowering) and ops not
        # ported yet: the generic lowering rule in exact precision, on an
        # epilogue-free view of the node (the loop above applies
        # epilogues); an op without one raises UnsupportedOpError.
        from .lowering import LoweringContext, get_lowering
        rule = get_lowering(op, None)
        ctx = LoweringContext(params=p, batch_size=batch)
        bare = dataclasses.replace(node, epilogue=None, epilogue_attrs={})
        return rule(bare, ins, ctx)
