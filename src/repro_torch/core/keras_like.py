"""Keras-style sequential/functional model builder over the graph IR.

Plays the role of the paper's front end ("the Model class allows to load
a network … as written by the Python library Keras").  There is no HDF5
in this environment, so instead of a file loader this is a programmatic
builder with the same layer vocabulary; ``repro_torch.frontends.container``
round-trips the graph through an ``.npz`` + JSON container so the "load a
pretrained model at runtime, then compile" flow of the paper is
preserved.

The port's copy of ``repro.core.keras_like.ModelBuilder``: the same
seeded numpy initialisation, so both packages build bit-identical
weights from the same seed.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .graph import Graph


class ModelBuilder:
    """Functional builder: each method appends a node and returns the
    output tensor name, so models compose like Keras' functional API."""

    def __init__(self) -> None:
        self.graph = Graph()
        self._n = 0
        self._rng = np.random.default_rng(0)

    def seed(self, seed: int) -> "ModelBuilder":
        self._rng = np.random.default_rng(seed)
        return self

    def _name(self, kind: str) -> str:
        self._n += 1
        return f"{kind}_{self._n}"

    def _init(self, shape: Tuple[int, ...], fan_in: int) -> np.ndarray:
        scale = np.sqrt(2.0 / max(1, fan_in))
        return (self._rng.standard_normal(shape) * scale).astype(np.float32)

    # -- layers ---------------------------------------------------------
    def input(self, shape: Sequence[int], name: str = "input",
              dtype: str = "float32") -> str:
        return self.graph.add_input(name, shape, dtype)

    def conv2d(self, x: str, filters: int, kernel_size: Tuple[int, int],
               strides=(1, 1), padding="same", use_bias=True,
               activation: Optional[str] = None) -> str:
        name = self._name("conv2d")
        cin = self.graph.spec(x).shape[-1]
        k = self._init(kernel_size + (cin, filters), cin * kernel_size[0] * kernel_size[1])
        params = {"kernel": self.graph.add_param(f"{name}/kernel", k)}
        if use_bias:
            params["bias"] = self.graph.add_param(
                f"{name}/bias", np.zeros(filters, np.float32))
        out = self.graph.add_node("conv2d", name, [x],
                                  attrs={"strides": tuple(strides), "padding": padding},
                                  params=params)
        return self.activation(out, activation) if activation else out

    def depthwise_conv2d(self, x: str, kernel_size: Tuple[int, int],
                         strides=(1, 1), padding="same", mult: int = 1,
                         use_bias=True, activation: Optional[str] = None) -> str:
        name = self._name("dwconv2d")
        c = self.graph.spec(x).shape[-1]
        k = self._init(kernel_size + (c, mult), kernel_size[0] * kernel_size[1])
        params = {"kernel": self.graph.add_param(f"{name}/kernel", k)}
        if use_bias:
            params["bias"] = self.graph.add_param(
                f"{name}/bias", np.zeros(c * mult, np.float32))
        out = self.graph.add_node("depthwise_conv2d", name, [x],
                                  attrs={"strides": tuple(strides), "padding": padding},
                                  params=params)
        return self.activation(out, activation) if activation else out

    def dense(self, x: str, units: int, use_bias=True,
              activation: Optional[str] = None) -> str:
        name = self._name("dense")
        cin = self.graph.spec(x).shape[-1]
        params = {"kernel": self.graph.add_param(
            f"{name}/kernel", self._init((cin, units), cin))}
        if use_bias:
            params["bias"] = self.graph.add_param(
                f"{name}/bias", np.zeros(units, np.float32))
        out = self.graph.add_node("dense", name, [x], params=params)
        return self.activation(out, activation) if activation else out

    def batchnorm(self, x: str, epsilon: float = 1e-3) -> str:
        name = self._name("bn")
        c = self.graph.spec(x).shape[-1]
        params = {
            "gamma": self.graph.add_param(
                f"{name}/gamma", self._rng.uniform(0.5, 1.5, c).astype(np.float32)),
            "beta": self.graph.add_param(
                f"{name}/beta", (self._rng.standard_normal(c) * 0.1).astype(np.float32)),
            "mean": self.graph.add_param(
                f"{name}/mean", (self._rng.standard_normal(c) * 0.1).astype(np.float32)),
            "var": self.graph.add_param(
                f"{name}/var", self._rng.uniform(0.5, 2.0, c).astype(np.float32)),
        }
        return self.graph.add_node("batchnorm", name, [x],
                                   attrs={"epsilon": epsilon}, params=params)

    def activation(self, x: str, fn: str, **attrs) -> str:
        name = self._name(f"act_{fn}")
        return self.graph.add_node("activation", name, [x],
                                   attrs={"fn": fn, **attrs})

    def maxpool(self, x: str, pool_size=(2, 2), strides=None, padding="valid") -> str:
        name = self._name("maxpool")
        return self.graph.add_node(
            "maxpool2d", name, [x],
            attrs={"pool_size": tuple(pool_size),
                   "strides": tuple(strides or pool_size), "padding": padding})

    def avgpool(self, x: str, pool_size=(2, 2), strides=None, padding="valid") -> str:
        name = self._name("avgpool")
        return self.graph.add_node(
            "avgpool2d", name, [x],
            attrs={"pool_size": tuple(pool_size),
                   "strides": tuple(strides or pool_size), "padding": padding})

    def global_avg_pool(self, x: str) -> str:
        return self.graph.add_node("global_avg_pool", self._name("gap"), [x])

    def upsample(self, x: str, factor: int = 2) -> str:
        return self.graph.add_node("upsample2d", self._name("up"), [x],
                                   attrs={"factor": factor})

    def zero_pad(self, x: str, padding=((1, 1), (1, 1))) -> str:
        return self.graph.add_node("zero_pad2d", self._name("pad"), [x],
                                   attrs={"padding": tuple(map(tuple, padding))})

    def add(self, a: str, b: str) -> str:
        return self.graph.add_node("add", self._name("add"), [a, b])

    def concat(self, xs: Sequence[str], axis: int = -1) -> str:
        rank = len(self.graph.spec(xs[0]).shape)
        axis = axis % rank
        return self.graph.add_node("concat", self._name("concat"), list(xs),
                                   attrs={"axis": axis})

    def flatten(self, x: str) -> str:
        return self.graph.add_node("flatten", self._name("flatten"), [x])

    def softmax(self, x: str, axis: int = -1) -> str:
        return self.graph.add_node("softmax", self._name("softmax"), [x],
                                   attrs={"axis": axis})

    def decode_attention(self, q: str, k_cache: str, v_cache: str,
                         lengths: Optional[str] = None,
                         scale: Optional[float] = None) -> str:
        """Single-token GQA decode attention over a KV cache.  ``q`` is
        (H, D); caches are (S, Hkv, D); optional ``lengths`` is a scalar
        int32 input of per-example valid context lengths."""
        ins = [q, k_cache, v_cache] + ([lengths] if lengths else [])
        attrs = {} if scale is None else {"scale": float(scale)}
        return self.graph.add_node("decode_attention", self._name("attn"),
                                   ins, attrs=attrs)

    def build(self, outputs) -> Graph:
        """Finalize the graph.  ``outputs`` is a sequence of tensor
        names, or a mapping of *public output name -> tensor name* for
        user-chosen multi-output signatures."""
        self.graph.set_outputs(
            dict(outputs) if isinstance(outputs, dict) else list(outputs))
        return self.graph

